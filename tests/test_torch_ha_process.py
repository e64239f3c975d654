"""Master HA across real processes.

1. ``python -m
dlrover_tpu_torch.master.main --state_dir D`` as the primary and ``...
--standby --state_dir D`` as its warm standby, each in a session of its
own.  A ``MasterClient`` that knows ``D`` sets KV keys and takes a task;
the primary is SIGKILLed by its pid; the standby takes over and the same
client, failing over through ``D``'s ``addr`` file, finds the keys and the
task queue as they were.  The standby then ends the job on request and
``statecheck`` finds ``D`` clean.
2. ``python -m dlrover_tpu_torch.run --standalone --standby
--master_state_dir D`` runs a tiny CPU job; once the worker logged step 2
the primary master is SIGKILLed by the pid the launcher logged.  The
standby takes over, the launcher promotes it and starts a fresh standby,
the worker is not restarted, the job ends with ``TRAIN_DONE`` and exit 0,
every master has exited, and ``D`` is clean.

The children lease faster than the defaults (``DLROVER_TPU_HA_LEASE_S=1``,
a bump every 0.2 s, the tail polled every 0.05 s), run with
``OMP_NUM_THREADS=1``, and are killed by pid and reaped in a ``finally``.
Every wait polls a condition under a deadline.
"""

import os
import re
import signal
import subprocess
import sys
import threading
import time

import pytest
import torch

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.master.state import read_addr
from dlrover_tpu_torch.master.statecheck import check_state_dir

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 30.0
#: The masters' lease, a bump every 0.2 s, the standby's poll (seconds).
HA_ENV = dict(DLROVER_TPU_HA_LEASE_S="1.0",
              DLROVER_TPU_HA_LEASE_INTERVAL_S="0.2",
              DLROVER_TPU_HA_TAIL_POLL_S="0.05")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wait_for(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"gave up after {timeout:.0f} s waiting "
                                 f"for {what}")
        time.sleep(0.05)


def _port_of(path: str) -> int:
    def read():
        try:
            with open(path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0
    return _wait_for(read, f"the port in {path}")


def test_standby_process_takes_over_a_sigkilled_primary(tmp_path):
    state_dir = tmp_path / "state"
    env = dict(os.environ, OMP_NUM_THREADS="1", **HA_ENV)
    base = [sys.executable, "-m", "dlrover_tpu_torch.master.main",
            "--port", "0", "--job_name", "ha-proc",
            "--state_dir", str(state_dir)]
    procs = []
    client = None

    def spawn(extra, name):
        log = open(tmp_path / f"{name}.log", "w")
        try:
            procs.append(subprocess.Popen(
                base + extra + ["--port_file", str(tmp_path / name)],
                cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
                start_new_session=True))
        finally:
            log.close()
        return procs[-1]

    try:
        primary = spawn([], "primary")
        primary_addr = f"127.0.0.1:{_port_of(str(tmp_path / 'primary'))}"
        standby = spawn(["--standby", "--primary_addr", primary_addr],
                        "standby")
        standby_addr = f"127.0.0.1:{_port_of(str(tmp_path / 'standby'))}"
        for proc in procs:
            assert os.getpgid(proc.pid) != os.getpgrp()
        assert read_addr(str(state_dir)) == primary_addr

        client = MasterClient(primary_addr, 0, state_dir=str(state_dir))
        client.kv_store_set("boot/k", b"v")
        assert client.kv_store_add("ctr", 5) == 5
        client.report_dataset_shard_params(dataset_name="ds",
                                           dataset_size=40, shard_size=10)
        held = client.get_task("ds")
        assert held.task_id == 0

        os.kill(primary.pid, signal.SIGKILL)
        assert primary.wait(timeout=DEADLINE_S) == -signal.SIGKILL
        _wait_for(lambda: read_addr(str(state_dir)) == standby_addr,
                  "the standby's address in the state dir")
        # The same client fails over and finds everything acked before.
        assert client.kv_store_get("boot/k") == b"v"
        assert client.master_addr == standby_addr
        assert client.kv_store_get("ctr") == b"5"
        client.report_task_result("ds", held.task_id, True)
        assert [client.get_task("ds").task_id for _ in range(4)] == \
            [1, 2, 3, -1]

        client.report_job_exit(True, "test done")
        assert standby.wait(timeout=DEADLINE_S) == 0
        report = check_state_dir(str(state_dir))
        assert report["clean"], report["damage"]
        assert report["kinds"]["ha.takeover"] == 1
        assert report["kinds"]["ha.shutdown"] == 1
        assert report["generations"] == [1, 2]
        log = (tmp_path / "standby.log").read_text()
        assert "standby TOOK OVER as generation 2" in log
        assert "answered its first request" in log
    finally:
        if client is not None:
            client.close()
        for proc in procs:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=DEADLINE_S)


#: The launcher test's worker: it reports a step every 0.1 s through the
#: master client the agent's env contract gives it, until the test creates
#: the file ``argv[1]``; then it sets a key on the (promoted) master.
WORKER = r"""
import os, sys, time
from dlrover_tpu_torch.agent.master_client import build_master_client
client = build_master_client()
step = 0
while not os.path.exists(sys.argv[1]):
    step += 1
    client.report_global_step(step)
    print(f"[worker] step {step}", flush=True)
    time.sleep(0.1)
client.kv_store_set("worker/last_step", str(step).encode())
print(f"[worker] done at step {step}", flush=True)
"""


def test_launcher_promotes_the_standby_and_the_job_finishes(tmp_path):
    state_dir, go = tmp_path / "ha", tmp_path / "go"
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               DLROVER_TPU_SOCK_DIR=str(tmp_path / "sock"),
               DLROVER_TPU_RUN_ID=f"ha{os.getpid()}", **HA_ENV)
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
           "--standby", "--master_state_dir", str(state_dir),
           "--nproc_per_node=1", "--monitor_interval=0.5",
           "--job_name=ha-launch", str(script), "--", str(go)]
    lines, state = [], {}
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)

    def pump():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            m = re.search(r"(local|standby) master pid=(\d+)", line)
            if m:
                state.setdefault(m[1], []).append(int(m[2]))
            if line.startswith("[worker] step 2") and "killed" not in state:
                os.kill(state["local"][0], signal.SIGKILL)
                state["killed"] = True
            if len(state.get("standby", ())) == 2:
                go.touch()  # a fresh standby backs the promoted master

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        rc = proc.wait(timeout=90)
        reader.join(timeout=DEADLINE_S)
        text = "\n".join(lines)
        assert rc == 0 and "killed" in state, text[-4000:]
        assert "standby TOOK OVER as generation 2" in text
        assert re.search(rf"primary master \(pid {state['local'][0]}\) "
                         rf"exited rc=-9; standby \(pid "
                         rf"{state['standby'][0]}\) took over", text)
        assert len(re.findall(r"started 1 worker\(s\)", text)) == 1
        assert "[worker] done at step" in text
        report = check_state_dir(str(state_dir))
        assert report["clean"], report["damage"]
        assert report["kinds"]["ha.takeover"] == 1
        assert report["kinds"]["ha.shutdown"] == 1
        assert report["generations"] == [1, 2]
        # The worker's key went through the promoted master's journal.
        assert report["kinds"]["kv.set"] == 1
        for pid in state["local"] + state["standby"]:
            _wait_for(lambda: not _alive(pid), f"master {pid} to exit")
    finally:
        if proc.poll() is None:
            assert os.getpgid(proc.pid) != os.getpgrp()
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=DEADLINE_S)
        reader.join(timeout=DEADLINE_S)
        for pid in state.get("local", []) + state.get("standby", []):
            if _alive(pid):  # every master runs in a session of its own
                os.kill(pid, signal.SIGKILL)
        text = "\n".join(lines)
        for pid in re.findall(r"pids=\[(\d+)\]", text):
            try:
                os.killpg(int(pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass


def _alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie, exited but not reaped, does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False
