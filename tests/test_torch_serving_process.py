"""The serving fleet and elastic serving across real processes, on the CPU.

1. ``python -m dlrover_tpu_torch.serve_fleet`` with one process per role:
a gateway (lease 1 s), two speculative replicas with journals, a ceiling
draft replica and the driver (12 requests at 20 per second).  Once replica
r0 has journaled a completion and a request streams on it, it is SIGKILLed
by its pid and started again with the same id and journal.  The driver still sees 12 of 12 done; the
gateway re-dispatched r0's lost work, dropped the restarted r0's journal
replays as duplicates, folded the replicas' speculative rounds, and never
imported torch.
2. ``python -m dlrover_tpu_torch.run --standalone`` runs
``dlrover_tpu_torch/serve_elastic.py``; after its fourth completion the
worker is SIGKILLed by the pid the agent logged; the restarted worker
answers the journaled requests from the journal, serves the rest, and the
journal ends with every request once.

Every child runs with ``OMP_NUM_THREADS=1`` in a session of its own, is
signalled by its pid and reaped in a ``finally``; every wait polls a
condition under a deadline.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

from dlrover_tpu_torch.common.messages import ServeStatusRequest
from dlrover_tpu_torch.common.rpc import RpcClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 30.0


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


def _read(path) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("DLROVER_TPU_")}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               DLROVER_TPU_SOCK_DIR=str(tmp_path / "sock"),
               DLROVER_TPU_RUN_ID=f"sv{os.getpid()}")
    return env


def test_fleet_processes_survive_a_sigkilled_replica(tmp_path):
    env = _env(tmp_path)
    journal = tmp_path / "journal"
    fleet = [sys.executable, "-m", "dlrover_tpu_torch.serve_fleet"]
    procs = {}

    def spawn(name, *argv):
        with open(tmp_path / f"{name}.log", "w") as log:
            procs[name] = subprocess.Popen(
                fleet + list(argv), cwd=REPO, env=env, stdout=log,
                stderr=subprocess.STDOUT, start_new_session=True)
        assert os.getpgid(procs[name].pid) != os.getpgrp()
        return procs[name]

    def log(name):
        return _read(tmp_path / f"{name}.log")

    try:
        spawn("gateway", "--role", "gateway", "--lease_timeout", "1")
        port = _wait_for(lambda: re.search(r"GATEWAY_READY port=(\d+)",
                                           log("gateway")), "the gateway")[1]
        gw = f"127.0.0.1:{port}"
        replica = ["--role", "replica", "--gateway", gw, "--spec",
                   "--journal_dir", str(journal), "--device", "cpu"]
        # Rounds of at least 0.2 s: three waves of requests, so that a
        # replica that has finished its first one still holds work.
        replica += ["--round_floor_ms", "200"]
        r0 = replica + ["--replica_id", "r0"]
        spawn("r0", *r0)
        spawn("r1", *replica, "--replica_id", "r1")
        spawn("d0", "--role", "draft", "--gateway", gw, "--replica_id",
              "d0", "--draft_seed", "-1", "--device", "cpu")
        for name, line in (("r0", "REPLICA_READY"), ("r1", "REPLICA_READY"),
                           ("d0", "DRAFT_READY")):
            _wait_for(lambda n=name, ln=line: ln in log(n), f"{name} ready")
        driver = spawn("driver", "--role", "driver", "--gateway", gw,
                       "--requests", "12", "--rps", "20",
                       "--max_new_tokens", "32")
        r0_journal = journal / "r0.jsonl"
        _wait_for(lambda: _read(r0_journal).count("\n") >= 1,
                  "r0's first journaled completion")
        client = RpcClient(gw, timeout=5.0)

        def streaming_on_r0():
            """A request r0 is decoding, with tokens still to come."""
            for i in range(12):
                st = client.call(ServeStatusRequest(req_id=f"req-{i}"))
                if st.state == "running" and st.replica == "r0" and \
                        0 < len(st.tokens) < 32 - 6:
                    return True
            return False

        try:
            _wait_for(streaming_on_r0, "a request streaming on r0")
        finally:
            client.close()
        os.kill(procs["r0"].pid, signal.SIGKILL)
        assert procs["r0"].wait(timeout=DEADLINE_S) == -signal.SIGKILL
        first = log("r0")
        spawn("r0", *r0)
        assert driver.wait(timeout=60) == 0, log("driver")[-3000:]
        out = log("driver")
        assert "FLEET_DONE requests=12 completed=12" in out, out[-3000:]
        assert len(re.findall(r"RESULT req-\d+ state=done", out)) == 12
        _wait_for(lambda: "REPLICA_READY" in log("r0"), "r0 restarted")
        procs["gateway"].send_signal(signal.SIGTERM)
        assert procs["gateway"].wait(timeout=DEADLINE_S) == 0
        done = json.loads(re.search(r"GATEWAY_DONE (.*)",
                                    log("gateway"))[1])
        c = done["counters"]
        assert c["completed"] == 12 and c["redispatched"] >= 1, c
        assert c["duplicate_completions"] >= 1, c
        assert c["spec_rounds"] > 0 and c["spec_accepted"] > 0, c
        assert done["torch_imported"] is False
        assert "REPLICA_READY id=r0" in first
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=DEADLINE_S)


def test_serve_elastic_worker_replays_after_sigkill(tmp_path):
    env = _env(tmp_path)
    journal = tmp_path / "sj"
    cmd = [sys.executable, "-m", "dlrover_tpu_torch.run", "--standalone",
           "--nproc_per_node=1", "--monitor_interval=0.5",
           "--job_name=serve-elastic",
           os.path.join(REPO, "dlrover_tpu_torch", "serve_elastic.py"),
           "--", "--journal_dir", str(journal), "--device", "cpu",
           "--max_new_tokens", "16", "--throttle_s", "0.1"]
    logf = tmp_path / "launcher.log"
    with open(logf, "w") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    assert os.getpgid(proc.pid) != os.getpgrp()
    try:
        pid = int(_wait_for(lambda: re.search(
            r"pids=\[(\d+)\]", _read(logf)), "the worker's pid")[1])
        _wait_for(lambda: _read(logf).count("SERVED rid") >= 4,
                  "four completions")
        os.kill(pid, signal.SIGKILL)
        assert proc.wait(timeout=90) == 0, _read(logf)[-3000:]
        text = _read(logf)
        assert "worker failure(s): [(0, -9)]" in text
        m = re.search(r"SERVE_ELASTIC_DONE requests=12 served_now=(\d+) "
                      r"from_journal=(\d+)", text)
        assert m and int(m[2]) >= 4 and int(m[1]) + int(m[2]) == 12, text
        recs = [json.loads(x) for x in
                (journal / "results.jsonl").read_text().splitlines()]
        assert sorted(r["rid"] for r in recs) == list(range(12))
    finally:
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=DEADLINE_S)
