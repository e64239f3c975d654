"""End to end: ``python -m dlrover_tpu_torch.run`` -> the port's master ->
its agent -> ``dlrover_tpu_torch/train.py`` workers, on the CPU of one
host — the counterpart of ``tests/test_e2e_elastic.py``.

- The happy path: two workers of one agent train to two ``TRAIN_DONE``
  lines; their per-step losses are the uninterrupted run.
- A worker SIGKILLed after a staged save: the agent logs the failure and
  the breakpoint save, a second rendezvous round forms, the new workers
  warm-restore from shm (``restored step`` ≥ the interval) and finish;
  every loss and gradient norm after the restore is bit-equal to the
  uninterrupted run's at the same step (the CPU is deterministic for the
  same world and batch).  The agent's saver received the workers' save
  events (it persisted and committed the final step) and no arena of the
  run is left in ``/dev/shm``.
- The agent-kill case (``TestMultiNode``): two agents against one master;
  one agent is SIGKILLed and a replacement agent joins for the same node;
  both nodes go through a new round and resume from the checkpoint.

Every process runs under a hard limit (``LIMIT_S``) and the whole process
tree is killed on any failure."""

import glob
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
#: Hard limit of each launched process tree, seconds.
LIMIT_S = 150.0
STEPS = 32
INTERVAL = 4
TRAIN = ["--model", "tiny", "--device", "cpu", "--batch_per_proc", "2",
         "--log_every", "1", "--ckpt_interval", str(INTERVAL)]
STEP_RE = re.compile(r"\[worker (\d)\] step (\d+) loss=(\S+) "
                     r"grad_norm=(\S+)$")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sock_dir():
    d = tempfile.mkdtemp(prefix="dlsock")
    yield d
    shutil.rmtree(d, ignore_errors=True)


class Proc:
    """One launched process (its own session) whose merged output a thread
    collects; ``on_line`` sees each line as it arrives."""

    def __init__(self, cmd, sock_dir, on_line=None, **env_extra):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_TPU_")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   DLROVER_TPU_SOCK_DIR=sock_dir, **env_extra)
        self.lines = []
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self._on_line = on_line
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()
        self.started = time.time()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))
            if self._on_line is not None:
                self._on_line(self, line.rstrip("\n"))

    @property
    def text(self) -> str:
        return "\n".join(self.lines)

    def wait(self, timeout: float = LIMIT_S) -> int:
        rc = self.proc.wait(timeout=max(1.0, self.started + timeout
                                        - time.time()))
        self._reader.join(timeout=10)
        return rc

    def worker_pids(self):
        return [int(p) for m in re.finditer(r"pids=\[([\d, ]+)\]",
                                            self.text)
                for p in m.group(1).split(",")]

    def kill_tree(self):
        """SIGKILL this process's session and every worker it started."""
        for pid in self.worker_pids():
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()


def _launcher(job, *flags, script=()):
    return [sys.executable, "-m", "dlrover_tpu_torch.run",
            f"--job_name={job}", "--monitor_interval=0.5", *flags,
            str(REPO / "dlrover_tpu_torch" / "train.py"), "--", *script]


def _wait_for(pred, procs, what, timeout=LIMIT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        for p in procs:
            if p.proc.poll() is not None and not pred():
                pytest.fail(f"a process exited ({p.proc.returncode}) "
                            f"before {what}:\n" + p.text[-4000:])
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def _steps(text: str, rank: int = 0) -> dict:
    """``{step: (loss, grad_norm)}`` of a worker's lines (the last wins)."""
    out = {}
    for ln in text.splitlines():
        m = STEP_RE.match(ln)
        if m and int(m[1]) == rank:
            out[int(m[2])] = (m[3], m[4])
    return out


def _unlink_arenas(job):
    for path in glob.glob(f"/dev/shm/dlrtpu_{job}-*"):
        os.unlink(path)


@pytest.fixture(scope="module")
def uninterrupted(sock_dir, tmp_path_factory):
    """The happy path: one agent, two workers, STEPS steps to the end."""
    d = tmp_path_factory.mktemp("ck_straight")
    job = f"e2e-happy-{os.getpid()}"
    p = Proc(_launcher(job, "--standalone", "--nproc_per_node=2",
                       script=TRAIN + ["--steps", str(STEPS),
                                       "--ckpt_dir", str(d)]),
             sock_dir, DLROVER_TPU_RUN_ID=f"h{os.getpid()}")
    try:
        rc = p.wait()
    finally:
        if p.proc.poll() is None:
            p.kill_tree()
        _unlink_arenas(job)
    return rc, p.text


def test_happy_path(uninterrupted):
    rc, text = uninterrupted
    assert rc == 0, text[-4000:]
    done = [ln for ln in text.splitlines() if ln.startswith("TRAIN_DONE")]
    assert len(done) == 2, text[-4000:]
    assert all(ln.startswith(f"TRAIN_DONE step={STEPS} ") and
               "dp=2 backend=gloo" in ln for ln in done)
    assert "torch.distributed up: process 0/2 (gloo)" in text
    assert "rendezvous round 0: world=1 nodes" in text
    assert "master stopped: rpc_calls=" in text
    assert sorted(_steps(text)) == list(range(1, STEPS + 1))


def test_kill_worker_restore(uninterrupted, sock_dir, tmp_path):
    d = tmp_path / "ck"
    job = f"e2e-kill-{os.getpid()}"
    run_id = f"k{os.getpid()}"
    killed = {}

    def kill_after_a_staged_save(proc, line):
        if killed or not line.startswith("[worker 1] step "):
            return
        saved = re.findall(r"\[worker 1\] saved step=(\d+) to memory",
                           proc.text)
        if saved and int(line.split()[3]) > int(saved[-1]) + 1:
            pid = proc.worker_pids()[1]
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:  # it finished first: fails below
                return
            killed.update(pid=pid, staged=int(saved[-1]))

    p = Proc(_launcher(job, "--standalone", "--nproc_per_node=2",
                       script=TRAIN + ["--steps", str(STEPS),
                                       "--ckpt_dir", str(d)]),
             sock_dir, on_line=kill_after_a_staged_save,
             DLROVER_TPU_RUN_ID=run_id)
    try:
        rc = p.wait()
    finally:
        if p.proc.poll() is None:
            p.kill_tree()
    text = p.text
    assert rc == 0, text[-4000:]
    assert killed, "the worker finished before the kill:\n" + text[-3000:]
    assert f"worker failure(s): [(1, -{signal.SIGKILL})]" in text
    assert "breakpoint save (worker failure; re-rendezvous): persisting " \
           f"rank 1 step {killed['staged']}" in text, text[-4000:]
    assert "rendezvous round 1: world=1 nodes" in text
    restored = [int(x) for x in re.findall(r"\[worker \d\] restored step="
                                           r"(\d+)", text)]
    assert restored == [killed["staged"]] * 2 and restored[0] >= INTERVAL
    assert text.count("flash ckpt: warm restore from shm") == 2
    # Every step after the restore equals the uninterrupted run's, bit for
    # bit, on both ranks.
    after = text[text.index("restored step="):]
    _, straight = uninterrupted
    for rank in (0, 1):
        got = _steps(after, rank)
        assert sorted(got) == list(range(killed["staged"] + 1, STEPS + 1))
        want = _steps(straight, rank)
        assert {s: want[s] for s in got} == got
    # The agent's saver got the workers' save events: it persisted both
    # ranks' final step and committed it.
    for rank in (0, 1):
        assert f"saver: persisted rank {rank} step {STEPS} in" in text
    assert f"checkpoint step {STEPS} committed" in text
    assert text.count('"agent_mode": true') == 2
    assert not glob.glob(f"/dev/shm/dlrtpu_{job}-{run_id}_*")


class TestMultiNode:
    def test_agent_kill_node_relaunch(self, sock_dir, tmp_path):
        """SIGKILL a whole node's agent: a replacement agent for the same
        node joins, the master evicts the dead incarnation, the surviving
        node re-forms the world with it, and both resume from the
        checkpoint (the survivor's breakpoint save: a full shard)."""
        from dlrover_tpu_torch.common.rpc import find_free_port

        job = f"e2e-agentkill-{os.getpid()}"
        port = find_free_port()
        d = tmp_path / "ck"
        script = TRAIN + ["--steps", "100000", "--ckpt_dir", str(d)]
        procs = []
        try:
            master = Proc([sys.executable, "-m",
                           "dlrover_tpu_torch.master.main", f"--port={port}",
                           f"--job_name={job}", "--min_nodes=2",
                           "--max_nodes=2"], sock_dir)
            procs.append(master)

            def node(rank):
                p = Proc(_launcher(job, "--nnodes=2", "--nproc_per_node=1",
                                   f"--node_rank={rank}",
                                   f"--master_addr=127.0.0.1:{port}",
                                   script=script), sock_dir)
                procs.append(p)
                return p

            n0, n1 = node(0), node(1)
            _wait_for(lambda: re.search(
                rf"\[worker 1\] saved step={2 * INTERVAL} to memory",
                n1.text), procs, "a staged save on both nodes")
            n1.proc.kill()  # the agent dies; its worker is orphaned
            n1.proc.wait()
            n1b = node(1)
            _wait_for(lambda: re.search(r"restored step=(\d+)", n1b.text)
                      and re.search(r"\[worker 1\] step \d+ loss", n1b.text),
                      [master, n0, n1b], "the replacement's restore")
            step = int(re.search(r"restored step=(\d+)", n1b.text)[1])
            assert step >= INTERVAL
            assert "rendezvous round 1: world=2 nodes" in n0.text
            assert "breakpoint save (membership_changed)" in n0.text
            _wait_for(lambda: "restored step=" in n0.text, [master, n0],
                      "the survivor's restore")
            assert int(re.search(r"restored step=(\d+)", n0.text)[1]) \
                == step
            assert "node 1 re-joined; evicted from round 0" in master.text
        finally:
            for p in procs:
                if p.proc.poll() is None or p.worker_pids():
                    p.kill_tree()
            _unlink_arenas(job)
