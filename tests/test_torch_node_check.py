"""The pre-flight node check in the port (``dlrover_tpu_torch/agent/
node_check.py``, ``--network_check`` in ``run.py``, the network-check
rendezvous and the servicer's answers):

- the master's fault and straggler verdicts, the completeness and the
  next round's pairing equal the reference manager's
  (``dlrover_tpu/master/rendezvous.py``) for the same reported times;
- end to end on the CPU, as ``tests/test_e2e_elastic.py:250``: one master
  and two agents with ``--network_check --comm_perf_test``, node 1 delayed
  by ``DLROVER_TPU_CHECK_DELAY_S`` inside the timed region; node 1 (only)
  is flagged as the straggler and both nodes train; a single node whose
  payload fails is faulty and its launcher exits 3.  There the payload,
  on the CPU, printed ``NODE_CHECK_RESULT`` (the agent read it); without
  its device (no card here) it failed, never dropping to the CPU.

The two process trees start together in one module fixture; every child
runs with ``OMP_NUM_THREADS=1``."""

import os
import random
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch

from dlrover_tpu.master import rendezvous as rrdzv
from dlrover_tpu_torch.master import rendezvous as trdzv

REPO = Path(__file__).resolve().parents[1]
LIMIT_S = 150.0
TRAIN = [str(REPO / "dlrover_tpu_torch" / "train.py"), "--", "--model",
         "tiny", "--device", "cpu", "--steps", "4", "--batch_per_proc", "2",
         "--log_every", "1"]


def _managers(n):
    port, ref = trdzv.NetworkCheckRendezvousManager(), \
        rrdzv.NetworkCheckRendezvousManager()
    for mgr in (port, ref):
        mgr.update_rdzv_params(n, n)
        for nid in range(n):
            mgr.join(nid, nid, 1, host="127.0.0.1",
                     coordinator_port=7000 + nid, attempt_id=f"a{nid}")
    return port, ref


def _verdict(mgr):
    return (mgr.check_fault_node(), mgr.get_stragglers(),
            mgr.results_complete(), mgr.network_ready())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_verdicts_and_pairing_equal_the_references(seed):
    rng = random.Random(seed)
    n = rng.choice([2, 3, 4, 5])
    port, ref = _managers(n)
    assert _verdict(port) == _verdict(ref)
    for nid in range(n):
        assert port.get_comm_world(nid) == ref.get_comm_world(nid)
    for r in range(2):
        for nid in rng.sample(range(n), n):
            ok = rng.random() < 0.8
            t = rng.choice([1.0, 1.1, 1.05, 2.5, 4.0]) if ok else 0.0
            port.report_result(nid, ok, t, r)
            ref.report_result(nid, ok, t, r)
            assert _verdict(port) == _verdict(ref), (r, nid)
        if r == 0:
            # The next round pairs fastest with slowest.
            assert port.next_check_round() == ref.next_check_round()
            for mgr in (port, ref):
                for nid in range(n):
                    mgr.join(nid, nid, 1, host="127.0.0.1",
                             coordinator_port=7100 + nid,
                             attempt_id=f"b{nid}")
            for nid in range(n):
                assert port.get_comm_world(nid) == ref.get_comm_world(nid)


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


class _Proc:
    """A process in a session of its own; a thread collects its merged
    output."""

    def __init__(self, cmd, sock_dir, **env_extra):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("DLROVER_TPU_")}
        env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   DLROVER_TPU_SOCK_DIR=sock_dir, **env_extra)
        self.lines = []
        self.proc = subprocess.Popen(
            cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self._reader = threading.Thread(target=self._pump, daemon=True)
        self._reader.start()
        self.started = time.time()

    def _pump(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip("\n"))

    @property
    def text(self) -> str:
        return "\n".join(self.lines)

    def wait(self) -> int:
        try:
            rc = self.proc.wait(timeout=max(
                1.0, self.started + LIMIT_S - time.time()))
        except subprocess.TimeoutExpired:
            return -999
        self._reader.join(timeout=10)
        return rc

    def kill_tree(self):
        for pid in re.findall(r"pids=\[(\d+)\]", self.text):
            try:
                os.killpg(int(pid), 9)
            except (ProcessLookupError, PermissionError):
                pass
        try:
            os.killpg(self.proc.pid, 9)
        except (ProcessLookupError, PermissionError):
            pass
        self.proc.wait()


@pytest.fixture(scope="module")
def runs():
    """Both process trees at once: the two-node job with the delayed node
    1, and the single node whose payload cannot reach its device."""
    sock = tempfile.mkdtemp(prefix="dlsock")
    port = _free_port()
    job = f"netcheck{os.getpid()}"
    master = _Proc([sys.executable, "-m", "dlrover_tpu_torch.master.main",
                    f"--port={port}", f"--job_name={job}", "--min_nodes=2",
                    "--max_nodes=2", "--network_check"], sock)
    nodes = [
        _Proc([sys.executable, "-m", "dlrover_tpu_torch.run",
               f"--job_name={job}", "--monitor_interval=0.5",
               "--nnodes=2", "--nproc_per_node=1", f"--node_rank={r}",
               f"--master_addr=127.0.0.1:{port}", "--network_check",
               "--comm_perf_test", *TRAIN], sock,
              DLROVER_TPU_CHECK_DEVICE="cpu",
              **({"DLROVER_TPU_CHECK_DELAY_S": "2"} if r == 1 else {}))
        for r in (0, 1)]
    # A host with a card is made to fail by a device the payload refuses.
    faulty = _Proc([sys.executable, "-m", "dlrover_tpu_torch.run",
                    f"--job_name={job}-faulty", "--standalone",
                    "--nproc_per_node=1", "--network_check", *TRAIN], sock,
                   DLROVER_TPU_CHECK_DEVICE=(
                       "meta" if torch.cuda.is_available() else ""))
    procs = [master, *nodes, faulty]
    try:
        yield {"rcs": [p.wait() for p in procs], "master": master,
               "nodes": nodes, "faulty": faulty}
    finally:
        for p in procs:
            if p.proc.poll() is None:
                p.kill_tree()
        shutil.rmtree(sock, ignore_errors=True)


def test_two_nodes_flag_the_delayed_straggler_and_train(runs):
    c0, c1 = (n.text for n in runs["nodes"])
    assert runs["rcs"][:3] == [0, 0, 0], (c0[-3000:], c1[-3000:])
    for text in (c0, c1):
        assert "node check round 1: ok=True" in text
        assert "stragglers=[1] complete=True" in text
        assert re.search(r'"backend": "gloo".*"allreduce_ok": true', text)
        assert len(re.findall(r"comm perf: bytes=", text)) == 3
        assert "TRAIN_DONE" in text and "dp=2" in text
    assert "flagged as straggler" in c1
    assert "flagged as straggler" not in c0


def test_a_failing_payload_makes_the_launcher_exit_3(runs):
    text = runs["faulty"].text
    assert runs["rcs"][3] == 3, text[-3000:]
    assert "node check round 1: ok=False" in text
    assert "faults=[0] (checked)" in text
    assert "node health check failed" in text
    assert "started 1 worker" not in text and "TRAIN_DONE" not in text


def test_payload_on_the_cpu_prints_its_result(runs):
    """Each round's payload printed ``NODE_CHECK_RESULT`` (the agent's
    elapsed time) and its exact matmul on the CPU."""
    for node in runs["nodes"]:
        for r in (0, 1):
            assert re.search(rf"node check round {r}: ok=True "
                             rf"elapsed=\d", node.text)
        assert node.text.count('"device": "cpu", "n": 512, "reps": 8') == 2
        assert '"max_rel_err": 0.0' in node.text


def test_payload_without_its_device_fails(runs):
    """The payload that cannot reach its device fails; it does not run on
    the CPU instead."""
    text = runs["faulty"].text
    assert text.count("node check payload failed rc=1") == 2
    assert "node check payload: {" not in text
