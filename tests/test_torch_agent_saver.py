"""The port's agent-side saver (``dlrover_tpu_torch/agent/ckpt_saver.py``
``AsyncCheckpointSaver``), mirroring ``tests/test_checkpoint.py::
TestAgentSaver``: the engine finds the saver's queue and runs in agent
mode; a storage save is persisted and committed by the saver; a
memory-only save is persisted by the breakpoint save; and a trainer
process SIGKILLed after staging loses nothing.  The shards the saver
writes are the reference's format: the reference's reader restores them
bit for bit."""

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dlrover_tpu.checkpoint import shard_file as R
from dlrover_tpu.common.storage import PosixDiskStorage as RStorage
from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint import fsck, shard_file
from dlrover_tpu_torch.checkpoint.checkpointer import FlashCheckpointer
from dlrover_tpu_torch.common import multi_process as port_mp
from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
from dlrover_tpu_torch.common.storage import PosixDiskStorage

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _sock_dir():
    """The agent's unix sockets in a directory of this module's own, for
    this process and the children it starts."""
    d = tempfile.mkdtemp(prefix="dlsock")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLROVER_TPU_SOCK_DIR", d)
        mp.setattr(port_mp, "_SOCK_DIR", d)
        yield d
    shutil.rmtree(d, ignore_errors=True)


@pytest.fixture
def saver(monkeypatch):
    for var in ("DLROVER_TPU_RUN_ID", "DLROVER_TPU_NUM_PROCESSES",
                "DLROVER_TPU_PROCESS_ID", "DLROVER_TPU_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    job = f"tagent-{os.getpid()}-{time.monotonic_ns()}"
    s = AsyncCheckpointSaver(job, nproc_per_node=1)
    s.start()
    yield s
    s.stop()
    unlink_arena(arena_name(job, 0))


def _state(v: float) -> dict:
    return {"params": {"w": torch.full((64, 300), v),
                       "b": torch.arange(5, dtype=torch.int32)}, "step": 3}


def _latest(d: str):
    return shard_file.latest_step(PosixDiskStorage(), d)


def test_event_persist_and_breakpoint_save(saver, tmp_path):
    d = str(tmp_path)
    ckpt = FlashCheckpointer(d, job_name=saver.job_name)
    try:
        assert ckpt.agent_mode and ckpt.engine.agent_mode
        ckpt.save(_state(1.5), meta={"step": 4}, storage=True)
        assert ckpt.wait(timeout=60)
        assert _latest(d) == 4
        # The engine's stall and staging rate reach the saver's stat dict.
        assert saver.last_stall_ms() > 0 and saver.staged_mbps() > 0
        saver._perf_cache = (0.0, {})
        assert saver.agg_persist_mbps() > 0
        # Step 8 in shm only; the breakpoint save persists and commits it.
        ckpt.save(_state(2.5), meta={"step": 8})
        saver.save_shm_to_storage("test-breakpoint")
        assert _latest(d) == 8
        tensors, extra = R.read_shard(RStorage(), d, 8, 0)
        assert extra["meta"]["step"] == 8
        assert np.array_equal(tensors["['params']['w']|0"],
                              np.full((64, 300), 2.5, np.float32))
        assert not fsck.fsck(d).damaged
        # Nothing newer staged: a second breakpoint save writes nothing.
        before = sorted(os.listdir(d))
        saver.save_shm_to_storage("again")
        assert sorted(os.listdir(d)) == before
    finally:
        ckpt.close()


def test_unchanged_tensors_are_refs_in_agent_mode(saver, tmp_path):
    d = str(tmp_path)
    ckpt = FlashCheckpointer(d, job_name=saver.job_name, max_to_keep=0)
    try:
        ckpt.save(_state(1.0), meta={"step": 1}, storage=True)
        assert ckpt.wait(timeout=60)
        st = _state(1.0)
        st["params"]["w"] += 1.0
        ckpt.save(st, meta={"step": 2}, storage=True)
        assert ckpt.wait(timeout=60)
        man = shard_file.read_shard_manifest(PosixDiskStorage(), d, 2, 0)
        assert man.extra["ref_steps"] == [1]
        refs = [k for k, tm in man.tensors.items() if "ref" in tm]
        assert "['params']['b']|0" in refs
        assert "['params']['w']|0" not in refs
        # A standalone engine (another job: no saver) reads it back.
        other = FlashCheckpointer(d, job_name=f"{saver.job_name}-other")
        assert not other.agent_mode
        restored, meta = other.load(_state(0.0))
        other.close()
        assert meta["step"] == 2
        assert torch.equal(restored["params"]["w"], st["params"]["w"])
    finally:
        ckpt.close()
        unlink_arena(arena_name(f"{saver.job_name}-other", 0))


_TRAINER = """
import sys
from dlrover_tpu_torch.checkpoint.checkpointer import FlashCheckpointer
import torch
ckpt = FlashCheckpointer(sys.argv[1], job_name=sys.argv[2])
assert ckpt.agent_mode
state = {"params": {"w": torch.full((64, 300), 7.0)}, "step": 5}
ckpt.save(state, meta={"step": 5})
print("staged", flush=True)
import time
time.sleep(600)
"""


def test_a_killed_trainer_loses_nothing(saver, tmp_path):
    """A trainer process stages step 5 into the arena and is SIGKILLed;
    the breakpoint save persists and commits what it staged."""
    d = str(tmp_path)
    child = subprocess.Popen(
        [sys.executable, "-c", _TRAINER, d, saver.job_name], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        assert child.stdout.readline().strip() == "staged"
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=30)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert _latest(d) is None
    saver.save_shm_to_storage("worker died")
    assert _latest(d) == 5
    tensors, _ = shard_file.read_shard(PosixDiskStorage(), d, 5, 0)
    assert torch.equal(tensors["['params']['w']|0"], torch.full((64, 300),
                                                                 7.0))


class _Client:
    """A master client that records the saver's calls."""

    def __init__(self):
        self.calls = []

    def sync_checkpoint(self, step):
        self.calls.append(("sync_checkpoint", step))
        return True

    def report_ckpt_perf(self, **kw):
        self.calls.append(("report_ckpt_perf", kw["step"], kw["stall_ms"]))


def test_replicas_and_a_master_client_are_refused(saver, tmp_path,
                                                  monkeypatch):
    """The replicas are still refused; a master client is now taken (the
    elastic loop): each persist is reported as a throughput-only
    ``CkptPerf`` and the commit waits on the master's step barrier."""
    with pytest.raises(NotImplementedError, match="item 5"):
        saver.seed_from_replicas({0: 0}, 1)
    with pytest.raises(NotImplementedError, match="item 5"):
        saver._replica_loop()
    assert saver.update_world(1, 2) is None
    job = f"{saver.job_name}-client"
    client = _Client()
    with_client = AsyncCheckpointSaver(job, 1, master_client=client)
    with_client.start()
    d = str(tmp_path)
    ckpt = FlashCheckpointer(d, job_name=job)
    try:
        ckpt.save(_state(4.0), meta={"step": 2}, storage=True)
        assert ckpt.wait(timeout=60)
        assert _latest(d) == 2
        assert ("sync_checkpoint", 2) in client.calls
        assert ("report_ckpt_perf", 2, 0.0) in client.calls
    finally:
        ckpt.close()
        with_client.stop()
        unlink_arena(arena_name(job, 0))
