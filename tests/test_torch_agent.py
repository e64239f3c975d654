"""The unit parts of the port's agent (``dlrover_tpu_torch/agent/
training.py``, ``diagnosis/agent.py``, ``agent/ckpt_saver.py``, ``run.py``)
against the reference's (``dlrover_tpu/agent/training.py``,
``dlrover_tpu/diagnosis/agent.py``, ``dlrover_tpu/run.py``):

- ``diagnose_training_failure`` returns the reference's action for the same
  worker logs, failures and restart counts;
- the environment each worker is started with, for a given round, equals
  the reference agent's (``worker_env`` plus the local keys, the
  ``PYTHONPATH`` contract);
- ``_stop_workers`` runs the breakpoint hook first, then SIGTERMs each
  worker's process group, SIGKILLs it after the grace period and reaps
  every worker;
- a breakpoint save skips a rank whose fencing lock a live process holds
  ("lock busy") without deadlocking, and persists it once the holder died;
- the agent re-joins a master restarted mid-rendezvous with the same
  attempt id and gets its world;
- the options the port does not have yet are refused by name."""

import os
import select
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

from dlrover_tpu.agent import training as RT
from dlrover_tpu.diagnosis.agent import DiagnosisAgent as RDiagnosis
from dlrover_tpu_torch import run as trun
from dlrover_tpu_torch.agent import ckpt_saver
from dlrover_tpu_torch.agent import training as T
from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
from dlrover_tpu_torch.checkpoint import shard_file
from dlrover_tpu_torch.checkpoint.checkpointer import FlashCheckpointer
from dlrover_tpu_torch.common import multi_process as port_mp
from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.diagnosis.agent import DiagnosisAgent
from dlrover_tpu_torch.master.master import LocalJobMaster

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _sock_dir():
    """The saver's unix sockets in a directory of this module's own."""
    d = tempfile.mkdtemp(prefix="dlsock")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLROVER_TPU_SOCK_DIR", d)
        mp.setattr(port_mp, "_SOCK_DIR", d)
        yield d
    shutil.rmtree(d, ignore_errors=True)


# -- diagnosis

DIAGNOSIS_CASES = [
    ("", [(0, 1)], 1),
    ("", [(0, 1)], 4),
    ("", [(0, -9)], 1),
    ("killed: Out of memory (oom-killer)", [(1, -9)], 1),
    ("killed: Out of memory", [(0, 1)], 1),
    ("RuntimeError: Hardware error on chip 3", [(0, 1)], 1),
    ("RESOURCE_EXHAUSTED: Out of memory while trying", [(0, 1)], 0),
    ("ici link down", [(0, 2), (1, -15)], 2),
    ("coordination service heartbeat timeout", [(0, 1)], 3),
    ("CUDA error: an illegal memory access was encountered", [(0, 1)], 1),
]


@pytest.mark.parametrize("log,failures,restarts", DIAGNOSIS_CASES)
def test_diagnosis_matches_the_reference(tmp_path, log, failures,
                                         restarts):
    if log:
        (tmp_path / "worker_r0_l0_round0.log").write_text(
            f"step 3\n{log}\nTraceback\n")
    got = DiagnosisAgent(None, log_dir=str(tmp_path),
                         max_in_place_restarts=3)
    want = RDiagnosis(None, log_dir=str(tmp_path), max_in_place_restarts=3)
    assert got.diagnose_training_failure(failures, restarts) == \
        want.diagnose_training_failure(failures, restarts)


def test_an_old_log_is_no_evidence(tmp_path):
    log = tmp_path / "worker_r0_l0_round0.log"
    log.write_text("hardware error\n")
    old = time.time() - 3600
    os.utime(log, (old, old))
    assert DiagnosisAgent(None, log_dir=str(tmp_path)) \
        .diagnose_training_failure([(0, 1)], 1) == "restart_worker"


# -- the workers' environment

WORLD_INFO = {
    "round": 3, "my_rank": 1, "coordinator": "127.0.0.1:29555",
    "num_processes": 5,
    "world": {0: {"node_id": 4, "local_world_size": 3,
                  "process_id_base": 0},
              1: {"node_id": 7, "local_world_size": 2,
                  "process_id_base": 3}},
}


class _FakePopen:
    envs = []

    def __init__(self, cmd, env=None, **kw):
        _FakePopen.envs.append((cmd, env, kw.get("start_new_session")))
        self.pid = 4242

    def poll(self):
        return 0


def _started_envs(module, agent, monkeypatch):
    _FakePopen.envs = []
    monkeypatch.setattr(module.subprocess, "Popen", _FakePopen)
    agent._restart_count = 2
    agent._start_workers(WORLD_INFO)
    agent._workers = []
    return list(_FakePopen.envs)


def test_worker_env_is_the_reference_agents(monkeypatch, tmp_path):
    for var in ("DLROVER_TPU_FAULTS", "DLROVER_TPU_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PYTHONPATH", "/some/where")
    monkeypatch.chdir(tmp_path)
    kw = dict(nproc_per_node=2, node_id=7, node_rank=1, job_name="envjob")
    entry = [sys.executable, "-u", "train.py", "--x"]
    port = T.ElasticTrainingAgent(T.ElasticLaunchConfig(**kw), entry,
                                  "127.0.0.1:1")
    ref = RT.ElasticTrainingAgent(RT.ElasticLaunchConfig(**kw), entry,
                                  "127.0.0.1:1")
    got = _started_envs(T, port, monkeypatch)
    want = _started_envs(RT, ref, monkeypatch)
    assert len(got) == 2 and got == want
    env = got[1][1]
    assert env["DLROVER_TPU_PROCESS_ID"] == "4"
    assert env["DLROVER_TPU_NUM_PROCESSES"] == "5"
    assert env["DLROVER_TPU_RESTART_COUNT"] == "2"
    assert env["PYTHONPATH"].split(os.pathsep) == [str(tmp_path),
                                                   str(REPO), "/some/where"]
    assert [e for _, _, e in got] == [True, True]


# -- stopping the workers

_STUBBORN = r"""
import os, signal, subprocess, sys, time
signal.signal(signal.SIGTERM, signal.SIG_IGN)
child = subprocess.Popen([sys.executable, "-c",
                          "import time; time.sleep(600)"])
open(f"{sys.argv[1]}.{os.getpid()}", "w").write(str(child.pid))
time.sleep(600)
"""


def _gone(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_stop_workers_kills_the_process_group_and_reaps(tmp_path):
    world = {"round": 0, "my_rank": 0, "coordinator": "", "num_processes": 2,
             "world": {0: {"node_id": 0, "local_world_size": 2,
                           "process_id_base": 0}}}
    cfg = T.ElasticLaunchConfig(nproc_per_node=2)
    agent = T.ElasticTrainingAgent(
        cfg, [sys.executable, "-c", _STUBBORN, str(tmp_path / "child")],
        "127.0.0.1:1")
    calls = []
    agent.on_workers_stopping = calls.append
    agent._start_workers(world)
    procs = [w.proc for w in agent._workers]
    files = [tmp_path / f"child.{p.pid}" for p in procs]
    deadline = time.time() + 60
    while not all(f.exists() and f.read_text() for f in files):
        assert time.time() < deadline
        time.sleep(0.05)
    grandchildren = [int(f.read_text()) for f in files]
    # One worker already died (a failure) and left its child; the other
    # ignores SIGTERM.
    procs[1].kill()
    procs[1].wait()
    t0 = time.monotonic()
    agent._stop_workers("test", grace=1.0)
    assert calls == ["test"]
    assert 0.9 < time.monotonic() - t0 < 30
    assert agent._workers == []
    assert procs[0].returncode == -signal.SIGKILL
    assert procs[1].returncode == -signal.SIGKILL
    deadline = time.time() + 10
    while not all(map(_gone, grandchildren)) and time.time() < deadline:
        time.sleep(0.05)
    assert all(map(_gone, grandchildren))


# -- the breakpoint save and a held fencing lock ------------------------------

_HOLDER = r"""
import sys, time
from dlrover_tpu_torch.common.multi_process import SharedLock
lock = SharedLock(sys.argv[1])
assert lock.acquire(timeout=10)
print("held", flush=True)
time.sleep(600)
"""


def test_breakpoint_save_skips_a_rank_whose_lock_is_held(tmp_path,
                                                          monkeypatch):
    for var in ("DLROVER_TPU_RUN_ID", "DLROVER_TPU_NUM_PROCESSES",
                "DLROVER_TPU_PROCESS_ID", "DLROVER_TPU_LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(ckpt_saver, "LOCK_TIMEOUT_S", 1.0)
    job = f"tlock-{os.getpid()}-{time.monotonic_ns()}"
    saver = AsyncCheckpointSaver(job, nproc_per_node=1)
    saver.start()
    d = str(tmp_path / "ck")
    ckpt = FlashCheckpointer(d, job_name=job)
    holder = None
    try:
        assert ckpt.agent_mode
        ckpt.save({"w": torch.full((8, 8), 3.0)}, meta={"step": 6})
        holder = subprocess.Popen(
            [sys.executable, "-c", _HOLDER, ckpt_saver.ckpt_lock_name(job, 0)],
            cwd=REPO, stdout=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        ready, _, _ = select.select([holder.stdout], [], [], 60)
        assert ready and holder.stdout.readline().strip() == "held"
        t0 = time.monotonic()
        saver.save_shm_to_storage("held lock")
        assert time.monotonic() - t0 < 20  # skipped, no deadlock
        assert shard_file.latest_step(PosixDiskStorage(), d) is None
        holder.kill()  # a holder that died frees its lock
        holder.wait()
        saver.save_shm_to_storage("holder died")
        assert shard_file.latest_step(PosixDiskStorage(), d) == 6
    finally:
        if holder is not None and holder.poll() is None:
            holder.kill()
            holder.wait()
        ckpt.close()
        saver.stop()
        unlink_arena(arena_name(job, 0))


# -- rendezvous across a master restart ---------------------------------------

def test_rendezvous_rejoins_a_restarted_master(monkeypatch):
    first = LocalJobMaster(0, job_name="rdzv", min_nodes=2, max_nodes=2)
    first.prepare()
    port = first.port
    cfg = T.ElasticLaunchConfig(min_nodes=2, max_nodes=2, node_id=0,
                                rdzv_timeout=60.0)
    agent = T.ElasticTrainingAgent(cfg, ["true"], first.addr)
    monkeypatch.setattr(agent._ctx, "rdzv_rejoin_interval", 1.0)
    box, second = {}, []
    t = threading.Thread(target=lambda: box.update(info=agent._rendezvous()))
    t.start()
    try:
        deadline = time.time() + 30
        mgr = first.rdzv_managers["elastic-training"]
        while 0 not in mgr._waiting_nodes:
            assert time.time() < deadline
            time.sleep(0.05)
        attempt = mgr._node_extra[0]["attempt_id"]
        first.stop()  # the master dies with the node's join
        time.sleep(0.5)
        second.append(LocalJobMaster(port, job_name="rdzv", min_nodes=2,
                                     max_nodes=2))
        second[0].prepare()
        mgr2 = second[0].rdzv_managers["elastic-training"]
        while 0 not in mgr2._waiting_nodes:
            assert time.time() < deadline
            time.sleep(0.05)
        assert mgr2._node_extra[0]["attempt_id"] == attempt
        other = T.MasterClient(second[0].addr, 1)
        other.register_node(node_rank=1, host="127.0.0.1")
        other.join_rendezvous(1, 1)
        t.join(timeout=30)
        info = box["info"]
        assert info["my_rank"] == 0 and len(info["world"]) == 2
        assert info["coordinator"].startswith("127.0.0.1:")
        other.close()
    finally:
        t.join(timeout=30)
        for mst in second:
            mst.stop()


# -- refusals and the launcher's helpers

@pytest.mark.parametrize("flags,match", [
    (["--standby"], None), (["--master_state_dir", "d"], None),
    (["--cell", "2"], "multi-cell"), (["--job_file", "j.yaml"], "YAML"),
])
def test_launcher_refuses_later_flags_by_name(flags, match):
    """Master HA's flags are taken now; the others still raise."""
    if match is None:
        args = trun.parse_args(flags + ["train.py"])
        assert args.standby or args.master_state_dir == "d"
        return
    with pytest.raises(NotImplementedError, match=match):
        trun.parse_args(flags + ["train.py"])


@pytest.mark.parametrize("env,kw,match", [
    ({"DLROVER_TPU_METRICS_PORT": "9100"}, {}, "METRICS_PORT"),
    ({"DLROVER_TPU_FAULTS": "worker.kill:step=3"}, {}, "FAULTS"),
    ({}, {"node_role": "gateway"}, "service role"),
])
def test_agent_refuses_later_options_by_name(monkeypatch, env, kw, match):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=match):
        T.ElasticTrainingAgent(T.ElasticLaunchConfig(**kw), ["true"],
                               "127.0.0.1:1")


def test_launcher_args_and_master_command():
    from dlrover_tpu import run as rrun

    argv = ["--standalone", "--nnodes=1:3", "--nproc_per_node=2",
            "--job_name=j", "train.py", "--", "--steps", "3"]
    args, want = trun.parse_args(argv), rrun.parse_args(argv)
    assert vars(args) == vars(want)
    assert trun.parse_nnodes(args.nnodes) == (1, 3)
    cmd = trun._master_cmd(args, 0, "pf")
    assert cmd[1:3] == ["-m", "dlrover_tpu_torch.master.main"]
    assert cmd[cmd.index("--max_nodes") + 1] == "3"
    assert cmd[-2:] == ["--port_file", "pf"]
    assert trun._coerce(False, "yes") is True and trun._coerce(2.0, "3") == 3.0


def test_gc_shm_arenas_scopes_by_run_and_age():
    job = f"tgc{os.getpid()}"
    paths = [f"/dev/shm/dlrtpu_{job}-r1_ckpt_0",
             f"/dev/shm/dlrtpu_{job}-r2_ckpt_0",
             f"/dev/shm/dlrtpu_{job}x-r1_ckpt_0"]
    for p in paths:
        Path(p).write_bytes(b"x")
    try:
        trun._gc_shm_arenas(job)  # fresh arenas stay
        assert all(os.path.exists(p) for p in paths)
        trun._gc_shm_arenas(job, "r1")
        assert [os.path.exists(p) for p in paths] == [False, True, True]
        old = time.time() - 7200
        os.utime(paths[1], (old, old))
        trun._gc_shm_arenas(job)
        assert not os.path.exists(paths[1]) and os.path.exists(paths[2])
    finally:
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)


def test_supervisor_relaunches_a_failed_master_on_its_port(tmp_path,
                                                           monkeypatch):
    """A master that exits nonzero is started again with the same port;
    one that exits 0 (the job ended) is not."""
    marker = tmp_path / "relaunched"
    cmds = []

    def master_cmd(args, port, port_file=""):
        cmds.append(port)
        return [sys.executable, "-c",
                f"open({str(marker)!r}, 'a').write('x')"]

    monkeypatch.setattr(trun, "_master_cmd", master_cmd)
    args = trun.parse_args(["--standalone", "train.py"])
    for first_rc, relaunched in ((3, True), (0, False)):
        marker.unlink(missing_ok=True)
        cmds.clear()
        holder = [subprocess.Popen([sys.executable, "-c",
                                    f"import sys; sys.exit({first_rc})"])]
        stop = threading.Event()
        thread = trun._supervise_local_master(args, holder, 4321, stop,
                                              max_restarts=1)
        # Supervision ends by itself once a master exited 0.
        thread.join(timeout=30)
        stop.set()
        assert not thread.is_alive()
        assert cmds == ([4321] if relaunched else [])
        assert marker.exists() == relaunched
        holder[0].wait(timeout=30)
