"""Several processes on one host, on the CPU over ``gloo``: the port's
``trainer/bootstrap.init`` (``common/dist_env.py``), data parallelism in
``parallel/accelerate.py`` and the multi-process ``CheckpointEngine``,
each process started as the agent starts a worker, with the env contract
(``DLROVER_TPU_COORDINATOR``, ``DLROVER_TPU_NUM_PROCESSES``,
``DLROVER_TPU_PROCESS_ID``, ``DLROVER_TPU_LOCAL_RANK``).

The world-2 run, in each of two processes: bootstrap; a cold restore of a
checkpoint one process saved (1 -> 2); three AdamW steps of the tiny Llama
(fp32) at B 1 each on the global batches; a save sliced across both ranks
and committed by the leader; a warm restore at world 2 and one more step
equal to the uninterrupted run's; arenas that hold different steps on the
two ranks, from which both fall back to storage together; then rank 1
dies before its done vote for the next step, and the leader's commit
times out.  The parent holds:
the first loss against the reference's ``loss_fn`` on the global batch
(atol 1e-5), the losses, grad norms and parameters of the three steps
against one process at B 2 (atol 1e-5, as ``tests/test_torch_train.py``
holds one process against the reference), the committed step still the
older one and the ladder restoring it, bit for bit, at world 1 (2 -> 1)
and, in a world-3 run, at world 3 (2 -> 3).

Every child has its own limit (``DLROVER_TPU_DIST_TIMEOUT_S`` for the
collectives, a process timeout here), is killed when it overruns, and the
arenas are unlinked."""

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.common import env as ref_env
from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.checkpoint import shard_file, slicer, tree_utils
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common import multi_process as port_mp
from dlrover_tpu_torch.common.shm import arena_name, unlink_arena
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.trainer import bootstrap

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-5
LR = 3e-4
CHILD_TIMEOUT_S = 120
STEPS = 3

# One worker process of the job.  argv: mode, work dir.  It writes what
# the parent checks to <dir>/rank<i>.json (and rank 0 its state).
CHILD = r'''
import json, os, sys, zlib
import numpy as np
import torch
torch.set_num_threads(1)
from dlrover_tpu_torch.checkpoint import tree_utils
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel import accelerate as acc
from dlrover_tpu_torch.trainer import bootstrap

mode, work = sys.argv[1], sys.argv[2]
ctx = bootstrap.init(device="cpu")
r, n = ctx.process_id, ctx.num_processes
out = {"distributed": ctx.distributed, "rank": r, "world": n,
       "same_ctx": bootstrap.init(device="cpu") is ctx
       and bootstrap.get_elastic_context() is ctx,
       "poll": ctx.poll_reshard(), "report": ctx.report_reshard(1),
       "backend": dist_env.group_backend(),
       "ranks": dist_env.allgather_ints(r)}
cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
tree = dict(np.load(os.path.join(work, "params.npz")))
def unflat(tree):
    # params.npz holds the flattened reference tree: "a/b/0/c" keys.
    root = {}
    for key, v in tree.items():
        node, parts = root, key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    def fix(node):
        if isinstance(node, dict) and node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(root)
tree = unflat(tree)
batches = np.load(os.path.join(work, "batches.npy"))
b = batches.shape[1] // n
job = acc.accelerate(
    loss_fn=lambda p, bt: llama.loss_fn(p, bt, cfg),
    init_fn=lambda g: params_from_numpy(tree, cfg, device="cpu",
                                        param_dtype=torch.float32),
    optimizer=adamw(3e-4),
    sample_batch={"tokens": np.repeat(batches[0][:1], n, axis=0)},
    strategy=acc.Strategy(mesh={"dp": n}), device="cpu")
def local(i):
    return {"tokens": batches[i][r * b:(r + 1) * b]}
def crcs(state):
    t, _ = tree_utils.flatten_to_shards(state)
    return {k: zlib.crc32(v.detach().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes())
            for k, v in t.items()}
job_name = os.environ["TEST_JOB"]
ckpt = os.path.join(work, "ckpt")
if mode == "world2":
    # 1 -> 2: a checkpoint one process saved, restored cold here.
    one = job.create_state(torch.Generator())
    eng1 = CheckpointEngine(os.path.join(work, "one"), job_name=job_name + "-one")
    got = eng1.load(one)
    out["from_one"] = {"step": got[1]["step"], "source": eng1.last_restore_source,
                       "crcs": crcs(one)}
    eng1.close()
    state = job.create_state(torch.Generator())
    out["losses"], out["gnorms"] = [], []
    for i in range(3):
        state, m = job.train_step(state, local(i))
        out["losses"].append(float(m["loss"]))
        out["gnorms"].append(float(m["grad_norm"]))
    if r == 0:
        np.savez(os.path.join(work, "after3.npz"), **{
            f"p{i}": t.detach().numpy()
            for i, t in enumerate(acc.tree_leaves(state["params"]))})
    eng = CheckpointEngine(ckpt, job_name=job_name, commit_timeout=30)
    eng.save_to_storage(3, state, {"step": 3})
    out["committed"] = eng.wait(60)
    out["stats"] = eng.stats()
    out["saved_crcs"] = crcs(state)
    eng.close()
    # Warm restore at world 2 into a fresh state; one more step each.
    fresh = job.create_state(torch.Generator())
    eng = CheckpointEngine(ckpt, job_name=job_name, commit_timeout=1)
    got = eng.load(fresh)
    out["warm"] = {"step": got[1]["step"], "source": eng.last_restore_source,
                   "equal": crcs(fresh) == out["saved_crcs"]}
    _, m1 = job.train_step(state, local(3))
    _, m2 = job.train_step(fresh, local(3))
    out["warm"]["next_losses"] = [float(m1["loss"]), float(m2["loss"])]
    # The ranks' arenas hold different steps: both restore from storage.
    if r == 0:
        eng.save_to_memory(5, fresh, {"step": 5})
    again = job.create_state(torch.Generator())
    eng3 = CheckpointEngine(ckpt, job_name=job_name, commit_timeout=1)
    got = eng3.load(again)
    out["disagree"] = {"step": got[1]["step"],
                       "source": eng3.last_restore_source,
                       "equal": crcs(again) == out["saved_crcs"]}
    eng3.close()
    # Rank 1 dies before its done vote of step 4.
    if r == 1:
        with open(os.path.join(work, "rank1.json"), "w") as f:
            json.dump(out, f)
        os._exit(0)
    eng.save_to_storage(4, fresh, {"step": 4})
    out["step4_committed"] = eng.wait(10)
    eng.close()
elif mode == "world3":
    state = job.create_state(torch.Generator())
    eng = CheckpointEngine(ckpt, job_name=job_name, commit_timeout=3)
    got = eng.load(state)
    out["cold"] = {"step": got[1]["step"], "source": eng.last_restore_source,
                   "crcs": crcs(state)}
    eng.close()
with open(os.path.join(work, f"rank{r}.json"), "w") as f:
    json.dump(out, f)
sys.stdout.flush()
os._exit(0)
'''


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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(mode: str, work: Path, world: int, job: str) -> list:
    """``world`` children under the env contract; their JSON records.  A
    port taken between the probe and the rendezvous is retried once."""
    for attempt in (0, 1):
        port = _free_port()
        procs = []
        try:
            for r in range(world):
                env = dict(os.environ, OMP_NUM_THREADS="1",
                           DLROVER_TPU_COORDINATOR=f"127.0.0.1:{port}",
                           DLROVER_TPU_NUM_PROCESSES=str(world),
                           DLROVER_TPU_PROCESS_ID=str(r),
                           DLROVER_TPU_LOCAL_RANK=str(r),
                           DLROVER_TPU_DIST_TIMEOUT_S="60",
                           DLROVER_TPU_LOG_LEVEL="WARNING", TEST_JOB=job)
                for var in ("DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_FAULTS",
                            "DLROVER_TPU_RUN_ID"):
                    env.pop(var, None)
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", CHILD, mode, str(work)],
                    cwd=REPO, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True))
            outs = [p.communicate(timeout=CHILD_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        errs = "\n".join(e for _, e in outs)
        if attempt == 0 and "ddress already in use" in errs:
            continue
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r}: {outs[r][1][-3000:]}"
        return [json.loads((work / f"rank{r}.json").read_text())
                for r in range(world)]
    raise AssertionError("no free port")


def _flat_tree(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_tree(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _crcs(state):
    t, _ = tree_utils.flatten_to_shards(state)
    return {k: zlib.crc32(v.detach().contiguous().reshape(-1)
                          .view(torch.uint8).numpy().tobytes())
            for k, v in t.items()}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The world-2 run (see the module docstring) and what it needs."""
    work = tmp_path_factory.mktemp("dist")
    job = f"tdist{os.getpid()}"
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    np.savez(work / "params.npz", **_flat_tree(tree))
    rng = np.random.RandomState(5)
    batches = rng.randint(0, 256, size=(4, 2, 17)).astype(np.int32)
    np.save(work / "batches.npy", batches)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)

    def job_b2():
        return tacc.accelerate(
            loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
            init_fn=lambda g: params_from_numpy(
                tree, tcfg, device="cpu", param_dtype=torch.float32),
            optimizer=adamw(LR), sample_batch={"tokens": batches[0]},
            strategy=tacc.Strategy(), device="cpu")

    # A checkpoint of one process (step 1) for the 1 -> 2 restore.
    one_job = job_b2()
    one = one_job.create_state(torch.Generator())
    one, _ = one_job.train_step(one, {"tokens": batches[0]})
    eng = CheckpointEngine(str(work / "one"), job_name=f"{job}-one")
    eng.save_to_storage(1, one, {"step": 1})
    assert eng.wait(60)
    eng.close()
    unlink_arena(eng.arena.name)
    try:
        recs = _spawn("world2", work, 2, job)
        yield {"work": work, "job": job, "recs": recs, "tree": tree,
               "batches": batches, "jcfg": jcfg, "job_b2": job_b2,
               "one_crcs": _crcs(one)}
    finally:
        for name in (job, f"{job}-one"):
            for r in range(3):
                unlink_arena(arena_name(name, r))


def test_bootstrap_brings_up_a_world_from_the_env_contract(world2):
    for r, rec in enumerate(world2["recs"]):
        assert rec["distributed"] and rec["rank"] == r and rec["world"] == 2
        assert rec["same_ctx"] and rec["poll"] is None \
            and rec["report"] is None
        assert rec["backend"] == "gloo" and rec["ranks"] == [0, 1]


def test_bootstrap_refuses_a_master_faults_and_a_world_without_coordinator(
        monkeypatch):
    """A master address is no longer refused: ``init`` builds the master
    client (the elastic loop) and the leader's ``report_step`` reaches the
    master's speed monitor; faults and a world without a coordinator still
    raise."""
    from dlrover_tpu_torch.agent import master_client
    from dlrover_tpu_torch.master.master import LocalJobMaster

    monkeypatch.setattr(bootstrap, "_ctx", None)
    for var in ("DLROVER_TPU_COORDINATOR", "DLROVER_TPU_FAULTS",
                "DLROVER_TPU_MASTER_ADDR", "DLROVER_TPU_NUM_PROCESSES",
                "DLROVER_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    master = LocalJobMaster(0)
    master.prepare()
    try:
        master_client.reset_master_client()
        monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", master.addr)
        ctx = bootstrap.init(device="cpu")
        assert ctx.client is not None and ctx.client.addr == master.addr
        ctx.report_step(3)
        assert master.speed_monitor.completed_global_step == 3
        assert ctx.poll_reshard() is None and ctx.report_reshard(1) is None
    finally:
        master.stop()
        master_client.reset_master_client()
        monkeypatch.setattr(bootstrap, "_ctx", None)
    monkeypatch.delenv("DLROVER_TPU_MASTER_ADDR")
    monkeypatch.setenv("DLROVER_TPU_FAULTS", "worker.kill:step=1")
    with pytest.raises(NotImplementedError, match="DLROVER_TPU_FAULTS"):
        bootstrap.init()
    monkeypatch.delenv("DLROVER_TPU_FAULTS")
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="DLROVER_TPU_COORDINATOR"):
        bootstrap.init(device="cpu")
    assert bootstrap.get_elastic_context() is None
    assert dist_env.choose_backend(torch.device("cpu")) == "gloo"


@pytest.mark.parametrize("kw", [
    dict(job_name="j", master_addr="10.0.0.1:5000", node_id=3, node_rank=1,
         node_num=2, process_id=5, num_processes=8,
         coordinator="10.0.0.2:1234"),
    dict(job_name="llama-7b", master_addr="", node_id=0, node_rank=0,
         node_num=1, process_id=0, num_processes=1,
         coordinator="127.0.0.1:29500", restart_count=4)])
def test_worker_env_is_the_reference_contract(kw, monkeypatch):
    """The env an agent gives a worker is the reference's, and the port's
    getters read back what the reference's read."""
    env = env_utils.worker_env(**kw)
    assert env == ref_env.worker_env(**kw)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    for get in ("get_process_id", "get_num_processes", "get_coordinator"):
        assert getattr(env_utils, get)() == getattr(ref_env, get)()
    assert env_utils.get_coordinator() == kw["coordinator"]


def test_world2_training_matches_one_process_and_the_reference(world2):
    """B 1 on each of two processes against B 2 on one; the first loss
    against the reference's ``loss_fn`` on the global batch."""
    batches, jcfg = world2["batches"], world2["jcfg"]
    jp = jax.tree.map(jnp.asarray, world2["tree"])
    want0 = float(jax.jit(lambda p, t: jllama.loss_fn(p, {"tokens": t},
                                                       jcfg))(
        jp, jnp.asarray(batches[0])))
    recs = world2["recs"]
    assert abs(recs[0]["losses"][0] - want0) <= ATOL
    job = world2["job_b2"]()
    state = job.create_state(torch.Generator())
    for i in range(STEPS):
        state, m = job.train_step(state, {"tokens": batches[i]})
        for rec in recs:  # the global mean, the same on both ranks
            assert abs(rec["losses"][i] - float(m["loss"])) <= ATOL
            assert abs(rec["gnorms"][i] - float(m["grad_norm"])) <= \
                ATOL * float(m["grad_norm"])
    got = np.load(world2["work"] / "after3.npz")
    for i, t in enumerate(tacc.tree_leaves(state["params"])):
        np.testing.assert_allclose(got[f"p{i}"], t.detach().numpy(),
                                   atol=ATOL, rtol=0)


def test_world2_saves_sliced_commits_and_restores_warm(world2):
    recs = world2["recs"]
    for rec in recs:
        assert rec["from_one"]["step"] == 1
        assert rec["from_one"]["source"] == "storage"
        assert rec["from_one"]["crcs"] == world2["one_crcs"]
        assert rec["committed"]
        st = rec["stats"]
        assert st["num_processes"] == 2 and not st["agent_mode"]
        assert 0.3 <= st["written_bytes"] / st["staged_bytes"] <= 0.7
        w = rec["warm"]
        assert w["step"] == 3 and w["source"] == "shm" and w["equal"]
        assert w["next_losses"][0] == w["next_losses"][1]
        # Arenas at steps 5 and 3: the agreement sends both to storage.
        assert rec["disagree"] == {"step": 3, "source": "storage",
                                   "equal": True}
    assert recs[0]["saved_crcs"] == recs[1]["saved_crcs"]
    d = str(world2["work"] / "ckpt")
    assert sorted(shard_file.list_shard_ids(PosixDiskStorage(), d, 3)) == \
        [0, 1]
    assert slicer.step_covers(PosixDiskStorage(), d, 3)[0]


def test_a_rank_dead_before_its_vote_blocks_the_commit(world2, monkeypatch):
    """Rank 1 died before step 4's done vote: the leader's commit timed
    out, step 3 stays committed, and the ladder restores it (here at world
    1: 2 -> 1, from both ranks' slices)."""
    recs = world2["recs"]
    assert recs[0]["step4_committed"] is False
    d = str(world2["work"] / "ckpt")
    storage = PosixDiskStorage()
    assert shard_file.latest_step(storage, d) == 3
    assert shard_file.list_shard_ids(storage, d, 4) == [0]
    ok, why = slicer.step_covers(storage, d, 4)
    assert not ok and "uncovered" in why
    for var in ("DLROVER_TPU_NUM_PROCESSES", "DLROVER_TPU_PROCESS_ID",
                "DLROVER_TPU_LOCAL_RANK", "DLROVER_TPU_RUN_ID"):
        monkeypatch.delenv(var, raising=False)
    job = world2["job_b2"]()
    state = job.create_state(torch.Generator())
    eng = CheckpointEngine(d, job_name=f"{world2['job']}-cold1")
    try:
        got = eng.load(state)
    finally:
        eng.close()
        unlink_arena(eng.arena.name)
    assert got[1]["step"] == 3 and eng.last_restore_source == "storage"
    assert _crcs(state) == recs[0]["saved_crcs"]


def test_world3_restores_the_world2_checkpoint(world2):
    """2 -> 3: three processes restore the step two saved, from storage
    (the arenas belong to the old world), bit for bit."""
    recs3 = _spawn("world3", world2["work"], 3, world2["job"])
    for r, rec in enumerate(recs3):
        assert rec["world"] == 3 and rec["ranks"] == [0, 1, 2]
        assert rec["cold"]["step"] == 3
        assert rec["cold"]["source"] == "storage"
        assert rec["cold"]["crcs"] == world2["recs"][0]["saved_crcs"]


def test_accelerate_sweeps_candidates_and_refuses_dp_above_the_world():
    """One process: ``dp`` above the world raises naming item 5; a
    candidate list takes the first that builds everywhere."""
    kw = dict(loss_fn=lambda p, b: p["w"].sum(),
              init_fn=lambda g: {"w": torch.zeros(2)},
              optimizer=adamw(LR), sample_batch={"tokens": np.zeros((2, 3))},
              device="cpu")
    with pytest.raises(NotImplementedError, match="item 5"):
        tacc.accelerate(strategy=tacc.Strategy(mesh={"dp": 2}), **kw)
    job = tacc.accelerate(strategy=[tacc.Strategy(mesh={"tp": 2}),
                                    tacc.Strategy(mesh={"dp": 1}),
                                    tacc.Strategy()], **kw)
    assert job.strategy.mesh == {"dp": 1} and job.dp == 1
    with pytest.raises(RuntimeError, match="no viable strategy"):
        tacc.accelerate(strategy=[tacc.Strategy(mesh={"tp": 2})], **kw)
