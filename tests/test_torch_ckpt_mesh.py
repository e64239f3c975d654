"""The sharded flash checkpoint, restored onto another mesh, against the
reference's (``dlrover_tpu/checkpoint/engine.py``: partial boxes,
``_target_boxes``, ``_finish_load``, ``load(target_mesh=)``).

One module-scoped world of two ``gloo`` children (``tests/
torch_mesh_child.py``) on the tiny Llama (fp32, d_model 128, d_ff 256):

- the port trains one AdamW step on ``fsdp2`` and saves the whole state,
  each rank writing its own boxes (about half the bytes each), and rank 0
  reports every tensor of the state gathered (CRC-32); a ``dp2`` job
  restores it from storage (``load(target_mesh=)``) and an ``fsdp2`` job
  warm from the ranks' shm arenas, each gathering the same CRCs; this
  process restores it at world 1 onto the one-rank mesh: the same CRCs;
- the reference saves its parameters from four host devices as
  ``fsdp4`` (four partial boxes in one process's shard); the port
  restores them at world 1 (this process) and as ``fsdp2`` (each child's
  boxes), every tensor equal bit for bit;
- the reference restores the port's ``fsdp2`` files onto one device and
  onto ``fsdp4``: every parameter's bytes have the port's gathered CRC.

The children run with ``start_new_session=True``, ``OMP_NUM_THREADS=1``,
a port probed by binding 0, a deadline each, and are reaped in a
``finally``; every arena is unlinked.
"""

import importlib
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu_torch.checkpoint import shard_file, tree_utils
from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common.shm import unlink_arena
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.parallel.mesh import MeshSpec, build_mesh

import torch_mesh_child as child

jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")
jengine = importlib.import_module("dlrover_tpu.checkpoint.engine")

MODEL = {"d_model": 128, "d_ff": 256}


def _crc(a) -> int:
    return zlib.crc32(np.ascontiguousarray(np.asarray(a)).tobytes())


@pytest.fixture
def ref_env(monkeypatch):
    def make(job):
        monkeypatch.setenv("DLROVER_TPU_JOB_NAME", job)
        monkeypatch.setenv("DLROVER_TPU_RUN_ID", f"run-{job}")
        monkeypatch.setenv("DLROVER_TPU_PROCESS_ID", "0")
        monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
        return job
    return make


def _ref_save(d, state, job):
    eng = jengine.CheckpointEngine(d, job_name=job)
    try:
        eng.save_to_storage(1, state, {"step": 1})
        assert eng.wait(60)
    finally:
        eng.close()
        unlink_arena(eng._arena.name)


def _ref_load(d, target, job):
    eng = jengine.CheckpointEngine(d, job_name=job)
    try:
        return eng.load(target)
    finally:
        eng.close()
        unlink_arena(eng._arena.name)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("ckpt_mesh")
    pid = os.getpid()
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(work / "params.npz",
             **child.flatten(jax.tree.map(np.asarray, jp)))
    tokens = np.random.RandomState(3).randint(
        0, jcfg.vocab_size, size=(1, 4, 17)).astype(np.int32)
    np.savez(work / "batches.npz", tokens=tokens)
    # The reference's fsdp4 save from four host devices in this process.
    mesh4 = jmesh.build_mesh(jmesh.MeshSpec(fsdp=4), jax.devices()[:4])
    specs = jacc.infer_param_specs(jp, jmesh.MeshSpec(fsdp=4))
    placed = jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh4, s)), jp, specs,
        is_leaf=lambda x: isinstance(x, jax.Array))
    env = {k: os.environ.get(k) for k in (
        "DLROVER_TPU_JOB_NAME", "DLROVER_TPU_RUN_ID",
        "DLROVER_TPU_PROCESS_ID", "DLROVER_TPU_NUM_PROCESSES")}
    os.environ.update(DLROVER_TPU_JOB_NAME=f"refsave-{pid}",
                      DLROVER_TPU_RUN_ID=f"run-refsave-{pid}",
                      DLROVER_TPU_PROCESS_ID="0",
                      DLROVER_TPU_NUM_PROCESSES="1")
    try:
        _ref_save(str(work / "ref"), {"params": placed}, f"refsave-{pid}")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    port_dir = str(work / "port")
    jobs = [
        dict(name="ref_as_fsdp2", mesh={"fsdp": 2}, load_dir=str(
            work / "ref"), target="params", boxes=True),
        dict(name="save_fsdp2", mesh={"fsdp": 2}, steps=1,
             save_dir=port_dir),
        dict(name="load_dp2", mesh={"dp": 2}, load_dir=port_dir),
        dict(name="warm_fsdp2", mesh={"fsdp": 2}, load_dir=port_dir,
             arena="save_fsdp2"),
    ]
    plan = {"device": "cpu", "model": MODEL,
            "params": str(work / "params.npz"),
            "batches": str(work / "batches.npz"), "jobs": jobs}
    recs = child.spawn_world(2, plan, work / "out", timeout=120)
    boxes = [torch.load(work / "out" / f"ref_as_fsdp2.rank{r}.pt")
             for r in range(2)]
    return dict(work=work, jcfg=jcfg, jp=jp, recs=recs, boxes=boxes,
                port_dir=port_dir, ref_dir=str(work / "ref"))


def test_fsdp2_ranks_write_their_own_boxes(world):
    saved = world["recs"]["save_fsdp2"]
    assert all(r["saved"] for r in saved)
    sizes = [os.path.getsize(shard_file.shard_path(world["port_dir"], 1, p))
             for p in (0, 1)]
    assert 0.4 <= sizes[0] / sum(sizes) <= 0.6
    man = shard_file.read_shard_manifest(PosixDiskStorage(),
                                         world["port_dir"], 1, 1)
    info = man.extra["tensors_info"]["['params']['embed']|0"]
    assert info["owners"] == [1] and info["global_shape"] == [256, 128]
    assert info["index"] == [[128, 256], [0, 128]]


def test_fsdp2_restores_as_dp2_from_storage_and_warm_from_shm(world):
    """On another mesh (dp2) the arenas hold the wrong boxes: storage; on
    the same mesh each rank's own arena (warm): the same state."""
    recs = world["recs"]
    for job, source in (("load_dp2", "storage"), ("warm_fsdp2", "shm")):
        assert [r["loaded_step"] for r in recs[job]] == [1, 1]
        assert [r["restore_source"] for r in recs[job]] == [source] * 2
        assert recs[job][0]["crcs"] == recs["save_fsdp2"][0]["crcs"]


def test_fsdp2_restores_at_world_1_onto_the_one_rank_mesh(world):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **MODEL)
    tree = jax.tree.map(np.asarray, world["jp"])
    job = tacc.accelerate(
        loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
        init_fn=lambda g: params_from_numpy(tree, tcfg, device="cpu",
                                            param_dtype=torch.float32),
        optimizer=adamw(3e-4), sample_batch={"tokens": np.zeros((4, 17))},
        strategy=tacc.Strategy(), device="cpu")
    state = job.create_state(torch.Generator())
    eng = CheckpointEngine(world["port_dir"], job_name=f"w1-{os.getpid()}")
    try:
        got, meta = eng.load(state, target_mesh=build_mesh(MeshSpec()))
    finally:
        eng.close()
        unlink_arena(eng.arena.name)
    assert got is state and meta["step"] == 1 and state["step"] == 1
    crcs = {k.rsplit("|", 1)[0]: child.crc(v) for k, v in
            tree_utils.flatten_to_shards(state)[0].items()}
    assert crcs == world["recs"]["save_fsdp2"][0]["crcs"]


def test_the_references_fsdp4_checkpoint_restores_at_world_1_and_2(world):
    jp = world["jp"]
    paths = jax.tree_util.tree_flatten_with_path(jp)[0]
    want = {jax.tree_util.keystr(p): np.asarray(x) for p, x in paths}
    # World 2: each child's fsdp2 boxes, bit for bit.
    for r, boxes in enumerate(world["boxes"]):
        assert sorted(boxes) == sorted(want)
        for path, (t, box) in boxes.items():
            sl = tuple(slice(a, b) for a, b in box)
            assert np.array_equal(t.numpy(), want[path][sl]), (r, path)
    # World 1, in this process.
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **MODEL)
    target = {"params": tllama.init_params(tcfg, torch.Generator(), "cpu",
                                           param_dtype=torch.float32)}
    eng = CheckpointEngine(world["ref_dir"], job_name=f"r1-{os.getpid()}")
    try:
        got, meta = eng.load(target)
    finally:
        eng.close()
        unlink_arena(eng.arena.name)
    assert meta["step"] == 1
    for leaf in tree_utils.state_leaves(got):
        key = leaf.path[len("['params']"):]
        assert np.array_equal(leaf.tensor.numpy(), want[key]), key


@pytest.mark.parametrize("n", [1, 4])
def test_the_reference_restores_the_ports_fsdp2_files(world, ref_env, n):
    job = ref_env(f"refload{n}-{os.getpid()}")
    devs = jax.devices()[:n]
    mesh = jmesh.build_mesh(jmesh.MeshSpec(fsdp=n), devs)
    specs = jacc.infer_param_specs(world["jp"], jmesh.MeshSpec(fsdp=n))
    target = {"params": jax.tree_util.tree_map(
        lambda x, s: jax.device_put(jnp.zeros_like(x),
                                    NamedSharding(mesh, s)),
        world["jp"], specs, is_leaf=lambda x: isinstance(x, jax.Array))}
    got, meta = _ref_load(world["port_dir"], target, job)
    assert int(meta["step"]) == 1
    want = world["recs"]["save_fsdp2"][0]["crcs"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
        name = jax.tree_util.keystr(path)
        assert len(leaf.sharding.device_set) == n
        assert _crc(leaf) == want[name], name
