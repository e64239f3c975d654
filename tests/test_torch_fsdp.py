"""The port's sharded train step against the reference's SPMD step.

The reference (``dlrover_tpu/parallel/accelerate.py`` ``accelerate``,
GSPMD over ``jax.devices()[:4]`` of the conftest's host devices) and the
port (``dlrover_tpu_torch/parallel/accelerate.py`` in four ``gloo``
children, one module-scoped spawn: ``tests/torch_mesh_child.py``) train
the tiny Llama (fp32, d_model 128, d_ff 256) from the same parameters
(the reference's ``init_params`` carried across by ``models/convert.py``)
on the same three global batches of 8 rows with ``adamw(3e-4)``:

- ``fsdp4`` (ZeRO-3, ``infer_param_specs``), ``dp2xfsdp2`` with
  ``grad_accum`` 2 and ``fsdp2xtp2`` with ``param_specs="planner"``: each
  step's loss and gradient norm within 1e-5 relative; after three steps
  each rank's box of every parameter has the index of the reference's
  shard on device ``r``; all but 0.1 % of its values lie within 1e-5 of
  max|ref| of the reference's and every value within ``PARAM_ATOL`` = 3 x
  1e-5 (``tests/test_torch_train.py``'s bound of 1e-5 a step: AdamW's
  normalised update turns a sum-order difference in a gradient entry
  near 0 into up to ~0.03 x lr a step; on these inputs one embedding
  element differs by 2.6e-6 at world 1 without any sharding, and one
  ``lm_head`` element by 1.03e-5 on ``dp2xfsdp2``); a rank keeps only
  its boxes (its bytes are the reference's per-device bytes);
- the remat policies ``full``, ``dots`` and ``dots_no_batch`` on ``fsdp4``
  equal ``none`` within 1e-6 (losses, gradient norms, parameters).

The children run with ``start_new_session=True``, ``OMP_NUM_THREADS=1``,
a port probed by binding 0, a deadline each, and are reaped in a
``finally``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import mesh as jmesh

import torch_mesh_child as child

jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")

RTOL = 1e-5
LR = 3e-4
STEPS = 3
PARAM_ATOL = 1e-5 * STEPS
PARAM_OUTLIERS = 1e-3  # the share of a leaf's values held at PARAM_ATOL only
REMAT_TOL = 1e-6
MODEL = {"d_model": 128, "d_ff": 256}
CONFIGS = {
    "fsdp4": dict(mesh=dict(fsdp=4)),
    "dp2xfsdp2": dict(mesh=dict(dp=2, fsdp=2), grad_accum=2),
    "fsdp2xtp2": dict(mesh=dict(fsdp=2, tp=2), param_specs="planner"),
}
REMATS = ("full", "dots", "dots_no_batch")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    work = tmp_path_factory.mktemp("fsdp")
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **MODEL)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    np.savez(work / "params.npz",
             **child.flatten(jax.tree.map(np.asarray, jp)))
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, jcfg.vocab_size,
                         size=(STEPS, 8, 17)).astype(np.int32)
    np.savez(work / "batches.npz", tokens=tokens)
    return work, jcfg, jp, tokens


@pytest.fixture(scope="module")
def port(data):
    work, _, _, _ = data
    jobs = [dict(name=n, steps=STEPS, boxes=True, **c)
            for n, c in CONFIGS.items()]
    jobs += [dict(name=f"fsdp4_{r}", mesh=dict(fsdp=4), remat=r,
                  steps=STEPS, boxes=True) for r in REMATS]
    plan = {"device": "cpu", "model": MODEL,
            "params": str(work / "params.npz"),
            "batches": str(work / "batches.npz"), "jobs": jobs}
    recs = child.spawn_world(4, plan, work / "out", timeout=150)
    boxes = {j["name"]: [torch.load(work / "out" / f"{j['name']}.rank{r}.pt")
                         for r in range(4)] for j in jobs}
    return recs, boxes


@pytest.fixture(scope="module")
def reference(data):
    """The reference's three steps on each config: losses, norms, and the
    final params' shards by device."""
    _, jcfg, jp, tokens = data
    devs = jax.devices()[:4]
    out = {}
    for name, c in CONFIGS.items():
        job = jacc.accelerate(
            loss_fn=lambda p, b: jllama.loss_fn(p, b, jcfg),
            init_fn=lambda rng: jp, optimizer=optax.adamw(LR),
            sample_batch={"tokens": tokens[0]},
            strategy=jacc.Strategy(mesh=jmesh.MeshSpec(**c["mesh"]),
                                   grad_accum=c.get("grad_accum", 1)),
            param_specs=c.get("param_specs"), devices=devs)
        state = job.create_state(jax.random.PRNGKey(0))
        losses, norms = [], []
        for i in range(STEPS):
            state, m = job.train_step(state, {"tokens": tokens[i]})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        paths = jax.tree_util.tree_flatten_with_path(state["params"])[0]
        shards = {}
        for path, leaf in paths:
            shards[jax.tree_util.keystr(path)] = {
                devs.index(s.device): (
                    tuple((0 if sl.start is None else sl.start,
                           d if sl.stop is None else sl.stop)
                          for sl, d in zip(s.index, leaf.shape)),
                    np.asarray(s.data)) for s in leaf.addressable_shards}
        out[name] = (losses, norms, shards)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_losses_and_grad_norms_match_the_reference(port, reference, name):
    recs, _ = port
    losses, norms, _ = reference[name]
    for r, rec in enumerate(recs[name]):
        np.testing.assert_allclose(rec["losses"], losses, rtol=RTOL, atol=0)
        np.testing.assert_allclose(rec["grad_norms"], norms, rtol=RTOL,
                                   atol=0)
    if name == "fsdp2xtp2":
        # The planner put tp on leaves, and the ranks of a tp pair read
        # the same rows.
        assert recs[name][0]["tp_leaves"] > 0
        assert [rec["batch_rank"] for rec in recs[name]] == \
            [[0, 2], [0, 2], [1, 2], [1, 2]]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_rank_holds_the_references_shard_of_its_device(port, reference,
                                                            name):
    """Box for box: rank r's box of every parameter is the index of the
    reference's shard on device r, its values as the module docstring
    says, and the rank keeps nothing else (its bytes are that device's)."""
    recs, boxes = port
    _, _, shards = reference[name]
    for r in range(4):
        mine = boxes[name][r]
        assert sorted(mine) == sorted(shards)
        nbytes = 0
        for path, (t, box) in mine.items():
            idx, ref = shards[path][r]
            assert tuple(tuple(b) for b in box) == idx, path
            diff = np.abs(t.numpy() - ref)
            assert float(diff.max()) <= PARAM_ATOL, (path, float(diff.max()))
            far = int((diff > RTOL * float(np.abs(ref).max())).sum())
            assert far <= PARAM_OUTLIERS * diff.size, (path, far)
            nbytes += ref.nbytes
        assert recs[name][r]["param_box_bytes"] == nbytes


@pytest.mark.parametrize("remat", REMATS)
def test_remat_policies_equal_no_remat(port, remat):
    recs, boxes = port
    base, got = recs["fsdp4"], recs[f"fsdp4_{remat}"]
    for a, b in zip(base, got):
        np.testing.assert_allclose(b["losses"], a["losses"], rtol=REMAT_TOL,
                                   atol=0)
        np.testing.assert_allclose(b["grad_norms"], a["grad_norms"],
                                   rtol=REMAT_TOL, atol=0)
    # Remat gathers each block's leaves again in the backward pass.
    assert got[0]["comm"][0]["all_gather"]["calls"] > \
        base[0]["comm"][0]["all_gather"]["calls"]
    for r in range(4):
        for path, (t, _) in boxes[f"fsdp4_{remat}"][r].items():
            want = boxes["fsdp4"][r][path][0]
            scale = max(float(want.abs().max()), 1e-30)
            assert float((t - want).abs().max()) <= REMAT_TOL * scale, path


def test_a_rebuild_carries_the_state_onto_the_new_job():
    """``ElasticTrainer.build`` for a new world gathers the carried state on
    the old job's mesh and keeps the new placement's boxes: every tensor
    of the state (moments and step counts too) equal bit for bit, the
    sampler's position kept, and the next step runs."""
    from dlrover_tpu_torch.models import llama as tllama
    from dlrover_tpu_torch.optim import adamw
    from dlrover_tpu_torch.parallel.accelerate import Strategy
    from dlrover_tpu_torch.trainer import elastic as telastic

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **MODEL)
    rows = np.random.RandomState(5).randint(0, 256, size=(8, 17))

    def fetch(idx):
        return {"tokens": rows[np.asarray(idx) % 8].astype(np.int32)}

    core = telastic.ElasticTrainer(
        telastic.TrainerConfig(4, 4), loss_fn=lambda p, b: tllama.loss_fn(
            p, b, cfg),
        init_fn=lambda g: tllama.init_params(cfg, g, "cpu",
                                             param_dtype=torch.float32),
        optimizer=adamw(LR), fetch_batch=fetch, dataset_size=8,
        strategy=Strategy(), devices=["cpu"])
    core.build(1, 0)
    next(core.epoch())
    before = {k: v.clone() for k, v in core.job.gather_state(
        core.state).items()}
    old_params = core.state["params"]
    core.build(1, 0)
    after = core.job.gather_state(core.state)
    assert sorted(after) == sorted(before)
    for k, v in before.items():
        assert torch.equal(after[k], v), k
    assert core.state["params"] is not old_params
    assert core.sampler.completed_steps == 1
    assert np.isfinite(float(next(core.epoch())["loss"]))
