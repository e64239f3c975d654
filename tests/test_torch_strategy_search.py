"""The port's strategy search against the reference's
(``dlrover_tpu/parallel/strategy_search.py``, ``accelerate``'s search).

1. The numpy pieces equal the reference's exactly: ``default_space`` (its
   entries as ``strategy_to_dict`` gives them, in order), ``_features``,
   ``estimate_step_hbm_bytes`` on Llama-800M's and the tiny model's
   parameter shapes (the reference's ``jax.eval_shape``, the port's fake
   tensors), ``prune_space_by_memory``, the GP's prediction and the
   expected improvement (``==`` on every float).
2. ``BayesStrategySearch`` with one synthetic objective (``offload``
   points raise, as the port's objective does for item 5c) visits the same
   points in the same order in both packages, ``inf`` points included.
3. A cache entry written by either package is read by the other; an
   entry the port cannot honour (``compute_dtype`` float32) reads as a
   miss.  :func:`fingerprint`'s parameter and batch parts are the
   reference's: with no optimizer state the two packages' keys are equal;
   the optimizer part (the port's optimizer class, optax's state tree)
   differs, and so does a key at another device count.
4. In two ``gloo`` children (``tests/torch_seq_child.py``, one spawn):
   ``accelerate(strategy="auto", cache=)`` gives the same winner on both
   ranks with the leader's scores, a second call hits the cache and builds
   one job, ``strategy="bo"`` evaluates the same points with the same
   (leader's) times on both ranks, and ``MasterStrategyCache`` over a
   live port master (``LocalJobMaster`` in this process) stores the
   winner under ``strategy-cache/<fingerprint>`` and hits it; the cost
   model's ``all_gather``, ``reduce_scatter`` and ``all_reduce`` bytes
   equal what ``collectives.snapshot()`` records over one real step of the
   same candidate.
5. BO's best is never worse than its warm start, the cost model's pick
   (the reference's ``test_bo_beats_or_matches_cost_model_pick``).
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")
from dlrover_tpu.parallel import strategy_search as jss
from dlrover_tpu.parallel.mesh import MeshSpec as JMeshSpec
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.parallel import strategy_search as tss
from dlrover_tpu_torch.parallel.mesh import MeshSpec

import torch_mesh_child as child

_CHILD = child.REPO / "tests" / "torch_seq_child.py"
SPACES = [
    dict(),
    dict(remat=("none", "dots", "full", "offload"), allow_pp=False),
    dict(accum=(2,), fp8=(False, True)),
    dict(quant_grads=(False, True), allow_ep=True),
]


def _dicts(space, pkg):
    return [pkg.strategy_to_dict(s) for s in space]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kw", SPACES, ids=["default", "no_block", "accum2",
                                            "quant"])
def test_default_space_and_features_equal_the_reference(n, kw):
    port, ref = tss.default_space(n, **kw), jss.default_space(n, **kw)
    assert _dicts(port, tss) == _dicts(ref, jss)
    for p, r in zip(port, ref):
        assert np.array_equal(tss._features(p), jss._features(r))


def _shapes(cfg_name):
    """The reference's and the port's parameter shapes of one config."""
    jcfg = getattr(jllama.LlamaConfig, cfg_name)()
    tcfg = getattr(tllama.LlamaConfig, cfg_name)()
    jshape = jax.eval_shape(lambda k: jllama.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    abstract = tacc._Abstract(
        lambda g: tllama.init_params(tcfg, g, "cpu",
                                     param_dtype=torch.float32),
        adamw(1e-3), torch.device("cpu"))
    return jshape, abstract, jcfg


@pytest.fixture(scope="module")
def shapes():
    return {name: _shapes(name) for name in ("medium_800m", "tiny")}


@pytest.mark.parametrize("cfg_name", ["medium_800m", "tiny"])
def test_memory_model_and_pruning_equal_the_reference(cfg_name, shapes):
    jshape, abstract, jcfg = shapes[cfg_name]
    batch = {"tokens": np.zeros((8, min(2049, jcfg.max_seq_len + 1)),
                                np.int32)}
    # Every tenth point of the grid: each mesh, remat, accum and offload
    # value appears.
    port, ref = tss.default_space(8)[::10], jss.default_space(8)[::10]
    est_p = [tss.estimate_step_hbm_bytes(abstract.params, batch, s)
             for s in port]
    est_r = [jss.estimate_step_hbm_bytes(jshape, batch, s) for s in ref]
    assert est_p == est_r
    budget = float(np.median(est_r))
    assert _dicts(tss.prune_space_by_memory(port, abstract.params, batch,
                                            budget), tss) == \
        _dicts(jss.prune_space_by_memory(ref, jshape, batch, budget), jss)
    assert tss._CALIBRATION == jss._CALIBRATION == 0.75


def test_gp_and_expected_improvement_equal_the_reference():
    rng = np.random.RandomState(5)
    X, y, Xs = rng.randn(9, 10), rng.rand(9) * 3, rng.randn(20, 10)
    gp_p, gp_r = tss._GP(), jss._GP()
    gp_p.fit(X, y)
    gp_r.fit(X, y)
    (mu_p, sd_p), (mu_r, sd_r) = gp_p.predict(Xs), gp_r.predict(Xs)
    assert np.array_equal(mu_p, mu_r) and np.array_equal(sd_p, sd_r)
    assert np.array_equal(
        tss._expected_improvement(mu_p, sd_p, float(y.min())),
        jss._expected_improvement(mu_r, sd_r, float(y.min())))


def _synthetic(s):
    if s.remat == "offload" or s.offload_opt:
        raise NotImplementedError("item 5c")
    m = s.mesh
    return 1.0 + abs(np.log2(max(1, m.dp)) - 1.0) \
        + abs(np.log2(max(1, m.fsdp)) - 2.0) + 0.5 * abs(s.grad_accum - 2) \
        + 0.5 * (s.remat != "dots") + 0.25 * np.log2(max(1, m.tp))


@pytest.mark.parametrize("seed,warm", [(0, False), (3, True)])
def test_bayes_search_visits_the_references_points_in_order(seed, warm):
    runs = []
    for pkg in (tss, jss):
        space = pkg.default_space(8)
        res = pkg.BayesStrategySearch(
            _synthetic, space, n_init=4, max_evals=14, seed=seed,
            warm_start=[space[7]] if warm else []).run()
        runs.append(([pkg.strategy_to_dict(s) for s, _ in res.evaluated],
                     [c for _, c in res.evaluated],
                     pkg.strategy_to_dict(res.best), res.best_cost))
    assert runs[0] == runs[1]
    assert any(np.isinf(c) for c in runs[0][1])


def test_cache_entries_cross_between_the_packages(tmp_path):
    path = str(tmp_path / "strategies.json")
    ref = jacc.Strategy(mesh=JMeshSpec(dp=2, fsdp=2), remat="dots",
                        grad_accum=4)
    jss.StrategyCache(path).put("k1", ref)
    got = tss.StrategyCache(path).get("k1")
    assert got is not None and tss.strategy_to_dict(got) == \
        jss.strategy_to_dict(ref)
    port = tacc.Strategy(mesh=MeshSpec(fsdp=4), remat="full")
    tss.StrategyCache(path).put("k2", port)
    back = jss.StrategyCache(path).get("k2")
    assert jss.strategy_to_dict(back) == tss.strategy_to_dict(port)
    with open(path) as f:
        raw = json.load(f)
    assert set(raw["k2"]) == set(raw["k1"])
    jss.StrategyCache(path).put("k3", jacc.Strategy(
        mesh=JMeshSpec(dp=2), compute_dtype=jnp.float32))
    assert tss.StrategyCache(path).get("k3") is None  # not honoured: a miss
    assert jss.StrategyCache(path).get("k3") is not None


def test_fingerprint_matches_the_reference_where_the_trees_agree(shapes):
    jshape, abstract, _ = shapes["tiny"]
    batch = {"tokens": np.zeros((4, 17), np.int32)}
    assert tss.fingerprint(abstract.params, batch, 2) == \
        jss.fingerprint(jshape, batch, 2)
    opt = jax.eval_shape(optax.adamw(1e-3).init, jshape)
    assert abstract.fingerprint(batch, 2) != \
        jss.fingerprint(jshape, batch, 2, opt)
    # The device count is part of the key: a rebuild at another world size
    # misses the cache.
    assert abstract.fingerprint(batch, 1) != abstract.fingerprint(batch, 2)


def test_master_strategy_cache_over_a_port_master():
    mst = LocalJobMaster(0, job_name="stratcache")
    mst.prepare()
    mc = MasterClient(mst.addr, 0)
    try:
        cache = tss.MasterStrategyCache(mc)
        assert cache.get("fp") is None
        s = tacc.Strategy(mesh=MeshSpec(dp=2), grad_accum=2)
        cache.put("fp", s)
        assert json.loads(mc.kv_store_get("strategy-cache/fp").decode()) \
            == tss.strategy_to_dict(s)
        assert tss.strategy_to_dict(cache.get("fp")) == \
            tss.strategy_to_dict(s)
    finally:
        mc.close()
        mst.stop()


# -- two processes -------------------------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    work = tmp_path_factory.mktemp("search")
    tokens = np.random.RandomState(2).randint(0, 256, (1, 4, 17)) \
        .astype(np.int32)
    np.savez(work / "batches.npz", tokens=tokens)
    mst = LocalJobMaster(0, job_name="searchworld")
    mst.prepare()
    try:
        cands = [dict(mesh={"dp": 2}), dict(mesh={"fsdp": 2}),
                 dict(mesh={"fsdp": 2}, remat="full"),
                 dict(mesh={"fsdp": 2}, remat="dots"),
                 dict(mesh={"fsdp": 2}, grad_accum=2),
                 dict(mesh={"tp": 2}, param_specs="planner"),
                 dict(mesh={"tp": 2})]
        plan = {"device": "cpu", "model": {}, "params": None, "jobs": [
            dict(name="search", kind="search",
                 batches=str(work / "batches.npz"), cache_dir=str(work),
                 master=mst.addr),
            dict(name="cost", kind="cost",
                 batches=str(work / "batches.npz"), candidates=cands)]}
        recs = child.spawn_world(2, plan, work / "out", timeout=150,
                                 script=_CHILD)
        mc = MasterClient(mst.addr, 9)
        try:
            fp = recs["search"][0]["master"]["search"]["fingerprint"]
            stored = mc.kv_store_get(f"strategy-cache/{fp}")
        finally:
            mc.close()
    finally:
        mst.stop()
    return recs, stored


def test_auto_agrees_on_the_leaders_scores_and_caches(world):
    recs, _ = world
    r0, r1 = recs["search"]
    assert r0["auto"]["search"]["scores"] == r1["auto"]["search"]["scores"]
    assert [s for s, _ in r0["auto"]["search"]["scores"]] == [
        "mesh=dp2 remat=none accum=1", "mesh=fsdp2 remat=none accum=1",
        "mesh=tp2 remat=none accum=1"]
    assert r0["auto"]["winner"] == r1["auto"]["winner"]
    assert r0["auto"]["builds"] == 3 and not r0["auto"]["search"][
        "cache_hit"]
    assert r0["auto_hit"]["builds"] == r1["auto_hit"]["builds"] == 1
    assert r0["auto_hit"]["search"]["cache_hit"]
    assert r0["auto_hit"]["winner"] == r0["auto"]["winner"]
    assert r0["auto"]["loss"] == r1["auto"]["loss"]


def test_bo_evaluates_the_same_points_with_the_leaders_times(world):
    recs, _ = world
    r0, r1 = (r["bo"] for r in recs["search"])
    assert r0["search"]["evaluated"] == r1["search"]["evaluated"]
    assert len(r0["search"]["evaluated"]) == 3
    assert r0["winner"] == r1["winner"]
    finite = [c for _, c in r0["search"]["evaluated"] if c != float("inf")]
    assert finite and r0["builds"] == r1["builds"]


def test_master_cache_holds_the_winner(world):
    recs, stored = world
    r0, r1 = recs["search"]
    assert stored is not None
    entry = json.loads(stored.decode())
    assert set(entry) == set(tss.strategy_to_dict(tacc.Strategy()))
    assert tss.strategy_from_dict(entry).describe() == \
        r0["master"]["winner"] == r1["master"]["winner"]
    assert r0["master_hit"]["builds"] == r1["master_hit"]["builds"] == 1
    assert r0["master_hit"]["search"]["cache_hit"]


@pytest.mark.parametrize("i", range(7))
def test_cost_model_bytes_equal_the_recorded_bytes(world, i):
    recs, _ = world
    for r in recs["cost"]:
        c = r["candidates"][i]
        assert c["cost"] == c["recorded"], c


def test_bo_beats_or_matches_the_cost_model_pick():
    """One process: the cost model's pick is BO's warm start; the timed
    search's best is never worse than the pick's own time."""
    def init_fn(gen):
        return {"w1": torch.randn(32, 64, generator=gen),
                "w2": torch.randn(64, 8, generator=gen)}

    def loss_fn(p, b):
        return ((torch.tanh(b["x"] @ p["w1"]) @ p["w2"] - b["y"]) ** 2) \
            .mean()

    rng = np.random.RandomState(0)
    batch = {"x": rng.randn(16, 32).astype(np.float32),
             "y": rng.randn(16, 8).astype(np.float32)}
    kw = dict(loss_fn=loss_fn, init_fn=init_fn, optimizer=adamw(0.1),
              sample_batch=batch, device="cpu")
    pick = tacc.accelerate(**kw, strategy="auto").strategy
    abstract = tacc._Abstract(init_fn, adamw(0.1), torch.device("cpu"))
    timed = {}

    def objective(s):
        job = tacc._build_job(s, grad_accum=None, loss_fn_builder=None,
                              param_specs=None, batch_axes=None, **kw)
        timed[s.describe()] = t = tacc._score(job, 2, abstract)
        return t

    res = tss.BayesStrategySearch(
        objective, tss.default_space(1, accum=(1, 2)), n_init=2,
        max_evals=6, warm_start=[pick]).run()
    assert pick.describe() in timed
    assert res.best_cost <= timed[pick.describe()]
