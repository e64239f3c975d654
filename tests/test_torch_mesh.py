"""The port's mesh, rules, ZeRO-3 specs, layout planner and boxes against
the JAX package's (``dlrover_tpu/parallel/{mesh,sharding,layout_planner,
accelerate}.py``), exactly.

Shapes only: the reference's parameter trees come from ``jax.eval_shape``
of ``init_params`` (tiny, 300M, 800M, 7B), the port's are ``meta`` tensors
of the same shapes.  Meshes: ``fsdp`` 2/4/8, ``dp2 x fsdp2``,
``fsdp2 x tp2`` and ``tp4``.  A port spec equals the reference's
element for element; each rank's box of a leaf equals the index the
reference's ``NamedSharding`` gives device ``r`` of ``jax.devices()`` (the
conftest's eight host devices), and its owners the devices that hold the
same index.  A hypothesis property holds ``logical_to_spec`` over random
rule tables.  No tolerance: everything is exact.
"""

import importlib

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import NamedSharding as JNamedSharding

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import layout_planner as jplan
from dlrover_tpu.parallel import mesh as jmesh
from dlrover_tpu.parallel import sharding as jsharding
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.parallel import layout_planner as tplan
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import sharding as tsharding

jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")

MODELS = ("tiny", "small_300m", "medium_800m", "llama2_7b")
MESHES = {
    "fsdp2": dict(fsdp=2), "fsdp4": dict(fsdp=4), "fsdp8": dict(fsdp=8),
    "dp2xfsdp2": dict(dp=2, fsdp=2), "fsdp2xtp2": dict(fsdp=2, tp=2),
    "tp4": dict(tp=4),
}


@pytest.fixture(scope="module")
def shapes():
    """name -> (reference ShapeDtypeStruct tree, port meta-tensor tree)."""
    out = {}
    for name in MODELS:
        jcfg = getattr(jllama.LlamaConfig, name)()
        ref = jax.eval_shape(lambda k, c=jcfg: jllama.init_params(k, c),
                             jax.random.PRNGKey(0))
        port = jax.tree_util.tree_map(
            lambda s: torch.empty(s.shape, dtype=torch.float32,
                                  device="meta"), ref)
        out[name] = (ref, port)
    return out


def _spec_leaves_ref(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _spec_leaves_port(tree):
    return [s for _, s in tplan.flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, tsharding.PartitionSpec))]


def _same_specs(port_tree, ref_tree):
    got = [tuple(s) for s in _spec_leaves_port(port_tree)]
    want = [tuple(s) for s in _spec_leaves_ref(ref_tree)]
    assert got == want


# -- MeshSpec ----------------------------------------------------------------

@pytest.mark.parametrize("sizes,n", [
    (dict(), 1), (dict(fsdp=-1), 8), (dict(dp=2, fsdp=-1), 8),
    (dict(fsdp=2, tp=-1), 8), (dict(tp=4), 4), (dict(dp=-1, tp=2), 6),
    (dict(fsdp=3), 8), (dict(fsdp=-1, tp=3), 8), (dict(dp=2), 4),
    (dict(pp=2, dp=-1), 4),
])
def test_meshspec_normalizes_and_describes_as_the_reference(sizes, n):
    ref, port = jmesh.MeshSpec(**sizes), tmesh.MeshSpec(**sizes)
    assert port.sizes == ref.sizes and port.axis_names() == ref.axis_names()
    try:
        want = ref.normalized(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            port.normalized(n)
        return
    got = port.normalized(n)
    assert got.sizes == want.sizes and got.num_devices == want.num_devices
    assert got.describe() == want.describe()
    assert tmesh.AXIS_ORDER == jmesh.AXIS_ORDER


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12, 16])
@pytest.mark.parametrize("kw", [{}, {"allow_pp": True},
                                {"allow_ep": True, "max_tp": 4}],
                         ids=["plain", "pp", "ep_tp4"])
def test_candidate_specs_are_the_references(n, kw):
    assert [s.sizes for s in tmesh.candidate_specs(n, **kw)] == \
        [s.sizes for s in jmesh.candidate_specs(n, **kw)]
    assert tmesh._divisors(n) == jmesh._divisors(n)


# -- rules -------------------------------------------------------------------

RULE_VARIANTS = {
    "default": None,
    "fsdp_tp": {"embed": ("fsdp", "tp"), "mlp": None},
    "dp_vocab": {"vocab": ("dp", "tp"), "heads": "fsdp"},
}


@pytest.mark.parametrize("rules", list(RULE_VARIANTS), ids=str)
@pytest.mark.parametrize("model", MODELS)
def test_llama_logical_axes_map_to_the_references_specs(model, rules):
    jcfg = getattr(jllama.LlamaConfig, model)()
    tcfg = getattr(tllama.LlamaConfig, model)()
    jax_axes = jllama.param_logical_axes(jcfg)
    assert tllama.param_logical_axes(tcfg) == jax_axes
    r = RULE_VARIANTS[rules]
    _same_specs(tsharding.tree_logical_to_specs(
        tllama.param_logical_axes(tcfg), r),
        jsharding.tree_logical_to_specs(jax_axes, r))
    assert tsharding.DEFAULT_RULES == jsharding.DEFAULT_RULES


_AXES = st.sampled_from(["dp", "fsdp", "tp", "ep", "pp"])
_RULE = st.one_of(st.none(), _AXES,
                  st.lists(_AXES, min_size=1, max_size=3).map(tuple))
_NAMES = ["batch", "seq", "embed", "heads", "kv", "mlp", "vocab", "layers",
          "expert", "expert_mlp", "custom"]


@settings(max_examples=200, deadline=None)
@given(rules=st.dictionaries(st.sampled_from(_NAMES), _RULE, max_size=6),
       axes=st.lists(st.one_of(st.none(), st.sampled_from(_NAMES)),
                     max_size=5))
def test_logical_to_spec_matches_the_reference_on_any_rule_table(rules,
                                                                  axes):
    want = jsharding.logical_to_spec(axes, rules)
    got = tsharding.logical_to_spec(axes, rules)
    assert tuple(got) == tuple(want)
    assert got == tsharding.PartitionSpec(*want)


def test_partition_spec_compares_as_the_references():
    P, JP = tsharding.PartitionSpec, jax.sharding.PartitionSpec
    for a, b in ((("a", None), ("a",)), ((("a",),), ("a",)),
                 ((("a", "b"),), (("a", "b"), None)), ((), (None,))):
        assert (P(*a) == P(*b)) == (JP(*a) == JP(*b)), (a, b)
        assert tuple(P(*a)) == tuple(JP(*a))
    with pytest.raises(NotImplementedError, match="item 5d"):
        tsharding.constraint(torch.zeros(1), ("batch",))


# -- ZeRO-3 and the planner --------------------------------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", MODELS)
def test_infer_param_specs_is_the_references(shapes, model, mesh):
    ref, port = shapes[model]
    spec = MESHES[mesh]
    _same_specs(tacc.infer_param_specs(port, tmesh.MeshSpec(**spec)),
                jacc.infer_param_specs(ref, jmesh.MeshSpec(**spec)))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("model", MODELS)
def test_plan_layout_report_and_validation_are_the_references(shapes, model,
                                                              mesh):
    ref, port = shapes[model]
    sizes = MESHES[mesh]
    axis_sizes = {"fsdp": sizes.get("fsdp", 1), "tp": sizes.get("tp", 1)}
    jspecs = jplan.plan_layout(ref, axis_sizes)
    tspecs = tplan.plan_layout(port, axis_sizes)
    _same_specs(tspecs, jspecs)
    want = jplan.plan_report(ref, jspecs, axis_sizes)
    got = tplan.plan_report(port, tspecs, axis_sizes)
    assert [(g.path, g.shape, tuple(g.spec), g.bytes_total,
             g.bytes_per_device) for g in got] == \
        [(w.path, w.shape, tuple(w.spec), w.bytes_total, w.bytes_per_device)
         for w in want]
    tplan.validate_layout(port, tspecs, axis_sizes)
    jplan.validate_layout(ref, jspecs, axis_sizes)
    # An axis the mesh lacks and an indivisible dim raise alike.
    bad = jax.tree_util.tree_map(lambda _: jax.sharding.PartitionSpec("x"),
                                 ref)
    tbad = tsharding.tree_map(lambda _: tsharding.PartitionSpec("x"), port)
    with pytest.raises(ValueError, match="unknown mesh axis 'x'"):
        jplan.validate_layout(ref, bad, axis_sizes)
    with pytest.raises(ValueError, match="unknown mesh axis 'x'"):
        tplan.validate_layout(port, tbad, axis_sizes)


@pytest.mark.parametrize("kw", [{}, {"min_shard_bytes": 0},
                                {"tp_axes": ("fsdp",)}],
                         ids=["default", "no_floor", "fsdp_last"])
def test_plan_layout_options_are_the_references(shapes, kw):
    ref, port = shapes["tiny"]
    sizes = {"fsdp": 2, "tp": 2}
    _same_specs(tplan.plan_layout(port, sizes, **kw),
                jplan.plan_layout(ref, sizes, **kw))


# -- boxes -------------------------------------------------------------------

def _ref_mesh(sizes):
    spec = jmesh.MeshSpec(**sizes)
    return jmesh.build_mesh(spec, jax.devices()[:spec.num_devices])


def _port_mesh(sizes, rank):
    spec = tmesh.MeshSpec(**sizes)
    return tmesh.Mesh(spec, np.arange(spec.num_devices), rank)


def _norm(idx, shape):
    return tuple((0 if s.start is None else s.start,
                  d if s.stop is None else s.stop)
                 for s, d in zip(idx, shape))


@pytest.mark.parametrize("planner", [False, True], ids=["zero3", "planner"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_ranks_box_is_the_references_shard(shapes, mesh, planner):
    """Rank r's box (and the ranks that hold it) of every leaf of the 800M
    tree equals device r's index (and the devices with the same index)
    under the reference's NamedSharding of the same spec."""
    ref, port = shapes["medium_800m"]
    sizes = MESHES[mesh]
    if planner:
        axis = {"fsdp": sizes.get("fsdp", 1), "tp": sizes.get("tp", 1)}
        jspecs = jplan.plan_layout(ref, axis)
    else:
        jspecs = jacc.infer_param_specs(ref, jmesh.MeshSpec(**sizes))
    jm = _ref_mesh(sizes)
    devs = list(jm.devices.reshape(-1))
    n = len(devs)
    leaves = jax.tree_util.tree_leaves(ref)
    specs = _spec_leaves_ref(jspecs)
    meshes = [_port_mesh(sizes, r) for r in range(n)]
    for leaf, spec in zip(leaves, specs):
        imap = JNamedSharding(jm, spec).devices_indices_map(leaf.shape)
        boxes = {d: _norm(imap[d], leaf.shape) for d in devs}
        for r in range(n):
            pl = tsharding.Placement(meshes[r], tsharding.PartitionSpec(
                *spec), tuple(leaf.shape))
            assert pl.box() == boxes[devs[r]]
            assert pl.owners() == [i for i in range(n)
                                   if boxes[devs[i]] == boxes[devs[r]]]
            assert pl.replicas == len(pl.owners())


def test_mesh_members_follow_the_row_major_order():
    """Ranks of a group over axes listed in another order than the
    canonical one come in that order's row-major order."""
    m = _port_mesh(dict(dp=2, fsdp=2, tp=2), 5)
    assert m.coords == {"pp": 0, "dp": 1, "fsdp": 0, "ep": 0, "tp": 1}
    assert m.members(["fsdp"]) == [5, 7]
    assert m.members(["dp", "fsdp"]) == [1, 3, 5, 7]
    assert m.members(["fsdp", "dp"]) == [1, 5, 3, 7]
    assert m.index_on(["dp", "fsdp"]) == 2
    assert tmesh.batch_share(m.spec, 5) == (2, 4)
    assert tmesh.batch_share(m.spec, 4) == (2, 4)


def test_a_mesh_the_world_cannot_cover_raises():
    """Without a process group the world is one process: a mesh of more
    raises, as do the axes the port does not run yet."""
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.build_mesh(tmesh.MeshSpec(fsdp=2))
    with pytest.raises(NotImplementedError, match="item 5d"):
        tmesh.build_mesh(tmesh.MeshSpec(), devices=["cpu", "cpu"])
    assert tmesh.build_mesh(tmesh.MeshSpec(fsdp=-1)).spec.sizes == \
        (1, 1, 1, 1, 1)
    with pytest.raises(NotImplementedError, match="pipeline"):
        tmesh.check_axes(tmesh.MeshSpec(pp=2))
    with pytest.raises(NotImplementedError, match="item 6"):
        tmesh.check_axes(tmesh.MeshSpec(ep=2))
    with pytest.raises(NotImplementedError, match="item 5d"):
        tacc.resolve_mesh(tmesh.MeshSpec(fsdp=2), 1)
    hyb = tmesh.build_hybrid_mesh(tmesh.MeshSpec(), slice_of=lambda r: 0)
    assert hyb.size == 1
    with pytest.raises(ValueError, match="prefix"):
        tmesh.build_hybrid_mesh(tmesh.MeshSpec(), dcn_axes=("tp",))


@pytest.mark.parametrize("sizes,dcn", [
    (dict(dp=2, fsdp=4), ("pp", "dp")), (dict(dp=4, fsdp=2), ("pp", "dp")),
    (dict(dp=2, fsdp=2, tp=2), ("pp", "dp", "fsdp"))])
def test_hybrid_layout_puts_ranks_where_the_reference_puts_devices(sizes,
                                                                     dcn):
    """Over eight devices in interleaved "slices" (an explicit
    ``slice_of``), the reference's hybrid mesh holds device ``i`` where
    the port's hybrid layout holds rank ``i`` (ranks on the same nodes)."""
    devs = jax.devices()[:8]
    slices = dcn and int(np.prod([sizes.get(a, 1) for a in dcn]))
    node = [(i * 7) % slices for i in range(8)]
    jm = jmesh.build_hybrid_mesh(jmesh.MeshSpec(**sizes), devs,
                                 dcn_axes=dcn,
                                 slice_of=lambda d: node[devs.index(d)])
    want = np.vectorize(lambda d: devs.index(d))(jm.devices)
    got = tmesh.hybrid_layout(tmesh.MeshSpec(**sizes), node, dcn)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="slices"):
        tmesh.hybrid_layout(tmesh.MeshSpec(**sizes), [0] * 8, dcn)
