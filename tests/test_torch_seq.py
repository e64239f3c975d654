"""The port's ring and Ulysses attention against the reference's.

The reference (``dlrover_tpu/parallel/ring_attention.py`` ``ring_attention``
and ``dlrover_tpu/parallel/sequence.py`` ``ulysses_attention``, a
``shard_map`` over the conftest's host devices with the inputs placed by
``NamedSharding(P(None, "tp", None, None))``) and the port
(``dlrover_tpu_torch/parallel/ring_attention.py``, ``.../sequence.py``:
this rank's blocks; at ``n = 1`` in this process, at ``n = 2`` (a ``dp2 x
tp2`` mesh) and ``n = 4`` (``tp4``) in four ``gloo`` children, one spawn
for the module: ``tests/torch_seq_child.py``) take the same q, k, v and
cotangent ``ct`` [2, 16, 4, 8] (numpy, seed 0), causal and not, in fp32
and in bf16.  Each compares the output and the gradients of
``sum(out * ct)`` with respect to q, k and v, the port's gradients going
through the ring hop's and the all-to-all's backward.

Tolerances (absolute): fp32 ring ``RING_ATOL`` = 1e-4 and Ulysses
``ULYSSES_ATOL`` = 1e-5 on the outputs (the reference's own tests', against
``_attn_core``), and ``GRAD_ATOL`` = 1e-4 on the gradients.  bf16:
``BF16_ULPS`` = 2 bf16 ulps of the reference's value plus ``BF16_FLOOR`` =
1e-2 x max|ref|: the ring computes in fp32 from bf16 inputs and rounds once
(equal up to that rounding), while Ulysses' core multiplies in bf16 as the
reference's ``einsum`` does, and the two libraries' bf16 products may round
a sum of cancelling terms differently.  The GQA repeat
(``repeat_interleave``) and the refusals of a sliding window and of packed
sequences on these paths are held against the reference's texts.  Where
the port parts from the reference, a loss that would cut the sequence over
a ``tp`` axis that is not its job's sequence axis raises (see
``tests/test_torch_seq_train.py`` for the jobs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.parallel import ring_attention as jring
from dlrover_tpu.parallel import sequence as jseq
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.parallel import ring_attention as tring
from dlrover_tpu_torch.parallel import sequence as tseq
from dlrover_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    claim_sequence,
    stepping,
)

import torch_mesh_child as child

B, S, H, D = 2, 16, 4, 8
RING_ATOL = 1e-4
ULYSSES_ATOL = 1e-5
GRAD_ATOL = 1e-4
BF16_ULPS = 2
BF16_FLOOR = 1e-2
NS = (1, 2, 4)
CASES = [(impl, n, causal, dt) for impl in ("ring", "ulysses") for n in NS
         for causal in (True, False) for dt in ("float32", "bfloat16")]
IDS = [f"{i}-n{n}-{'causal' if c else 'full'}-{d}" for i, n, c, d in CASES]
MESHES = {2: {"dp": 2, "tp": 2}, 4: {"tp": 4}}


def _inputs():
    rng = np.random.RandomState(0)
    return {k: rng.randn(B, S, H, D).astype(np.float32)
            for k in ("q", "k", "v", "ct")}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def reference(inputs, cpu_mesh_devices):
    """Each case's (out, dq, dk, dv) from the reference, fp32 numpy: the
    cases of one ``n`` in one ``jax.jit`` program."""
    out = {}
    for n in NS:
        mesh = JMesh(np.array(cpu_mesh_devices[:n]), ("tp",))
        sh = NamedSharding(mesh, P(None, "tp", None, None))
        cases = [c for c in CASES if c[1] == n]

        def all_cases(q, k, v, ct, mesh=mesh, cases=cases):
            res = []
            for impl, _, causal, dt in cases:
                fn = jring.ring_attention if impl == "ring" \
                    else jseq.ulysses_attention
                jd = getattr(jnp, dt)
                c = ct.astype(jd).astype(jnp.float32)

                def f(q, k, v, fn=fn, causal=causal, c=c):
                    o = fn(q, k, v, mesh, causal=causal)
                    return jnp.sum(o.astype(jnp.float32) * c), o

                (_, o), g = jax.value_and_grad(f, argnums=(0, 1, 2),
                                               has_aux=True)(
                    q.astype(jd), k.astype(jd), v.astype(jd))
                res.append([x.astype(jnp.float32) for x in (o,) + g])
            return res

        args = [jax.device_put(jnp.asarray(inputs[x]), sh)
                for x in ("q", "k", "v", "ct")]
        for case, arrs in zip(cases, jax.jit(all_cases)(*args)):
            out[case] = [np.asarray(a) for a in arrs]
    return out


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """The port's n = 2 and n = 4 cases in one world of four children:
    each rank's blocks, reassembled into [B, S, H, D]."""
    work = tmp_path_factory.mktemp("seq")
    np.savez(work / "inputs.npz", **inputs)
    jobs = [dict(name=f"{impl}-{n}-{int(causal)}-{dt}", kind="attn",
                 mesh=MESHES[n], impl=impl, causal=causal, dtype=dt,
                 inputs=str(work / "inputs.npz"))
            for impl, n, causal, dt in CASES if n > 1]
    recs = child.spawn_world(4, {"device": "cpu", "model": None,
                                 "jobs": jobs}, work / "out",
                             timeout=120, script=_CHILD)
    got = {}
    for job in jobs:
        n = 2 if job["mesh"] == MESHES[2] else 4
        dp = job["mesh"].get("dp", 1)
        full = [np.zeros((B, S, H, D), np.float32) for _ in range(4)]
        for r, rec in enumerate(recs[job["name"]]):
            assert rec["backend"] == "gloo"
            idp, i = divmod(r, n)  # build_mesh's row-major layout
            arrs = np.load(work / "out" / f"{job['name']}.rank{r}.npz")
            rows = slice(idp * B // dp, (idp + 1) * B // dp)
            cols = slice(i * S // n, (i + 1) * S // n)
            for a, key in zip(full, ("out", "dq", "dk", "dv")):
                a[rows, cols] = arrs[key]
        got[job["impl"], n, job["causal"], job["dtype"]] = (
            full, recs[job["name"]][0]["comm"])
    return got


_CHILD = child.REPO / "tests" / "torch_seq_child.py"


def _port_one_block(inputs, impl, causal, dt):
    """n = 1: the port's own one-block path, in this process."""
    mesh = Mesh(MeshSpec(), np.arange(1), 0)
    td = getattr(torch, dt)
    q, k, v = (torch.from_numpy(inputs[x]).to(td).requires_grad_(True)
               for x in ("q", "k", "v"))
    fn = tring.ring_attention if impl == "ring" else tseq.ulysses_attention
    o = fn(q, k, v, mesh, causal=causal)
    (o.float() * torch.from_numpy(inputs["ct"]).to(td).float()).sum() \
        .backward()
    return [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]


def _check(got, want, impl, dt, what):
    if dt == "float32":
        tol = (RING_ATOL if impl == "ring" else ULYSSES_ATOL) \
            if what == "out" else GRAD_ATOL
        err = np.abs(got - want).max()
        assert err <= tol, (what, err, tol)
        return err
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    lim = BF16_ULPS * ulp + BF16_FLOOR * np.abs(want).max()
    bad = np.abs(got - want) > lim
    assert not bad.any(), (what, np.abs(got - want)[bad][:5],
                           want[bad][:5])
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("impl,n,causal,dt", CASES, ids=IDS)
def test_attention_matches_the_reference(impl, n, causal, dt, inputs,
                                         reference, world):
    want = reference[impl, n, causal, dt]
    if n == 1:
        got = _port_one_block(inputs, impl, causal, dt)
    else:
        got, comm = world[impl, n, causal, dt]
        kind = "ring_hop" if impl == "ring" else "all_to_all"
        # Forward and backward each: n - 1 hops, or four all-to-alls.
        calls = 2 * (n - 1) if impl == "ring" else 8
        assert comm[kind]["calls"] == calls, comm
        size = 2 if dt == "bfloat16" else 4
        per_rank = (B // MESHES[n].get("dp", 1)) * (S // n) * H * D * size
        want_bytes = 2 * (n - 1) * 2 * per_rank if impl == "ring" \
            else 8 * per_rank
        assert comm[kind]["bytes"] == want_bytes, comm
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        _check(g, w, impl, dt, what)


def test_the_fp32_ring_matches_the_attention_core(inputs):
    """The reference's own check at n = 1: the ring's one block equals
    ``_attn_core`` (the port's) within the ring's tolerance."""
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    mesh = Mesh(MeshSpec(), np.arange(1), 0)
    ring = tring.ring_attention(t["q"], t["k"], t["v"], mesh)
    core = tseq._attn_core(t["q"], t["k"], t["v"], True)
    assert float((ring - core).abs().max()) <= RING_ATOL


# -- the model's dispatch -----------------------------------------------------

def _tiny(**over):
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, **over)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, **over)
    params = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, tcfg, params, params_from_numpy(
        tree, tcfg, device="cpu", param_dtype=torch.float32)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gqa_repeats_kv_heads_as_the_reference(impl, cpu_mesh_devices):
    """``n_kv_head`` 2 of 4 heads: the K/V heads are repeated
    (``repeat_interleave``, the reference's ``jnp.repeat``) before the
    one-block path; the loss equals the reference's through its own mesh
    of one device."""
    jcfg, tcfg, jp, tp = _tiny(n_head=4, n_kv_head=2)
    tokens = np.random.RandomState(3).randint(0, 256, (2, 17)) \
        .astype(np.int32)
    jmesh = JMesh(np.array(cpu_mesh_devices[:1]).reshape(1, 1),
                  ("dp", "tp"))
    with jmesh:
        want = float(jax.jit(lambda p, t: jllama.loss_fn(
            p, {"tokens": t}, jcfg, attn_impl=impl, mesh=jmesh,
            moe_aux_weight=0.0))(jp, tokens))
    got = float(tllama.loss_fn(tp, {"tokens": torch.from_numpy(tokens)},
                               tcfg, attn_impl=impl,
                               mesh=Mesh(MeshSpec(), np.arange(1), 0)))
    assert abs(got - want) <= 2e-5 * abs(want), (got, want)
    x = np.random.RandomState(4).randn(1, 4, 2, 3).astype(np.float32)
    assert np.array_equal(
        torch.repeat_interleave(torch.from_numpy(x), 2, dim=2).numpy(),
        np.asarray(jnp.repeat(jnp.asarray(x), 2, axis=2)))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_window_and_segments_are_refused_with_the_references_texts(impl):
    jcfg, tcfg, jp, tp = _tiny(sliding_window=4)
    mesh = Mesh(MeshSpec(), np.arange(1), 0)
    tokens = np.zeros((1, 9), np.int32)
    for fn, p, cfg, toks, m in (
            (jllama.loss_fn, jp, jcfg, jnp.asarray(tokens), None),
            (tllama.loss_fn, tp, tcfg, torch.from_numpy(tokens), mesh)):
        with pytest.raises(NotImplementedError,
                           match="sliding_window requires the flash"):
            fn(p, {"tokens": toks}, cfg, attn_impl=impl, mesh=m)
    jcfg, tcfg, jp, tp = _tiny()
    seg = np.zeros((1, 9), np.int32)
    jmesh = Mesh(MeshSpec(), np.arange(1), 0)
    with pytest.raises(NotImplementedError) as e:
        tllama.loss_fn(tp, {"tokens": torch.from_numpy(tokens),
                            "segment_ids": torch.from_numpy(seg)},
                       tcfg, attn_impl=impl, mesh=jmesh)
    assert str(e.value) == ("packed sequences (segment_ids) require the "
                            f"flash attention path, not {impl}")


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_a_cut_over_tp_without_the_sequence_axis_raises(impl):
    """The reference's ``loss_fn(attn_impl=impl, mesh=<tp2 mesh>)``: here
    the mesh must name ``tp`` its sequence axis, or the loss would cut
    positions that no reduction puts back together."""
    _, tcfg, _, tp = _tiny()
    tokens = torch.zeros((1, 9), dtype=torch.int64)
    mesh = Mesh(MeshSpec(tp=2), np.arange(2), 0)
    with pytest.raises(ValueError, match="tp is not the mesh's sequence"):
        tllama.loss_fn(tp, {"tokens": tokens}, tcfg, attn_impl=impl,
                       mesh=mesh)
    # A one-rank tp axis cuts nothing: the one-block path, mark or not.
    one = Mesh(MeshSpec(), np.arange(1), 0)
    assert np.isfinite(float(tllama.loss_fn(
        tp, {"tokens": tokens}, tcfg, attn_impl=impl, mesh=one)))


def test_a_step_claims_the_sequence_only_on_its_own_mesh():
    plain = Mesh(MeshSpec(tp=2), np.arange(2), 0)
    seq = plain.sequence("tp")
    assert seq.seq_axis == "tp" and plain.seq_axis is None
    assert seq.same_as(Mesh(MeshSpec(tp=2), np.arange(2), 0, None, "tp"))
    assert plain.sequence(None) is plain and not seq.same_as(plain)
    with pytest.raises(ValueError, match="sequence axis must be 'tp'"):
        plain.sequence("dp")
    claim_sequence(seq, "ring")  # outside a step: the mark is enough
    with stepping(seq) as step:
        assert not step["cut"]
        claim_sequence(seq, "ring")
        assert step["cut"]
    for other in (plain, None, Mesh(MeshSpec(dp=2), np.arange(2), 0)):
        with stepping(other), pytest.raises(
                ValueError, match="runs only on its own job's mesh"):
            claim_sequence(seq, "ring")
    with pytest.raises(ValueError, match="not the mesh's sequence axis"):
        claim_sequence(plain, "ring")
