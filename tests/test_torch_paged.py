"""The port's paged KV (``dlrover_tpu_torch/models/llama_infer.py``
``PagedKvArena``, ``init_paged_pool``, the ``_paged_*`` views and the paged
``DecodeServer``) against the JAX package's ``dlrover_tpu/models/
llama_infer.py``, mirroring ``tests/test_llama_infer.py``'s ``TestPagedKv``.

The law: the block pool is invisible to greedy decode.  A paged server
emits exactly what the slotted one does (plain, chunked, int8 cache), a
pool too tight for every request preempts the youngest and still emits the
same tokens, and every run leaves ``free + used == n_blocks``.  The JAX
side runs under ``jax.jit`` (its server jits its programs; the view
helpers are jitted here).  Both sides take the same fp32 parameters
(``LlamaConfig.tiny(n_layer=2)`` carried across by ``params_from_numpy``).

Tolerances: none; views, scatters and tokens are compared for equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy

BS = 8
BASE = dict(slots=2, max_len=48, prompt_buckets=(8, 16), seed=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(n_layer=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layer=2, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


def _prompts(lens, seed=7):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, n).astype(np.int32) for n in lens]


def _server(tp, tcfg, paged, **kw):
    return tinfer.DecodeServer(tp, tcfg, paged=paged, block_size=BS,
                               **dict(BASE, **kw))


# -- the view helpers ----------------------------------------------------------

@pytest.fixture(scope="module")
def pool():
    """A 5-block pool (+ scratch) of two layers, int8 codes and scales in
    one and fp32 k/v in the other, filled with distinct values."""
    rng = np.random.RandomState(0)
    layers = [
        {"k": rng.randint(-127, 128, (6, 2, 4, 3)).astype(np.int8),
         "ks": rng.rand(6, 2, 4).astype(np.float32)},
        {"k": rng.randn(6, 2, 4, 3).astype(np.float32),
         "v": rng.randn(6, 2, 4, 3).astype(np.float32)},
    ]
    return layers


def _torch_layers(layers):
    return [{k: torch.from_numpy(v.copy()) for k, v in lay.items()}
            for lay in layers]


def _jax_layers(layers):
    return [{k: jnp.asarray(v) for k, v in lay.items()} for lay in layers]


def _same(tl, jl):
    for t, j in zip(tl, jl):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))


def test_views_and_scatters_match_jax(pool):
    """Gather, the block split and both scatters, through tables whose
    entries repeat the scratch block (row 5) as unassigned entries do."""
    table = np.array([[2, 0, 5], [4, 5, 5]], np.int32)
    tpool, jpool = _torch_layers(pool), _jax_layers(pool)
    tt = torch.from_numpy(table).long()
    dense_t = tinfer._paged_dense_view(tpool, tt)
    dense_j = jax.jit(jinfer._paged_dense_view)(jpool, jnp.asarray(table))
    _same(dense_t, dense_j)
    assert tuple(dense_t[1]["k"].shape) == (2, 2, 12, 3)
    rows_t = tinfer._paged_row_view(tpool, tt[0])
    rows_j = jax.jit(jinfer._paged_row_view)(jpool, jnp.asarray(table[0]))
    _same(rows_t, rows_j)

    # New values everywhere a slot owns a block; the scratch entries get
    # whatever the view held there (any write wins on either side, and
    # the scratch row is never read unmasked), so the scratch row is left
    # out of the comparison.
    rng = np.random.RandomState(1)
    for lay in dense_t:
        for k, v in lay.items():
            v.copy_(torch.from_numpy(
                (rng.rand(*v.shape) * 100).astype(v.numpy().dtype)))
    new_j = [{k: jnp.asarray(v.numpy()) for k, v in lay.items()}
             for lay in dense_t]
    out_t = tinfer._paged_scatter_back(tpool, dense_t, tt)
    assert out_t is tpool  # written in place
    out_j = jax.jit(jinfer._paged_scatter_back)(jpool, new_j,
                                                jnp.asarray(table))
    _same([{k: v[:5] for k, v in lay.items()} for lay in out_t],
          [{k: v[:5] for k, v in lay.items()} for lay in out_j])

    tpool, jpool = _torch_layers(pool), _jax_layers(pool)
    rows = [{k: v * 0 + 7 for k, v in lay.items()} for lay in rows_t]
    tinfer._paged_row_scatter(tpool, rows, tt[1])
    out_j = jax.jit(jinfer._paged_row_scatter)(
        jpool, [{k: jnp.asarray(v.numpy()) for k, v in lay.items()}
                for lay in rows], jnp.asarray(table[1]))
    _same(tpool, out_j)
    x = torch.arange(2 * 12 * 3).reshape(2, 12, 3)
    np.testing.assert_array_equal(
        tinfer._paged_block_split(x, 3, 4).numpy(),
        np.asarray(jinfer._paged_block_split(jnp.asarray(x.numpy()), 3, 4)))


@pytest.mark.parametrize("quant_kv", [False, True])
def test_init_paged_pool_matches_jax(model, quant_kv):
    jcfg, _, tcfg, _ = model
    jp = jinfer.init_paged_pool(jcfg, 5, BS, quant_kv=quant_kv)
    tpl = tinfer.init_paged_pool(tcfg, 5, BS, quant_kv=quant_kv,
                                 device="cpu")
    assert len(tpl["layers"]) == len(jp["layers"]) == 2
    for t, j in zip(tpl["layers"], jp["layers"]):
        assert sorted(t) == sorted(j)
        for k in t:
            assert tuple(t[k].shape) == j[k].shape
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype)
            assert not bool(t[k].any())
    assert tuple(tpl["layers"][0]["k"].shape) == (6, tcfg.n_kv_head, BS,
                                                   tcfg.head_dim)


# -- the arena -------------------------------------------------------------------

OPS = st.lists(st.tuples(
    st.sampled_from(["alloc", "free", "share", "hold", "release",
                     "scavenge"]),
    st.integers(0, 2), st.integers(0, 40)), max_size=40)


@settings(max_examples=60, deadline=None)
@given(ops=OPS)
def test_arena_conserves_blocks_like_jax(ops):
    """Random alloc, share, hold, release and free: ``free + used ==
    n_blocks`` after every operation, and the port's arena keeps the same
    table, lengths, refcounts and free list as the reference's."""
    arenas = [tinfer.PagedKvArena(10, 4, 3, 32),
              jinfer.PagedKvArena(10, 4, 3, 32)]
    held: list = []
    for op, s, n in ops:
        results = []
        for a in arenas:
            if op == "alloc":
                results.append(a.alloc_upto(s, n))
            elif op == "free":
                a.free_slot(s)
            elif op == "share":
                if a.lens[s] == 0 and held:
                    a.share(s, held[-1])
            elif op == "hold":
                results.append(a.hold(n % 4))
            elif op == "release":
                if held:
                    a.release(held[-1])
            else:
                results.append(a.scavenge())
            assert a.conserved()
            assert a.free_blocks + a.used_blocks == a.n_blocks
        assert results[:len(results) // 2] == results[len(results) // 2:]
        if op == "hold" and results[0]:
            held.append(results[0])
        elif op == "release" and held:
            held.pop()
        t, j = arenas
        np.testing.assert_array_equal(t.table, j.table)
        np.testing.assert_array_equal(t.lens, j.lens)
        np.testing.assert_array_equal(t.ref, j.ref)
        assert t._free == j._free
        assert t.table_tokens() == j.table_tokens()


# -- the paged server --------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"decode_chunk": 3},
                                {"quant_kv": True}],
                         ids=["plain", "chunked", "quant_kv"])
def test_paged_equals_slotted_byte_for_byte(model, kw):
    """Mixed lengths (one scored in chunks), more requests than slots; at
    the end every block is back on the free list."""
    _, _, tcfg, tp = model
    prompts = _prompts([5, 13, 22, 9])
    ref = _server(tp, tcfg, False, **kw).serve(prompts, 8)
    srv = _server(tp, tcfg, True, **kw)
    out = srv.serve(prompts, 8)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    arena = srv.kv_arena
    assert arena.conserved() and arena.free_blocks == arena.n_blocks
    assert srv.last_stats["paged"] and srv.last_stats["peak_blocks"] > 0


def test_tight_pool_preempts_like_jax(model):
    """A pool too small for every admitted request to grow to its full
    length preempts the youngest and re-decodes: the outputs equal the
    slotted server's and the reference's, the preemptions the reference's,
    and the token stream never repeats a delivered token."""
    jcfg, jp, tcfg, tp = model
    kw = dict(BASE, slots=3, pool_blocks=6)
    prompts = _prompts([10, 9, 8], seed=9)
    ref_srv = jinfer.DecodeServer(jp, jcfg, paged=True, block_size=BS, **kw)
    ref = ref_srv.serve(prompts, max_new_tokens=8)
    slotted = _server(tp, tcfg, False, slots=3).serve(prompts, 8)
    srv = _server(tp, tcfg, True, slots=3, pool_blocks=6)
    streamed: dict = {}
    out = srv.serve(prompts, 8, on_token=lambda r, t: streamed
                    .setdefault(r, []).append(t))
    assert srv.preemptions == ref_srv.preemptions > 0
    for i, (o, r, s) in enumerate(zip(out, ref, slotted)):
        np.testing.assert_array_equal(o, np.asarray(r))
        np.testing.assert_array_equal(o, s)
        assert streamed[i] == list(o[len(prompts[i]):])
    for key in ("rounds", "emitted_tokens", "preemptions", "total_blocks",
                "free_blocks"):
        assert srv.last_stats[key] == ref_srv.last_stats[key], key
    assert srv.kv_arena.conserved()


def test_abort_frees_blocks_and_readmits_within_a_round(model):
    """An abort returns the victim's blocks at once: a request blocked on
    memory seats at the next admission pass."""
    _, _, tcfg, tp = model
    srv = _server(tp, tcfg, True, pool_blocks=5)
    a, b = _prompts([30, 10], seed=11)
    solo_b = _server(tp, tcfg, False, slots=1).serve([b], 6)[0]
    srv.submit("A", a, 8)
    srv.submit("B", b, 6)
    ticks, seen, got = [0], {}, {}

    def tick():
        ticks[0] += 1
        live = set(srv.active_rids())
        if "B" in live and "B" not in seen:
            seen["B"] = ticks[0]
        if ticks[0] == 3:
            # A holds 4 of 5 blocks; B (needs 2) cannot seat.
            assert "B" not in live and srv.block_stats()["free_blocks"] < 2
            seen["abort"] = ticks[0]
            assert srv.abort("A")
        return False  # drain: finish B, then return

    srv.serve_incremental(tick=tick, on_finish=lambda r, t: got.update(
        {r: t}))
    assert "A" not in got
    np.testing.assert_array_equal(got["B"], solo_b)
    assert seen["B"] <= seen["abort"] + 1
    arena = srv.kv_arena
    assert arena.conserved() and arena.free_blocks == arena.n_blocks


def test_block_stats_and_capacity_guards(model):
    jcfg, jp, tcfg, tp = model
    srv = _server(tp, tcfg, True)
    assert srv.block_stats() == {
        "total_blocks": 12, "free_blocks": 12, "block_occupancy": 0.0,
        "preemptions": 0,
    }
    assert _server(tp, tcfg, False).block_stats() is None
    seen = []

    def tick():
        st_ = srv.last_stats
        if st_.get("paged"):
            seen.append((st_["occupancy"], st_["free_blocks"],
                         st_["total_blocks"]))
        return bool(srv.pending_count() or srv.active_rids())

    srv.submit("r", _prompts([9], seed=17)[0], 6)
    srv.serve_incremental(tick=tick)
    occ, free, total = [s for s in seen if s[0] > 0][0]
    assert total == 12 and occ == pytest.approx((total - free) / total)
    assert srv.kv_arena.conserved()

    for infer, params, cfg in ((tinfer, tp, tcfg), (jinfer, jp, jcfg)):
        with pytest.raises(ValueError, match="multiple of block_size"):
            infer.DecodeServer(params, cfg, slots=1, max_len=45,
                               prompt_buckets=(8,), paged=True,
                               block_size=BS)
        small = infer.DecodeServer(params, cfg, paged=True, block_size=BS,
                                   **dict(BASE, pool_blocks=3))
        with pytest.raises(ValueError, match="KV blocks"):
            small.submit("big", _prompts([30])[0], 8)
    with pytest.raises(ValueError, match="block_size"):
        tinfer.DecodeServer(tp, tcfg, paged=True, block_size=0)
