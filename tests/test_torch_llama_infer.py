"""Parity of the port's decode path (``dlrover_tpu_torch/models/llama.py``,
``models/llama_infer.py``) with the JAX package's ``dlrover_tpu/models/
llama.py`` and ``models/llama_infer.py``, on ``LlamaConfig.tiny``.

Both sides take the same parameters: the JAX ``init_params`` tree carried
across by ``params_from_numpy``.  Inputs are drawn with numpy from a seed.
The port runs on the CPU, where its RMSNorm wrapper takes the plain
version; the JAX side runs its reference path.

Tolerances: fp32 logits and caches atol 1e-5 (the same fp32 arithmetic,
summed in another order); bf16 logits within 2**-6 of the largest logit and
relative L2 1e-2 (bf16 keeps 8 significand bits and the two frameworks
round elementwise results at different places, so a few ulps differ);
greedy tokens identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy

ATOL = 1e-5
SERVER_KW = dict(slots=2, max_len=48, prompt_buckets=(8, 16))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(dtype="float32", seed=0, **over):
    """(jax cfg, jax params, port cfg, port params) for one tiny model."""
    jcfg = jllama.LlamaConfig.tiny(dtype=getattr(jnp, dtype), **over)
    tcfg = tllama.LlamaConfig.tiny(dtype=getattr(torch, dtype), **over)
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _pair()


@pytest.fixture(scope="module")
def jax_server(model):
    """One JAX server reused across tests (its jits compile once); the
    EOS token is host-side state, set per test."""
    jcfg, jp, _, _ = model
    return jinfer.DecodeServer(jp, jcfg, **SERVER_KW)


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _eos_from(outs, prompts):
    """A token the greedy streams emit (so EOS really cuts some short)."""
    gen = np.concatenate([o[len(p):] for o, p in zip(outs, prompts)])
    vals, counts = np.unique(gen, return_counts=True)
    return int(vals[np.argmax(counts)])


# -- model pieces -----------------------------------------------------------

def test_rope_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 4, 16).astype(np.float32)
    pos = rng.randint(0, 100, size=(2, 5)).astype(np.int32)
    ref = np.asarray(jllama._rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    out = tllama._rope(torch.from_numpy(x), _t(pos), 1e4)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=0)


def test_block_apply_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, jcfg.d_model).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6))
    jc = jinfer.init_cache(jcfg, 2, 8)["layers"][0]
    tc = tinfer.init_cache(tcfg, 2, 8, device="cpu")["layers"][0]

    def jattn(h, layer, cfg, positions):
        return jinfer._cached_attention(h, layer, cfg, jc, 0, positions)[0]

    def tattn(h, layer, cfg, positions):
        return tinfer._cached_attention(h, layer, cfg, tc, 0, positions)

    ref, _ = jllama.block_apply(jp["layers"][0], jnp.asarray(x), jcfg,
                                jnp.asarray(pos), attn_fn=jattn)
    out = tllama.block_apply(tp["layers"][0], torch.from_numpy(x), tcfg,
                             _t(pos), attn_fn=tattn)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("mode", ["scalar", "ragged", "window"])
def test_forward_step_matches_jax(mode):
    over = {"sliding_window": 4} if mode == "window" else {}
    jcfg, jp, tcfg, tp = _pair(seed=2, **over)
    rng = np.random.RandomState(3)
    B, L = 3, 24
    # ring=False: the reference's dense layout, which the port keeps.
    jc = jinfer.init_cache(jcfg, B, L, ring=False)
    tc = tinfer.init_cache(tcfg, B, L, device="cpu")
    prompt = rng.randint(0, 256, size=(B, 9)).astype(np.int32)
    steps = [prompt]
    if mode == "ragged":
        offs = np.array([2, 9, 5], np.int32)
        steps += [rng.randint(0, 256, size=(B, 3)).astype(np.int32),
                  rng.randint(0, 256, size=(B, 1)).astype(np.int32)]
    else:
        steps += [rng.randint(0, 256, size=(B, 2)).astype(np.int32),
                  rng.randint(0, 256, size=(B, 1)).astype(np.int32)]
    for i, toks in enumerate(steps):
        if mode == "ragged" and i == 1:
            jc = dict(jc, offset=jnp.asarray(offs))
            tc["offset"] = _t(offs)
        ref, jc = jinfer.forward_step(jp, jnp.asarray(toks), jcfg, jc)
        out, tc = tinfer.forward_step(tp, _t(toks), tcfg, tc)
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(tc["offset"]),
                                  np.asarray(jc["offset"]))
    for jl_, tl_ in zip(jc["layers"], tc["layers"]):
        for k in ("k", "v"):
            np.testing.assert_allclose(tl_[k].numpy(), np.asarray(jl_[k]),
                                       atol=ATOL, rtol=0)


def test_forward_step_bf16_matches_jax():
    jcfg, jp, tcfg, tp = _pair(dtype="bfloat16", seed=4)
    toks = np.random.RandomState(5).randint(0, 256, (2, 7)).astype(np.int32)
    ref, _ = jinfer.forward_step(jp, jnp.asarray(toks), jcfg,
                                 jinfer.init_cache(jcfg, 2, 16))
    out, _ = tinfer.forward_step(tp, _t(toks), tcfg,
                                 tinfer.init_cache(tcfg, 2, 16, device="cpu"))
    ref = np.asarray(ref)
    diff = out.numpy() - ref
    assert np.abs(diff).max() <= 2.0 ** -6 * np.abs(ref).max()
    assert np.linalg.norm(diff) <= 1e-2 * np.linalg.norm(ref)


def test_params_from_numpy_keeps_gains_fp32():
    _, _, tcfg, tp = _pair(dtype="bfloat16")
    assert tp["ln_f"].dtype == torch.float32
    assert tp["layers"][0]["ln1"].dtype == torch.float32
    assert tp["layers"][0]["mlp"]["w_up"].dtype == torch.bfloat16
    assert tp["embed"].dtype == torch.bfloat16


# -- sampling ----------------------------------------------------------------

@pytest.mark.parametrize("top_k,top_p", [(3, 0.0), (0, 0.5), (4, 0.9),
                                         (1, 0.0), (0, 1e-9)])
def test_filter_logits_matches_jax(top_k, top_p):
    rng = np.random.RandomState(top_k + int(100 * top_p))
    x = rng.randn(4, 32).astype(np.float32)
    x[0, :5] = x[0].max() + 1.0  # a five-way tie at the top
    x[1, [3, 7]] = 2.5  # a tie at the k-th value
    ref = np.asarray(jinfer._filter_logits(jnp.asarray(x), top_k, top_p))
    out = tinfer._filter_logits(torch.from_numpy(x), top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out, ref)


def test_greedy_pick_takes_the_first_maximum():
    x = np.zeros((2, 8), np.float32)
    x[0, [2, 5]] = 1.0
    x[1, [7, 0]] = 3.0
    ref = np.asarray(jinfer._make_sampler(0.0, 0, 0.0)(jnp.asarray(x), None))
    out = tinfer._make_sampler(0.0, 0, 0.0)(torch.from_numpy(x), None)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, [2, 0])


def test_sampled_pick_stays_inside_the_filter():
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 50)
                         .astype(np.float32))
    keep = ~torch.isinf(tinfer._filter_logits(x / 0.7, 5, 0.0))
    g = torch.Generator().manual_seed(1)
    tok = tinfer._make_sampler(0.7, 5, 0.0)(x, g)
    assert keep[torch.arange(64), tok].all()


# -- the slice as a whole ---------------------------------------------------

@pytest.mark.parametrize("window", [0, 4])
def test_generate_matches_jax_greedy(window):
    jcfg, jp, tcfg, tp = _pair(seed=6, sliding_window=window)
    prompts = np.random.RandomState(7).randint(1, 256, (3, 6)) \
        .astype(np.int32)
    ref = jinfer.generate(jp, jcfg, jnp.asarray(prompts), max_new_tokens=8)
    out = tinfer.generate(tp, tcfg, _t(prompts), max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_generate_ragged_matches_jax_greedy_with_eos(model):
    jcfg, jp, tcfg, tp = model
    lens = np.array([3, 8, 5, 1], np.int32)
    prompts = np.zeros((4, 8), np.int32)
    for b, n in enumerate(lens):
        prompts[b, :n] = np.random.RandomState(b).randint(1, 256, n)
    free, free_lens = tinfer.generate_ragged(tp, tcfg, _t(prompts),
                                             _t(lens), max_new_tokens=10)
    eos = _eos_from([free[b, :free_lens[b]].numpy() for b in range(4)],
                    [prompts[b, :n] for b, n in enumerate(lens)])
    ref, ref_lens = jinfer.generate_ragged(
        jp, jcfg, jnp.asarray(prompts), jnp.asarray(lens),
        max_new_tokens=10, eos_token=eos)
    out, out_lens = tinfer.generate_ragged(
        tp, tcfg, _t(prompts), _t(lens), max_new_tokens=10, eos_token=eos)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))
    assert int(out_lens.min()) < int((lens + 10).min())  # EOS cut a row


def test_server_serve_matches_jax_greedy(model, jax_server):
    """More requests than slots, mixed lengths (one longer than the
    largest bucket, so it is scored in chunks) and an EOS."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(8, [5, 12, 20, 3, 9, 16])
    free = tinfer.DecodeServer(tp, tcfg, **SERVER_KW).serve(prompts, 12)
    eos = _eos_from(free, prompts)
    jax_server.eos_token = eos
    ref = jax_server.serve(prompts, 12)
    srv = tinfer.DecodeServer(tp, tcfg, eos_token=eos, **SERVER_KW)
    out = srv.serve(prompts, 12)
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, np.asarray(r))
    assert any(len(o) < len(p) + 12 for o, p in zip(out, prompts))
    for key in ("path", "rounds", "emitted_tokens", "tokens_per_round"):
        assert srv.last_stats[key] == jax_server.last_stats[key]
    assert srv.last_stats["prefills"] == len(prompts)


def _drive_incremental(srv, prompts, abort_at=None):
    """Two submission waves fed through ``tick``; optionally abort an
    active and a pending request and an unknown id at tick ``abort_at``.
    Returns (finished {rid: tokens}, observations per tick)."""
    done, seen = {}, []
    state = {"tick": 0}

    def tick():
        state["tick"] += 1
        t = state["tick"]
        if t == 1:
            for i in range(3):
                srv.submit(f"r{i}", prompts[i], 6)
        if t == 3:
            for i in range(3, len(prompts)):
                srv.submit(f"r{i}", prompts[i], 6)
        obs = (sorted(srv.active_rids()), srv.pending_rids(),
               srv.free_slots(), srv.pending_count())
        if t == abort_at:
            act = sorted(srv.active_rids())
            obs += (srv.abort(act[-1]), srv.abort(srv.pending_rids()[0]),
                    srv.abort("nope"), srv.cancel("nope"),
                    srv.pop_request_stats(act[0]))
        seen.append(obs)
        return t < 4

    srv.serve_incremental(tick=tick, on_finish=lambda r, o: done.update(
        {r: np.asarray(o)}))
    return done, seen


@pytest.mark.parametrize("abort_at", [None, 2])
def test_serve_incremental_and_abort_match_jax(model, jax_server, abort_at):
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(9, [4, 7, 11, 6, 3])
    jax_server.eos_token = -1
    ref_done, ref_seen = _drive_incremental(jax_server, prompts, abort_at)
    srv = tinfer.DecodeServer(tp, tcfg, **SERVER_KW)
    done, seen = _drive_incremental(srv, prompts, abort_at)
    assert seen == ref_seen
    assert sorted(done) == sorted(ref_done)
    for rid in done:
        np.testing.assert_array_equal(done[rid], ref_done[rid])
    if abort_at is None:
        assert sorted(done) == [f"r{i}" for i in range(5)]
    else:
        assert len(done) == 3  # one active and one pending shed


def test_capacity_and_mode_errors_match_jax(model, jax_server):
    _, _, tcfg, tp = model
    srv = tinfer.DecodeServer(tp, tcfg, **SERVER_KW)
    long_prompt = np.ones(40, np.int32)
    for s in (jax_server, srv):
        with pytest.raises(ValueError, match="exceeds max_len"):
            s.check_capacity(40, 9)
        s.check_capacity(40, 8)
        with pytest.raises(ValueError, match="request 1: "):
            s.serve([np.ones(3, np.int32), long_prompt], 9)
        s.submit("x", np.ones(3, np.int32), 4)
        with pytest.raises(RuntimeError, match="exclusive"):
            s.serve([np.ones(3, np.int32)], 4)
        assert s.cancel("x") and s.pending_count() == 0
