"""Serving slice 2 of the port against the JAX package: the int8 KV cache,
the sliding-window ring cache and the chunked decode server
(``dlrover_tpu_torch/models/llama_infer.py`` against ``dlrover_tpu/models/
llama_infer.py``), mirroring ``tests/test_llama_infer.py``'s
``TestQuantKVCache``, ``TestRollingWindowCache``, ``TestChunkedDecodeServer``
and ``TestServeStats``.

Both sides take the same parameters (``LlamaConfig.tiny(n_layer=2)``, fp32,
the JAX ``init_params`` tree carried across by ``params_from_numpy``);
inputs are drawn with numpy from a seed.  The JAX helpers run under
``jax.jit``, as the reference's server runs them: XLA compiles the
quantizer's ``max|x| / 127.0`` as a product with fp32 ``1/127``, which the
port's scale takes.

Tolerances: int8 codes equal and scales within 1 fp32 ulp; fp32 logits
atol 1e-5 (the same fp32 arithmetic summed in another order); greedy
tokens identical.
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


def _pair(seed=0, **over):
    """(jax cfg, jax params, port cfg, port params), fp32, two layers."""
    jcfg = jllama.LlamaConfig.tiny(n_layer=2, dtype=jnp.float32, **over)
    tcfg = tllama.LlamaConfig.tiny(n_layer=2, dtype=torch.float32, **over)
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def model():
    return _pair()


def _t(a):
    return torch.from_numpy(np.array(a)).long()


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


def _jit_step(jcfg, assume_empty=False):
    return jax.jit(lambda p, t, c: jinfer.forward_step(
        p, t, jcfg, c, assume_empty_cache=assume_empty))


def _assert_same_cache(tc, jc):
    for jl_, tl_ in zip(jc["layers"], tc["layers"]):
        assert sorted(jl_) == sorted(tl_)
        for k in jl_:
            ref = np.asarray(jl_[k])
            if ref.dtype == np.int8:
                np.testing.assert_array_equal(tl_[k].numpy(), ref)
            else:
                np.testing.assert_allclose(tl_[k].numpy(), ref, atol=ATOL,
                                           rtol=0)


class TestQuantKVCache:
    def test_quantize_kv_codes_and_scales_match_jax(self):
        rng = np.random.RandomState(0)
        x = rng.randn(3, 2, 7, 16).astype(np.float32) * 3.0
        x[0, 0, 0] = 0.0                      # an all-zero row: the floor
        x[0, 1, 1] = np.linspace(-127, 127, 16) / 127.0 * 2.5  # near ties
        x[1, 0, 2] = 1e-12                    # below the floor
        x[2, 1, :] *= 1e4
        codes, scale = jax.jit(jinfer._quantize_kv)(jnp.asarray(x))
        tc, ts = tinfer._quantize_kv(torch.from_numpy(x))
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        assert tuple(ts.shape) == (3, 2, 7)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(codes))
        ref = np.asarray(scale)
        assert (np.abs(ts.numpy() - ref) <= np.spacing(ref)).all()
        back = tc.numpy().astype(np.float32) * ts.numpy()[..., None]
        assert (np.abs(back - x) <= ts.numpy()[..., None] / 2 + 1e-7).all()

    @pytest.mark.parametrize("mode", ["scalar", "ragged"])
    def test_quant_forward_step_matches_jax(self, model, mode):
        """Prefill and decode steps on the int8 cache: logits at ATOL,
        codes equal, scales at ATOL (scalar offsets, then ragged)."""
        jcfg, jp, tcfg, tp = model
        rng = np.random.RandomState(1)
        B, L = 2, 16
        jc = jinfer.init_cache(jcfg, B, L, quant_kv=True)
        tc = tinfer.init_cache(tcfg, B, L, device="cpu", quant_kv=True)
        step = _jit_step(jcfg)
        steps = [rng.randint(0, 256, size=(B, 7)).astype(np.int32)]
        steps += [rng.randint(0, 256, size=(B, 1)).astype(np.int32)
                  for _ in range(3)]
        for i, toks in enumerate(steps):
            if mode == "ragged" and i == 1:
                offs = np.array([4, 7], np.int32)
                jc = dict(jc, offset=jnp.asarray(offs))
                tc["offset"] = _t(offs)
            ref, jc = step(jp, jnp.asarray(toks), jc)
            out, tc = tinfer.forward_step(tp, _t(toks), tcfg, tc)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=ATOL, rtol=0)
        _assert_same_cache(tc, jc)

    def test_quant_logits_close_to_dense(self, model):
        """The reference's own bound: int8-cache logits within 5 % of the
        dense cache's span at prefill."""
        _, _, tcfg, tp = model
        toks = _t(np.random.RandomState(2).randint(0, 256, (2, 7)))
        ld, _ = tinfer.forward_step(
            tp, toks, tcfg, tinfer.init_cache(tcfg, 2, 11, device="cpu"))
        lq, _ = tinfer.forward_step(
            tp, toks, tcfg,
            tinfer.init_cache(tcfg, 2, 11, device="cpu", quant_kv=True))
        span = float(ld.abs().max()) + 1e-6
        assert float((lq - ld).abs().max()) / span < 0.05

    def test_quant_cache_is_half_the_bytes(self):
        cfg = tllama.LlamaConfig.tiny(n_layer=2, n_head=4, n_kv_head=2,
                                      d_model=256)

        def nbytes(c):
            return sum(t.numel() * t.element_size()
                       for layer in c["layers"] for t in layer.values())

        dense = tinfer.init_cache(cfg, 2, 32, device="cpu")
        quant = tinfer.init_cache(cfg, 2, 32, device="cpu", quant_kv=True)
        assert nbytes(quant) < 0.6 * nbytes(dense)

    def test_quant_generate_and_ragged_match_jax(self, model):
        jcfg, jp, tcfg, tp = model
        prompts = np.random.RandomState(3).randint(1, 256, (2, 6)) \
            .astype(np.int32)
        ref = jax.jit(lambda p, x: jinfer.generate(
            p, jcfg, x, max_new_tokens=6, quant_kv=True))(
                jp, jnp.asarray(prompts))
        out = tinfer.generate(tp, tcfg, _t(prompts), max_new_tokens=6,
                              quant_kv=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        lens = np.array([4, 6], np.int32)
        ref, ref_lens = jax.jit(lambda p, x, n: jinfer.generate_ragged(
            p, jcfg, x, n, max_new_tokens=6, quant_kv=True))(
                jp, jnp.asarray(prompts), jnp.asarray(lens))
        out, out_lens = tinfer.generate_ragged(
            tp, tcfg, _t(prompts), _t(lens), max_new_tokens=6,
            quant_kv=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(out_lens.numpy(), np.asarray(ref_lens))


class TestRollingWindowCache:
    @pytest.mark.parametrize("quant_kv", [False, True])
    def test_ring_decode_matches_jax(self, quant_kv):
        """A window-6 model on an 8-slot ring: the prefill fills 7 slots,
        then 10 decode steps wrap the ring; logits, the ring's contents and
        its positions match the reference's ring."""
        jcfg, jp, tcfg, tp = _pair(seed=4, sliding_window=6)
        rng = np.random.RandomState(5)
        jc = jinfer.init_cache(jcfg, 2, 32, ring_len=8, quant_kv=quant_kv)
        tc = tinfer.init_cache(tcfg, 2, 32, device="cpu", ring_len=8,
                               quant_kv=quant_kv)
        assert tuple(tc["layers"][0]["k"].shape)[2] == 8
        assert tuple(tc["pos"].shape) == (8,)
        prefill, step = _jit_step(jcfg, True), _jit_step(jcfg)
        toks = rng.randint(0, 256, (2, 7)).astype(np.int32)
        ref, jc = prefill(jp, jnp.asarray(toks), jc)
        out, tc = tinfer.forward_step(tp, _t(toks), tcfg, tc,
                                      assume_empty_cache=True)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                                   rtol=0)
        for _ in range(10):
            toks = rng.randint(0, 256, (2, 1)).astype(np.int32)
            ref, jc = step(jp, jnp.asarray(toks), jc)
            out, tc = tinfer.forward_step(tp, _t(toks), tcfg, tc)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                       atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        assert int(tc["offset"]) == int(jc["offset"]) == 17
        _assert_same_cache(tc, jc)

    def test_ring_rejects_oversized_chunk(self):
        jcfg, jp, tcfg, tp = _pair(sliding_window=4)
        for infer, cfg, params, cache, zeros in (
            (jinfer, jcfg, jp, jinfer.init_cache(jcfg, 1, 64, ring_len=4),
             lambda n: jnp.zeros((1, n), jnp.int32)),
            (tinfer, tcfg, tp,
             tinfer.init_cache(tcfg, 1, 64, device="cpu", ring_len=4),
             lambda n: torch.zeros((1, n), dtype=torch.long)),
        ):
            with pytest.raises(ValueError, match="ring"):
                infer.forward_step(params, zeros(8), cfg, cache)
            with pytest.raises(ValueError, match="continuation"):
                infer.forward_step(params, zeros(2), cfg, cache)
        tc = tinfer.init_cache(tcfg, 1, 64, device="cpu", ring_len=4)
        tc["offset"] = torch.zeros(1, dtype=torch.long)
        with pytest.raises(ValueError, match="ragged"):
            tinfer.forward_step(tp, torch.zeros((1, 1), dtype=torch.long),
                                tcfg, tc)

    def test_windowed_generate_uses_a_ring_and_matches_jax(self):
        jcfg, jp, tcfg, tp = _pair(seed=6, sliding_window=5)
        prompts = np.random.RandomState(7).randint(1, 256, (2, 6)) \
            .astype(np.int32)
        ref = jax.jit(lambda p, x: jinfer.generate(
            p, jcfg, x, max_new_tokens=12, quant_kv=True))(
                jp, jnp.asarray(prompts))
        out = tinfer.generate(tp, tcfg, _t(prompts), max_new_tokens=12,
                              quant_kv=True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.fixture(scope="module")
def jax_chunk(model):
    """One JAX chunked server reused across tests (its jits compile once);
    the EOS token is host-side state, set per test."""
    jcfg, jp, _, _ = model
    return jinfer.DecodeServer(jp, jcfg, decode_chunk=3, **SERVER_KW)


class TestChunkedDecodeServer:
    def test_chunked_matches_jax_with_admission_churn(self, model,
                                                      jax_chunk):
        """More requests than slots, one longer than the largest bucket,
        a budget that is no multiple of the chunk."""
        _, _, tcfg, tp = model
        prompts = _prompts(8, [5, 12, 20, 3, 9])
        jax_chunk.eos_token = -1
        ref = jax_chunk.serve(prompts, 11)
        srv = tinfer.DecodeServer(tp, tcfg, decode_chunk=3, **SERVER_KW)
        out = srv.serve(prompts, 11)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, np.asarray(r))
        plain = tinfer.DecodeServer(tp, tcfg, **SERVER_KW).serve(prompts, 11)
        for o, r in zip(out, plain):
            np.testing.assert_array_equal(o, r)
        for key in ("path", "rounds", "emitted_tokens", "tokens_per_round"):
            assert srv.last_stats[key] == jax_chunk.last_stats[key], key
        assert srv.last_stats["path"] == "decode_chunk"
        assert srv.last_stats["emitted_tokens"] == 5 * 11 - 5
        assert srv.last_stats["forwards"] == \
            srv.last_stats["prefills"] + 1 + 3 * srv.last_stats["rounds"]

    def test_chunked_eos_mid_chunk_matches_jax(self, model, jax_chunk):
        _, _, tcfg, tp = model
        prompts = _prompts(9, [6, 4, 10])
        free = tinfer.DecodeServer(tp, tcfg, **SERVER_KW).serve(prompts, 12)
        eos = int(free[0][len(prompts[0]) + 1])  # mid-chunk for K = 3
        jax_chunk.eos_token = eos
        ref = jax_chunk.serve(prompts, 12)
        srv = tinfer.DecodeServer(tp, tcfg, decode_chunk=3, eos_token=eos,
                                  **SERVER_KW)
        streamed = {}
        out = srv.serve(prompts, 12, on_token=lambda r, t: streamed
                        .setdefault(r, []).append(t))
        for i, (o, r) in enumerate(zip(out, ref)):
            np.testing.assert_array_equal(o, np.asarray(r))
            assert streamed[i] == list(o[len(prompts[i]):])
        assert len(out[0]) <= len(prompts[0]) + 2

    def test_capacity_check_includes_chunk_headroom(self, model, jax_chunk):
        _, _, tcfg, tp = model
        srv = tinfer.DecodeServer(tp, tcfg, decode_chunk=3, **SERVER_KW)
        for s in (jax_chunk, srv):
            # 32 + 15 + 2 = 49 > 48: the chunk's overshoot counts.
            with pytest.raises(ValueError, match="headroom"):
                s.check_capacity(32, 15)
            s.check_capacity(31, 15)
        with pytest.raises(ValueError, match="request 0: .*headroom"):
            srv.serve([np.ones(32, np.int32)], 15)
        out = srv.serve([np.ones(31, np.int32)], 15)
        assert len(out[0]) == 46

    def test_chunked_quant_kv_matches_jax(self, model):
        jcfg, jp, tcfg, tp = model
        prompts = _prompts(10, [7, 4, 11])
        ref = jinfer.DecodeServer(jp, jcfg, decode_chunk=3, quant_kv=True,
                                  **SERVER_KW).serve(prompts, 9)
        out = tinfer.DecodeServer(tp, tcfg, decode_chunk=3, quant_kv=True,
                                  **SERVER_KW).serve(prompts, 9)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, np.asarray(r))
        solo = tinfer.generate(tp, tcfg, _t(prompts[1])[None],
                               max_new_tokens=9, quant_kv=True)
        np.testing.assert_array_equal(out[1], solo[0].numpy())

    def test_sliding_window_model_serves_on_dense_cache(self):
        """A windowed model through the server (a dense cache with the
        window mask) equals its ring-cache generate(), chunked or not."""
        _, _, tcfg, tp = _pair(seed=11, sliding_window=5)
        prompts = _prompts(12, [6, 9, 4])
        for K in (1, 3):
            out = tinfer.DecodeServer(tp, tcfg, decode_chunk=K,
                                      **SERVER_KW).serve(prompts, 10)
            for p, got in zip(prompts, out):
                solo = tinfer.generate(tp, tcfg, _t(p)[None],
                                       max_new_tokens=10)
                np.testing.assert_array_equal(got, solo[0].numpy(),
                                              err_msg=str(K))

    def test_stats_reset_between_calls(self, model):
        _, _, tcfg, tp = model
        srv = tinfer.DecodeServer(tp, tcfg, decode_chunk=4, **SERVER_KW)
        srv.serve(_prompts(13, [6, 6, 6]), 8)
        first = dict(srv.last_stats)
        assert first["path"] == "decode_chunk"
        assert first["emitted_tokens"] == 3 * 8 - 3 and first["rounds"] >= 1
        srv.serve(_prompts(14, [6]), 4)
        assert srv.last_stats["emitted_tokens"] == 4 - 1
        assert srv.last_stats != first
        assert srv.last_stats["graph_replays"] == 0  # eager on the CPU
