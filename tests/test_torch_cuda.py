"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports neither JAX nor the JAX package, so on the GPU
machine (which has no JAX) it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances.  RMSNorm: fp32 atol 1e-5 (fp32 throughout; the kernel sums in
another order and uses the hardware rsqrt); bf16 at most 1 bf16 ulp of the
plain value (fp32 compute, one rounding on both sides).  Flash attention:
fp32 outputs within 1e-4 of the largest plain value (fp32 sums of up to S
products in another order); bf16 outputs within 2 bf16 ulps of the plain
fp32 value (the plain version on the upcast inputs) plus 1e-5 of the
largest (one rounding each side; entries that are sums of cancelling terms
keep the fp32 sum-order error); lse within 1e-4.  The bf16 forward, dq
and dk/dv run on the tensor cores with P and dS split into two bf16 values
and meet the same tolerances.  Cross-entropy: atol 1e-4
on losses of ~log V (fp32 sums of V exponentials in another order).
Blockwise int8 quantize: codes equal and scales bit-equal (the same IEEE
fp32 operations, in the same order, on both sides).
"""

import math

import numpy as np
import pytest
import torch

from dlrover_tpu_torch import train
from dlrover_tpu_torch.models import llama, llama_infer
from dlrover_tpu_torch.ops import cross_entropy as xent
from dlrover_tpu_torch.ops import flash_attention as fa
from dlrover_tpu_torch.ops import quant
from dlrover_tpu_torch.ops import rmsnorm as rms_mod
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (256, 4096), (5, 100),
                                   (2, 3, 64)])
def test_rmsnorm_kernel_matches_plain(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = (2.0 * torch.randn(shape, generator=g, device=card)).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=card)
    before = rmsnorm.launches
    out = rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = rms_mod._reference(x, w, 1e-5)
    err = (out.double() - ref.double()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= _bf16_ulp(ref)).all()), float(err.max())


def test_rmsnorm_kernel_refuses_what_it_does_not_take(card):
    x = torch.randn(4, 64, device=card)
    w = torch.ones(64, device=card)
    before = rmsnorm.launches
    with pytest.raises(TypeError):
        rmsnorm(x.half(), w)
    with pytest.raises(TypeError):
        rmsnorm(x, w.bfloat16())
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(63, device=card))
    with pytest.raises(ValueError):
        rmsnorm(x.t(), torch.ones(4, device=card))
    with pytest.raises(ValueError):
        rmsnorm(torch.randn(4, 0, device=card), torch.ones(0, device=card))
    with pytest.raises(ValueError):
        rmsnorm(x, w.cpu())
    with pytest.raises(ValueError):
        rmsnorm(x, torch.ones(128, device=card)[::2])
    assert rmsnorm.launches == before


def test_tiny_model_on_the_card_matches_the_cpu(card):
    """A tiny fp32 model: logits and greedy serving on the card (through
    the kernel, 2 * n_layer + 1 launches per forward: the eager prefills
    and the graph warm-up by the wrapper's count, the decode rounds as
    nodes of the captured graph, one replay a round) equal the CPU's."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    dev = to(cpu, card)
    toks = torch.randint(1, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    logits = []
    for p, d in ((cpu, "cpu"), (dev, card)):
        cache = llama_infer.init_cache(cfg, 2, 16, device=d)
        logits.append(llama_infer.forward_step(p, toks.to(d), cfg,
                                               cache)[0].cpu())
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-4

    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 3)]
    before = rmsnorm.launches
    srv = llama_infer.DecodeServer(dev, cfg, slots=2, max_len=32,
                                   prompt_buckets=(8, 16))
    out = srv.serve(prompts, 6)
    st, per_fwd = srv.last_stats, 2 * cfg.n_layer + 1
    assert srv.decode_graph.recorded == {"rmsnorm": per_fwd}
    assert st["graph_replays"] == st["rounds"] > 0
    assert rmsnorm.launches - before == per_fwd * (
        st["forwards"] - st["graph_replays"] + st["graph_warmup_forwards"])
    ref = llama_infer.DecodeServer(cpu, cfg, slots=2, max_len=32,
                                   prompt_buckets=(8, 16)).serve(prompts, 6)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("kw", [{"decode_chunk": 3}, {"paged": True},
                                {"paged": True, "decode_chunk": 3,
                                 "quant_kv": True, "pool_blocks": 5}],
                         ids=["chunk3", "paged", "paged_chunk3_int8_tight"])
def test_graphed_decode_matches_the_cpu(card, kw):
    """The chunked and paged decode dispatches captured as one graph on the
    card emit the CPU's eager tokens; the capture records 2L+1 RMSNorm
    launches per step of the chunk."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = {k: v.to(card) if torch.is_tensor(v) else v
           for k, v in cpu.items()}
    dev["layers"] = [{k: v.to(card) if torch.is_tensor(v) else
                      {kk: vv.to(card) for kk, vv in v.items()}
                      for k, v in lay.items()} for lay in cpu["layers"]]
    rng = np.random.RandomState(3)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 3, 20)]
    srv_kw = dict(slots=2, max_len=48, prompt_buckets=(8, 16),
                  block_size=8, **kw)
    ref_srv = llama_infer.DecodeServer(cpu, cfg, **srv_kw)
    ref = ref_srv.serve(prompts, 9)
    srv = llama_infer.DecodeServer(dev, cfg, **srv_kw)
    for _ in range(2):  # the second call replays the first call's graph
        out = srv.serve(prompts, 9)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)
    K = srv.decode_chunk
    assert srv.decode_graph.recorded == {"rmsnorm": (2 * cfg.n_layer + 1)
                                         * K}
    assert srv.last_stats["graph_replays"] == srv.last_stats["rounds"]
    assert srv.preemptions == ref_srv.preemptions
    if srv.paged:
        assert srv.kv_arena.conserved()


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_on(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("kw", [{}, {"paged": True, "decode_chunk": 3},
                                {"quant_kv": True}],
                         ids=["slotted", "paged_chunk3", "int8"])
def test_graphed_templated_admission_matches_the_cpu(card, kw):
    """Templated admission (``serve(shared_prefix=)`` and ``submit(
    prefix_len=)``) on a graphed server writes the template into the
    captured cache in place: two serve calls (the second replays the first
    one's graph) and an incremental run emit the CPU's tokens, and the
    RMSNorm launches are the eager forwards' (template prefills included)
    plus the graph's nodes times its replays."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = _on(cpu, card)
    rng = np.random.RandomState(5)
    prefix = rng.randint(1, cfg.vocab_size, size=20).astype(np.int32)
    own = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
           for n in (5, 12, 3, 9)]
    srv_kw = dict(slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8,
                  **kw)
    ref = llama_infer.DecodeServer(cpu, cfg, **srv_kw).serve(
        own, 9, shared_prefix=prefix)
    srv = llama_infer.DecodeServer(dev, cfg, **srv_kw)
    per_fwd, K = 2 * cfg.n_layer + 1, srv.decode_chunk
    for _ in range(2):
        before = rmsnorm.launches
        out = srv.serve(own, 9, shared_prefix=prefix)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o, r)
        st = srv.last_stats
        assert st["templated"] == len(own) and st["template_forwards"] == 1
        assert rmsnorm.launches - before == per_fwd * (
            st["forwards"] - K * st["graph_replays"]
            + st["graph_warmup_forwards"] + st["template_forwards"])
    for i, p in enumerate(own):
        srv.submit(i, np.concatenate([prefix, p]), 9, prefix_len=20)
    got = {}
    srv.serve_incremental(
        tick=lambda: bool(srv.pending_count() or srv.active_rids()),
        on_finish=lambda r, t: got.__setitem__(r, t))
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(got[i], r)
    assert srv.prefix_misses == 1 and srv.prefix_hits == len(own) - 1
    if srv.paged:
        assert srv.kv_arena.conserved()


@pytest.mark.parametrize("kw", [{}, {"quant_kv": True}, {"paged": True}],
                         ids=["slotted", "int8", "paged"])
def test_graphed_imported_admission_matches_the_cpu(card, kw):
    """A segment prefilled on the card (or on the CPU) and imported into a
    graphed server lands in the captured cache in place and decodes the
    CPU's in-place tokens, with no prefill forward."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    dev = _on(cpu, card)
    rng = np.random.RandomState(6)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (13, 30, 4)]
    srv_kw = dict(slots=2, max_len=64, prompt_buckets=(8, 16), block_size=8,
                  **kw)
    ref = llama_infer.DecodeServer(cpu, cfg, **srv_kw).serve(prompts, 7)
    cpu_pf = llama_infer.DecodeServer(cpu, cfg, **srv_kw)
    card_pf = llama_infer.DecodeServer(dev, cfg, **srv_kw)
    dec = llama_infer.DecodeServer(dev, cfg, **srv_kw)
    dec.serve(prompts[:1], 2)  # captures
    for i, p in enumerate(prompts):
        pf = card_pf if i % 2 else cpu_pf
        pf.prefill_request(i, p, 7)
        dec.import_kv(i, pf.export_kv(i)[0], p, 7)
    got = {}
    dec.serve_incremental(
        tick=lambda: bool(dec.pending_count() or dec.active_rids()),
        on_finish=lambda r, t: got.__setitem__(r, t))
    for i, r in enumerate(ref):
        np.testing.assert_array_equal(got[i], r)
    st = dec.last_stats
    assert st["imported"] == len(prompts) and st["prefills"] == 0
    assert st["graph_replays"] == st["rounds"] > 0


def test_sampled_graph_draws_fresh_noise(card):
    """At temperature > 0 the server's generator is registered with the
    graph: replays draw fresh noise (streams do not collapse into a
    repeated token), the draws are reproducible from the seed, and two
    seeds differ."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    params = llama.init_params(cfg, torch.Generator(device=card)
                               .manual_seed(0), card)
    prompts = [np.arange(1, 6, dtype=np.int32)] * 2

    def run(seed):
        srv = llama_infer.DecodeServer(params, cfg, slots=2, max_len=48,
                                       prompt_buckets=(8,), temperature=1.0,
                                       seed=seed)
        srv.serve(prompts, 4)  # captures
        return [o[5:].tolist() for o in srv.serve(prompts, 24)]

    a, b, c = run(1), run(1), run(2)
    assert a == b and a != c
    for stream in a:
        assert len(set(stream)) > 4, stream
    assert a[0] != a[1]  # the two slots draw different noise


def _close(out, plain32, dtype, what):
    """The tolerances of the module docstring."""
    err = (out.double() - plain32.double()).abs()
    scale = float(plain32.abs().max())
    if dtype == torch.float32:
        bound = 1e-4 * scale + 1e-6
        assert float(err.max()) <= bound, (what, float(err.max()), bound)
    else:
        bound = 2 * _bf16_ulp(plain32) + 1e-5 * scale
        assert bool((err <= bound).all()), (what, float(err.max()))


FLASH_CASES = [
    # B, H, KV, S, D, dtype, causal, window, segments
    (2, 4, 2, 200, 64, torch.bfloat16, True, 0, False),
    (1, 2, 2, 77, 24, torch.float32, False, 0, False),
    (2, 4, 4, 130, 96, torch.float32, True, 50, True),
    (1, 8, 2, 300, 128, torch.bfloat16, True, 0, True),
    (1, 2, 1, 64, 16, torch.bfloat16, True, 0, False),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(
    str(x).replace("torch.", "") for x in c))
def test_flash_kernels_match_plain(card, case):
    B, H, KV, S, D, dtype, causal, window, segs = case
    g = torch.Generator(device=card).manual_seed(S + D)
    q = torch.randn(B, H, S, D, generator=g, device=card).to(dtype)
    k = torch.randn(B, KV, S, D, generator=g, device=card).to(dtype)
    v = torch.randn(B, KV, S, D, generator=g, device=card).to(dtype)
    do = torch.randn(B, H, S, D, generator=g, device=card).to(dtype)
    seg = None
    if segs:
        cuts = torch.sort(torch.randint(1, S, (B, 3), generator=g,
                                        device=card)).values
        seg = (torch.arange(S, device=card)[None, :, None]
               >= cuts[:, None, :]).sum(-1).to(torch.int32)
        seg[:, -5:] = -1
    kw = dict(causal=causal, segment_ids=seg, window=window)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert dk.shape == k.shape and lse.dtype == torch.float32
    f32 = [t.float() for t in (q, k, v, do)]
    p_out, p_lse = fa._flash_fwd_plain(*f32[:3], causal, seg, window)
    assert float((lse - p_lse).abs().max()) <= 1e-4
    _close(out, p_out, dtype, "out")
    # The backward from the kernel's own lse and delta, as the autograd
    # function runs it.
    p_dq, p_dk, p_dv = fa._bwd_parts(*f32, lse, delta, causal, seg, window,
                                     True, True)
    for got, want, name in ((dq, p_dq, "dq"), (dk, p_dk, "dk"),
                            (dv, p_dv, "dv")):
        _close(got, want, dtype, name)


def test_flash_autograd_on_the_card_launches_each_kernel_once(card):
    g = torch.Generator(device=card).manual_seed(0)
    q, k, v = (torch.randn(1, 2, 96, 32, generator=g, device=card)
               .requires_grad_() for _ in range(3))
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    fa.flash_attention(q, k, v).square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    ref = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    fa.reference_attention(*ref).square().sum().backward()
    for t, r in zip((q, k, v), ref):
        assert float((t.grad.cpu() - r.grad).abs().max()) <= 1e-4


def test_flash_kernels_refuse_what_they_do_not_take(card):
    q = torch.randn(1, 2, 16, 24, device=card)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_fwd(q[..., :20].contiguous(), q[..., :20].contiguous(),
                     q[..., :20].contiguous())
    with pytest.raises(TypeError):
        fa.flash_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_fwd(q, q.bfloat16(), q)


# The tensor-core forward, dq and dk/dv (bf16): B, H, KV, S, D, causal,
# window, segments, strided [B, S, H, D] views.
TC_CASES = [
    (1, 4, 4, 77, 72, True, 0, False, False),
    (2, 4, 2, 1000, 96, True, 0, False, True),
    (1, 32, 8, 1000, 128, True, 0, False, False),
    (2, 4, 4, 300, 64, True, 50, True, False),
    (1, 2, 2, 129, 128, False, 0, False, True),
    (1, 4, 2, 200, 96, True, 0, True, True),
]


def _tc_inputs(case, device):
    B, H, KV, S, D, causal, window, segs, strided = case
    g = torch.Generator(device=device).manual_seed(S + D + H)

    def rand(heads):
        if strided:  # the model's layout: [B, S, H, D] seen as [B, H, S, D]
            return torch.randn(B, S, heads, D, generator=g, device=device
                               ).bfloat16().transpose(1, 2)
        return torch.randn(B, heads, S, D, generator=g, device=device
                           ).bfloat16()

    q, k, v, do = rand(H), rand(KV), rand(KV), rand(H)
    seg = None
    if segs:
        cuts = torch.sort(torch.randint(1, S, (B, 3), generator=g,
                                        device=device)).values
        seg = (torch.arange(S, device=device)[None, :, None]
               >= cuts[:, None, :]).sum(-1).to(torch.int32)
        seg[:, -5:] = -1
    return q, k, v, do, dict(causal=causal, segment_ids=seg, window=window)


@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "-".join(
    str(x) for x in c))
def test_tensor_core_flash_matches_plain(card, case):
    """``flash_fwd_wgmma``, ``flash_dq_wgmma`` and ``flash_dkv_wgmma``
    against the plain versions on the upcast inputs, under the tolerances
    of the module docstring (phase 4's)."""
    q, k, v, do, kw = _tc_inputs(case, card)
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    dq = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == tuple(n + 1 for n in before)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    f32 = [t.float() for t in (q, k, v, do)]
    p_out, p_lse = fa._flash_fwd_plain(*f32[:3], kw["causal"],
                                       kw["segment_ids"], kw["window"])
    assert float((lse - p_lse).abs().max()) <= 1e-4
    _close(out, p_out, torch.bfloat16, "out")
    p_dq, p_dk, p_dv = fa._bwd_parts(*f32, lse, delta, kw["causal"],
                                     kw["segment_ids"], kw["window"], True,
                                     True)
    _close(dq, p_dq, torch.bfloat16, "dq")
    _close(dk, p_dk, torch.bfloat16, "dk")
    _close(dv, p_dv, torch.bfloat16, "dv")


def test_wgmma_tile_probe_feeds_the_accumulator_as_a(card):
    """One 64 x 64 tile: the accumulator of q·kᵀ (both operands from
    shared memory) is exact to fp32 sums, and fed back as the A operand
    (hi and lo bf16 pairs) against v read MN-major it gives hi(s)·v +
    lo(s)·v."""
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(64, 64, generator=g, device=card).bfloat16()
               for _ in range(3))
    s, o = fa.wgmma_tile_probe(q, k, v)
    torch.cuda.synchronize()
    s_ref = q.double() @ k.double().T
    assert float((s.double() - s_ref).abs().max()) <= \
        1e-6 * float(s_ref.abs().max())
    hi = s.bfloat16().float()
    lo = (s - hi).bfloat16().float()
    o_ref = (hi.double() + lo.double()) @ v.double()
    assert float((o.double() - o_ref).abs().max()) <= \
        1e-6 * float(o_ref.abs().max())


def test_tensor_core_dkv_repeats_bit_for_bit(card):
    q, k, v, do, kw = _tc_inputs((2, 8, 4, 640, 128, True, 0, True, True),
                                 card)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    first = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    second = fa.flash_dkv(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_tensor_core_dq_repeats_bit_for_bit(card):
    """Each block owns its rows of dq (no atomics): a repeat is equal bit
    for bit, which block remat's recomputed backward relies on."""
    q, k, v, do, kw = _tc_inputs((2, 8, 4, 640, 128, True, 0, True, True),
                                 card)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    delta = fa._delta(out, do)
    first = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    second = fa.flash_dq(q, k, v, do, lse, delta, **kw)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_tensor_core_kernels_refuse_a_misaligned_input(card):
    """A bf16 input whose base breaks the 16-byte copies raises; it never
    reaches another kernel or the plain version."""
    buf = torch.randn(2 * 4 * 64 * 64 + 4, device=card).bfloat16()
    q = buf[4:].view(2, 4, 64, 64)  # 8 bytes past an aligned base
    ok = torch.randn(2, 4, 64, 64, device=card).bfloat16()
    before = (fa.flash_fwd.launches, fa.flash_dq.launches,
              fa.flash_dkv.launches)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(q, ok, ok)
    lse = torch.zeros(2, 4, 64, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_dq(ok, q, ok, ok, lse, lse)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_dkv(ok, ok, ok, q, lse, lse)
    assert (fa.flash_fwd.launches, fa.flash_dq.launches,
            fa.flash_dkv.launches) == before


@pytest.mark.parametrize("rows,V,dtype,ldtype", [
    (64, 256, torch.float32, torch.int64),
    (100, 1000, torch.bfloat16, torch.int32),
    (7, 33, torch.float32, torch.int32),
    (5, 33, torch.bfloat16, torch.int64),
    (512, 32000, torch.float32, torch.int32),
])
def test_xent_kernel_matches_plain(card, rows, V, dtype, ldtype):
    g = torch.Generator(device=card).manual_seed(rows + V)
    logits = (3.0 * torch.randn(rows, V, generator=g, device=card)).to(dtype)
    labels = torch.randint(0, V, (rows,), generator=g, device=card)
    labels[0] = -1  # selects nothing: the target is 0
    labels = labels.to(ldtype)
    before = xent.xent_fwd.launches
    out = xent.xent_fwd(logits, labels)
    torch.cuda.synchronize()
    assert xent.xent_fwd.launches == before + 1
    assert out.dtype == torch.float32 and out.shape == (rows,)
    ref = xent._reference(logits, labels)
    assert float((out - ref).abs().max()) <= 1e-4


def test_tiny_training_on_the_card_matches_the_cpu(card):
    """The tiny fp32 model's loss and gradients, kernels on the card
    against the plain versions on the CPU (atol 1e-4: fp32 throughout)."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randint(0, cfg.vocab_size, (2, 33)))
    seg = torch.from_numpy(np.repeat([[0, 1, 1, 2]], 2, 0).repeat(8, 1)
                           .reshape(2, 32)[:, :32])
    seg = torch.cat([seg, seg[:, -1:]], dim=1).to(torch.int32)
    grads = []
    for dev in ("cpu", card):
        params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                                   "cpu", param_dtype=torch.float32)
        params = _to(params, dev)
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        before = xent.xent_fwd.launches
        loss = llama.loss_fn(params, {"tokens": tokens.to(dev),
                                      "segment_ids": seg.to(dev)}, cfg)
        loss.backward()
        if dev != "cpu":
            assert xent.xent_fwd.launches == before + 1
        grads.append([loss.item()] + [p.grad.cpu() for p in leaves])
    assert abs(grads[0][0] - grads[1][0]) <= 1e-4
    for a, b in zip(grads[0][1:], grads[1][1:]):
        assert float((a - b).abs().max()) <= 1e-4


def test_train_cli_runs_on_the_card(card, capsys):
    assert train.main(["--model", "tiny", "--steps", "3"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    stats = dict(kv.split("=", 1) for kv in line.split()[1:])
    assert stats["xent_fwd_launches"] == "3"
    assert stats["flash_fwd_launches"] == str(3 * 2)
    assert stats["rmsnorm_launches"] == str(3 * 5)


def _quant_input(case, card):
    """The chip smoke's phase-7 inputs, and two the kernel takes another
    way: an fp32 view 4 bytes off alignment (scalar loads) and fp16 (cast
    to fp32 by the wrapper, as the reference casts)."""
    if case == "smoke":
        x = torch.from_numpy(np.random.RandomState(4).randn(4 << 20)
                             .astype(np.float32))
    elif case == "ragged":
        x = 3.0 * torch.randn(1000, generator=torch.Generator().manual_seed(1))
    elif case == "bf16":
        x = (5.0 * torch.randn(3, 12345, generator=torch.Generator()
                               .manual_seed(2))).to(torch.bfloat16)
    elif case == "zero_block":
        x = torch.randn(3, 128, generator=torch.Generator().manual_seed(3))
        x[1] = 0.0
    elif case == "ties":
        halves = torch.arange(63, dtype=torch.float32) + 0.5
        x = torch.cat([torch.tensor([127.0, -127.0]), halves, -halves])
    elif case == "unaligned":
        x = torch.randn(1001, generator=torch.Generator().manual_seed(5))
        return x.to(card)[1:]
    else:
        x = torch.randn(700, generator=torch.Generator().manual_seed(6)) \
            .half()
    return x.to(card)


@pytest.mark.parametrize("case", ["smoke", "ragged", "bf16", "zero_block",
                                  "ties", "unaligned", "fp16"])
def test_quant_kernel_matches_plain(card, case):
    """Codes equal and scales bit-equal to the plain version, and the
    reference smoke's round-trip bound (max|x| / 254, which a truncating
    kernel breaks)."""
    x = _quant_input(case, card)
    before = quant.quantize_blockwise.launches
    codes, scale = quant.quantize_blockwise(x)
    torch.cuda.synchronize()
    assert quant.quantize_blockwise.launches == before + 1
    pc, ps = quant.quantize_blockwise(x, backend="plain")
    assert quant.quantize_blockwise.launches == before + 1
    assert torch.equal(codes, pc)
    assert torch.equal(scale.view(torch.int32), ps.view(torch.int32))
    back = quant.dequantize_blockwise(codes, scale, x.shape)
    err = float((back - x.float()).abs().max())
    assert err <= float(x.float().abs().max()) / 254.0 * 1.01


def test_quant_cuda_backend_refuses_a_cpu_tensor(card):
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant.quantize_blockwise(torch.ones(10), backend="cuda")
    with pytest.raises(ValueError, match="stochastic"):
        quant.quantize_blockwise(torch.ones(10, device=card),
                                 backend="cuda", stochastic=True)


def _recording(per_leaf, out):
    """``per_leaf`` that also appends each update it returns to ``out``."""
    def run(*args):
        res = per_leaf(*args)
        out.append(res[0].cpu())
        return res
    return run


def test_adam8bit_on_the_card_matches_the_cpu(card):
    """Three updates of one parameter on the card and on the CPU with the
    same noise: the updates within 1e-5 of the largest (fp32 ``pow`` and
    ``log10`` of the two devices differ by ulps; a moment code may move
    one level where its log level sits on a .5 boundary); the parameters
    after each step within the sum, over the steps so far, of that
    tolerance and one fp32 ulp of ``|p|`` (each side rounds ``p + update``
    once).  The update launches no blockwise-quantize kernel."""
    w0 = torch.from_numpy(np.random.RandomState(0).randn(7, 50)
                          .astype(np.float32))
    params = [w0.clone().requires_grad_(True),
              w0.clone().to(card).requires_grad_(True)]
    opts = [quant.adam8bit(1e-2, weight_decay=0.01)([p]) for p in params]
    upd = []
    for opt in opts:
        opt._per_leaf = _recording(opt._per_leaf, upd)
    before = quant.quantize_blockwise.launches
    bound = torch.zeros_like(w0)
    for count in (1, 2, 3):
        g = torch.from_numpy((np.random.RandomState(count).randn(7, 50)
                              * 10.0 ** -count).astype(np.float32))
        rng = np.random.RandomState(100 + count)
        noise = [torch.from_numpy(rng.rand(3, 128).astype(np.float32) - 0.5)
                 for _ in range(2)]
        upd.clear()
        for p, opt in zip(params, opts):
            it = iter([n.to(p.device) for n in noise])
            opt._noise = lambda shape, device, it=it: next(it)
            p.grad = g.to(p.device)
            opt.step()
        assert len(upd) == 2
        tol = 1e-5 * float(upd[0].abs().max())
        assert float((upd[0] - upd[1]).abs().max()) <= tol
        mag = params[0].detach().abs()
        bound += tol + (torch.nextafter(mag, torch.tensor(math.inf)) - mag)
        diff = (params[0].detach() - params[1].detach().cpu()).abs()
        assert bool((diff <= bound).all()), float((diff - bound).max())
    assert quant.quantize_blockwise.launches == before


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# The lean host call of the RMSNorm, cross-entropy and quantize wrappers
# (ops/_launch.py): the caller's stream, the tensor's device, fresh
# outputs, the old errors and exact launch counts.
# ---------------------------------------------------------------------------


def _lean_case(name, device, seed):
    """``(inputs, call, plain, check)`` of one wrapper at a path shape; the
    first input is the one a test rewrites on a side stream."""
    g = torch.Generator(device=device).manual_seed(seed)
    if name == "rmsnorm":
        x = (2.0 * torch.randn(8, 4096, generator=g, device=device)).bfloat16()
        w = 1.0 + 0.1 * torch.randn(4096, generator=g, device=device)

        def check(out, ref):
            err = (out.double() - ref.double()).abs()
            assert bool((err <= _bf16_ulp(ref)).all()), float(err.max())

        return ([x, w], lambda x, w: rmsnorm(x, w, eps=1e-5),
                lambda x, w: rms_mod._reference(x, w, 1e-5), check)
    if name.startswith("xent"):
        rows, V = (64, 32000) if name == "xent_cluster" else (8, 128256)
        logits = 3.0 * torch.randn(rows, V, generator=g, device=device)
        labels = torch.randint(0, V, (rows,), generator=g, device=device)

        def check(out, ref):
            assert float((out - ref).abs().max()) <= 1e-4

        return [logits, labels], xent.xent_fwd, xent._reference, check
    x = torch.randn(4 << 20, generator=g, device=device)

    def check(out, ref):
        assert torch.equal(out[0], ref[0])
        assert torch.equal(out[1].view(torch.int32), ref[1].view(torch.int32))

    return ([x], quant.quantize_blockwise,
            lambda x: quant.quantize_blockwise(x, backend="plain"), check)


LEAN = ["rmsnorm", "xent_cluster", "xent_two_pass", "quant"]


def _outputs(out):
    return list(out) if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("name", LEAN)
def test_lean_call_launches_on_the_callers_stream(card, name):
    """On a side stream, a sleep and then a copy of new values into the
    input, then the call: a kernel launched on any other stream than the
    caller's current one runs at once and reads the old input."""
    old, call, plain, check = _lean_case(name, card, 0)
    new = _lean_case(name, card, 1)[0]
    x = old[0].clone()
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)  # ~0.1 s of the side stream's time
        x.copy_(new[0])
        out = call(x, *new[1:])
    torch.cuda.synchronize()
    check(out, plain(*new))


@pytest.mark.parametrize("name", LEAN)
def test_lean_call_returns_fresh_outputs(card, name):
    """Two calls return distinct tensors, and the second stays right after
    the first is overwritten."""
    inputs, call, plain, check = _lean_case(name, card, 2)
    first, second = call(*inputs), call(*inputs)
    ref = plain(*inputs)
    torch.cuda.synchronize()
    check(first, ref)
    ptrs = {t.data_ptr() for t in _outputs(first) + _outputs(second)}
    assert len(ptrs) == 2 * len(_outputs(first))
    for t in _outputs(first):
        t.zero_()
    check(second, ref)


@pytest.mark.parametrize("name", LEAN)
def test_lean_call_counts_each_launch(card, name):
    inputs, call, _, _ = _lean_case(name, card, 3)
    wrapper = {"rmsnorm": rmsnorm, "quant": quant.quantize_blockwise}.get(
        name, xent.xent_fwd)
    routes = dict(xent.xent_fwd.route_launches)
    before = wrapper.launches
    for _ in range(3):
        call(*inputs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 3
    ran = {k: v - routes[k] for k, v in xent.xent_fwd.route_launches.items()}
    if name.startswith("xent"):
        route = name[len("xent_"):]
        assert ran == {k: 3 if k == route else 0 for k in ran}
    else:
        assert not any(ran.values())


def test_lean_call_launches_on_the_tensors_device(card):
    """A tensor on cuda:1 launches on cuda:1 while cuda:0 is current (and
    the other way round), on the caller's stream of that device, and the
    caller's current device is the same afterwards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    for name in LEAN:
        for home, other in ((1, 0), (0, 1)):
            inputs, call, plain, check = _lean_case(name, f"cuda:{home}", 4)
            torch.cuda.synchronize(home)
            with torch.cuda.device(other):
                out = call(*inputs)
                assert torch.cuda.current_device() == other
            check(out, plain(*inputs))
            new = _lean_case(name, f"cuda:{home}", 5)[0]
            x = inputs[0].clone()
            side = torch.cuda.Stream(device=home)
            torch.cuda.synchronize(home)
            with torch.cuda.stream(side):  # also makes cuda:<home> current
                torch.cuda._sleep(200_000_000)
                x.copy_(new[0])
                with torch.cuda.device(other):
                    out = call(x, *new[1:])
                    assert torch.cuda.current_device() == other
            torch.cuda.synchronize(home)
            check(out, plain(*new))


def test_xent_kernel_refuses_what_it_does_not_take(card):
    logits = torch.randn(4, 64, device=card)
    labels = torch.zeros(4, dtype=torch.long, device=card)
    before = xent.xent_fwd.launches
    with pytest.raises(TypeError):
        xent.xent_fwd(logits.half(), labels)
    with pytest.raises(TypeError):
        xent.xent_fwd(logits, labels.float())
    with pytest.raises(ValueError):
        xent.xent_fwd(logits, labels[:3])
    with pytest.raises(ValueError):
        xent.xent_fwd(torch.randn(4, 0, device=card), labels)
    with pytest.raises(ValueError):
        xent.xent_fwd(logits, labels.cpu())
    with pytest.raises(ValueError):
        xent.xent_fwd(logits.t(), torch.zeros(64, dtype=torch.long,
                                              device=card))
    assert xent.xent_fwd.launches == before


@pytest.mark.parametrize("rows,V,dtype,ldtype,route", [
    (64, 32000, torch.float32, torch.int64, "cluster"),
    (64, 32000, torch.bfloat16, torch.int32, "cluster"),
    (33, 32001, torch.float32, torch.int32, "cluster"),
    (40, 32001, torch.bfloat16, torch.int64, "cluster"),
    (100, 256, torch.float32, torch.int32, "cluster"),
    (100, 256, torch.bfloat16, torch.int64, "cluster"),
    (16, 65536, torch.float32, torch.int64, "cluster"),
    (16, 131072, torch.bfloat16, torch.int32, "cluster"),
    (16, 65537, torch.float32, torch.int32, "two_pass"),
    (8, 128256, torch.bfloat16, torch.int64, "cluster"),
    (8, 262144, torch.bfloat16, torch.int64, "two_pass"),
])
def test_xent_routes_match_plain_and_repeat(card, rows, V, dtype, ldtype,
                                            route):
    """Each route against plain (atol 1e-4), labels -1 and V picking no
    target, a repeat bit-identical, each launch counted on its route."""
    g = torch.Generator(device=card).manual_seed(rows + V)
    logits = (3.0 * torch.randn(rows, V, generator=g, device=card)).to(dtype)
    labels = torch.randint(0, V, (rows,), generator=g, device=card)
    labels[0], labels[1] = -1, V
    labels = labels.to(ldtype)
    assert xent.route(rows, V, logits.element_size()) == route
    before = dict(xent.xent_fwd.route_launches)
    out = xent.xent_fwd(logits, labels)
    again = xent.xent_fwd(logits, labels)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in xent.xent_fwd.route_launches.items()}
    assert ran == {k: 2 if k == route else 0 for k in ran}
    assert torch.equal(out, again)
    ref = xent._reference(logits, labels)
    assert float((out - ref).abs().max()) <= 1e-4
    lse = torch.logsumexp(logits[:2].double(), dim=-1)
    assert float((out[:2].double() - lse).abs().max()) <= 1e-4


def test_xent_cluster_route_takes_an_unaligned_row(card):
    """Logits 4 bytes past an aligned base: single-element loads."""
    g = torch.Generator(device=card).manual_seed(9)
    buf = 3.0 * torch.randn(64 * 32000 + 1, generator=g, device=card)
    logits = buf[1:].view(64, 32000)
    labels = torch.randint(0, 32000, (64,), generator=g, device=card)
    before = xent.xent_fwd.route_launches["cluster"]
    out = xent.xent_fwd(logits, labels)
    torch.cuda.synchronize()
    assert xent.xent_fwd.route_launches["cluster"] == before + 1
    assert float((out - xent._reference(logits, labels)).abs().max()) <= 1e-4
