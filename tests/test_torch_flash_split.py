"""The rounding of the tensor-core flash kernels, emulated on the CPU and
held against the JAX package's flash attention.

``flash_fwd_wgmma``, ``flash_dq_wgmma`` and ``flash_dkv_wgmma``
(``dlrover_tpu_torch/ops/csrc/flash_attention.cu``) run on bf16 operands
with fp32 sums, as the tensor cores do, and keep P and dS at fp32
precision by splitting each value into two bf16 values, ``hi = bf16(p)``
and ``lo = bf16(p - hi)``, whose two products add into one fp32
accumulator.  This file emulates that arithmetic in plain torch (bf16
inputs, fp32 products per 64-key tile with the online softmax, the hi/lo
split; dq cast once to bf16) and compares it with the reference,
``_flash_fwd`` and ``_flash_bwd_pallas`` in interpret mode under
``jax.jit`` on the same values in fp32, under the card's phase-4 tolerance
(``chip_smoke.py`` ``close_check``): out, dq, dk and dv within 2 bf16 ulps
of the reference value plus 1e-5 of its largest magnitude, lse within
1e-4.  So it pins, without a card, that the split meets the unchanged
tolerance; and that a single bf16 P or dS, as FlashAttention-2/3 use it,
does not (``test_single_bf16_p_misses_the_tolerance`` prints by how much).
"""

import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

NEG_INF = -1e30
LOG2E = 1.4426950408889634
TILE = 64  # keys a tile of the forward kernel

# name: B, H, KV, S, D, causal, window, segments
CASES = {
    "gqa_d96": (2, 4, 2, 300, 96, True, 0, False),
    "window_d64": (1, 2, 2, 129, 64, True, 40, False),
    "segments_d72": (2, 2, 1, 177, 72, True, 0, True),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).bfloat16().float().numpy()


@functools.lru_cache(maxsize=None)
def _inputs(name):
    B, H, KV, S, D, _, _, segs = CASES[name]
    rng = np.random.RandomState(S + D)
    q, g = (_bf16(rng.randn(B, H, S, D).astype(np.float32)) for _ in "qg")
    k, v = (_bf16(rng.randn(B, KV, S, D).astype(np.float32)) for _ in "kv")
    seg = None
    if segs:
        cuts = np.sort(rng.randint(1, S - 8, size=(B, 3)), axis=1)
        seg = (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1)
        seg = seg.astype(np.int32)
        seg[:, -8:] = -1  # padding, as the packer fills it
    return q, k, v, g, seg


def _mask(S, causal, window, seg):
    """[B or 1, 1, S, S] bool of the (query, key) pairs that attend."""
    qp = torch.arange(S)[:, None]
    kp = torch.arange(S)[None, :]
    ok = torch.ones(S, S, dtype=torch.bool)
    if causal:
        ok &= qp >= kp
    if window > 0:
        ok &= (qp - kp) < window
    ok = ok[None, None]
    if seg is not None:
        s = torch.from_numpy(seg)
        ok = ok & (s[:, None, :, None] == s[:, None, None, :])
    return ok


def _split(x: torch.Tensor, split: bool):
    """``(hi, lo)`` bf16 values of fp32 ``x`` (``lo`` zero without the
    split), returned as fp32."""
    hi = x.bfloat16().float()
    lo = (x - hi).bfloat16().float() if split else torch.zeros_like(x)
    return hi, lo


def _expand(t: torch.Tensor, H: int) -> torch.Tensor:
    return t.repeat_interleave(H // t.shape[1], dim=1)


def _emulate_fwd(q, k, v, causal, window, seg, split=True):
    """The forward kernel's arithmetic: ``(out bf16, lse fp32)``."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    k, v = _expand(k, H), _expand(v, H)
    ok = _mask(S, causal, window, seg)
    m = torch.full((B, H, S), NEG_INF)
    l = torch.zeros(B, H, S)
    acc = torch.zeros(B, H, S, D)
    for k0 in range(0, S, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        s = torch.matmul(q, kt.transpose(-1, -2)) * scale
        s = torch.where(ok[..., k0:k0 + TILE], s, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - m_new) * LOG2E)
        p = torch.exp2((s - m_new[..., None]) * LOG2E)
        l = l * alpha + p.sum(-1)
        hi, lo = _split(p, split)
        acc = acc * alpha[..., None] + torch.matmul(hi, vt) \
            + torch.matmul(lo, vt)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).bfloat16(), m + torch.log(l_safe)


def _emulate_dkv(q, k, v, g, out, lse, causal, window, seg, split=True):
    """The dk/dv kernel's arithmetic from the forward's ``out`` and
    ``lse``: ``(dk, dv)`` bf16 at KV-head size."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    delta = torch.sum(out.float() * g, dim=-1)
    ke, ve = _expand(k, H), _expand(v, H)
    s = torch.matmul(q, ke.transpose(-1, -2)) * scale
    s = torch.where(_mask(S, causal, window, seg), s, torch.tensor(NEG_INF))
    p = torch.exp2((s - lse[..., None]) * LOG2E)
    dp = torch.matmul(g, ve.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    p_hi, p_lo = _split(p, split)
    ds_hi, ds_lo = _split(ds, split)
    dv = torch.matmul(p_hi.transpose(-1, -2), g) \
        + torch.matmul(p_lo.transpose(-1, -2), g)
    dk = torch.matmul(ds_hi.transpose(-1, -2), q) \
        + torch.matmul(ds_lo.transpose(-1, -2), q)
    rep = H // KV
    dk = dk.view(B, KV, rep, S, D).sum(2)
    dv = dv.view(B, KV, rep, S, D).sum(2)
    return dk.bfloat16(), dv.bfloat16()


def _emulate_dq(q, k, v, g, out, lse, causal, window, seg, split=True):
    """The dq kernel's arithmetic from the forward's ``out`` and ``lse``,
    one 64-key tile at a time: dq bf16."""
    B, H, S, D = q.shape
    scale = 1.0 / math.sqrt(D)
    delta = torch.sum(out.float() * g, dim=-1)
    k, v = _expand(k, H), _expand(v, H)
    ok = _mask(S, causal, window, seg)
    dq = torch.zeros(B, H, S, D)
    for k0 in range(0, S, TILE):
        kt, vt = k[:, :, k0:k0 + TILE], v[:, :, k0:k0 + TILE]
        s = torch.matmul(q, kt.transpose(-1, -2)) * scale
        s = torch.where(ok[..., k0:k0 + TILE], s, torch.tensor(NEG_INF))
        p = torch.exp2((s - lse[..., None]) * LOG2E)
        dp = torch.matmul(g, vt.transpose(-1, -2))
        hi, lo = _split(p * (dp - delta[..., None]) * scale, split)
        dq = dq + torch.matmul(hi, kt) + torch.matmul(lo, kt)
    return dq.bfloat16()


@functools.partial(jax.jit, static_argnums=(4, 5))
def _jax_fwd(q, k, v, seg, causal, window):
    return jfa._flash_fwd(q, k, v, causal, TILE, TILE, True,
                          segment_ids=seg, window=window)


@functools.partial(jax.jit, static_argnums=(7, 8))
def _jax_bwd(q, k, v, out, lse, g, seg, causal, window):
    return jfa._flash_bwd_pallas(q, k, v, out, lse, g, causal, TILE, TILE,
                                 True, segment_ids=seg, window=window)


@functools.lru_cache(maxsize=None)
def _results(name, split=True):
    """Emulated outputs beside the reference's fp32 values: ``{what:
    (emulated, reference)}`` for out, lse, dq, dk and dv."""
    causal, window = CASES[name][5], CASES[name][6]
    q, k, v, g, seg = _inputs(name)
    jseg = None if seg is None else jnp.asarray(seg)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out, lse = _emulate_fwd(tq, tk, tv, causal, window, seg, split)
    r_out, r_lse = _jax_fwd(q, k, v, jseg, causal, window)
    dq = _emulate_dq(tq, tk, tv, tg, out, lse, causal, window, seg, split)
    dk, dv = _emulate_dkv(tq, tk, tv, tg, out, lse, causal, window, seg,
                          split)
    # The reference backward from the emulated forward's out and lse, as
    # the card's phase 4 holds the kernels' dq, dk and dv against the plain
    # backward from the kernels' own lse and delta.
    r_dq, r_dk, r_dv = _jax_bwd(q, k, v, out.float().numpy(), lse.numpy(),
                                g, jseg, causal, window)
    return {"out": (out, r_out), "lse": (lse, r_lse), "dq": (dq, r_dq),
            "dk": (dk, r_dk), "dv": (dv, r_dv)}


def _excess(got: torch.Tensor, want) -> float:
    """Largest error over its phase-4 allowance: <= 1 passes."""
    want = torch.from_numpy(np.array(want, np.float32)).double()
    err = (got.double() - want).abs()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(
        min=2.0 ** -126))) - 7)
    allowed = 2 * ulp + 1e-5 * float(want.abs().max())
    return float((err / allowed).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_forward_meets_the_card_tolerance(name):
    res = _results(name)
    out, r_out = res["out"]
    assert out.dtype == torch.bfloat16
    assert tuple(out.shape) == r_out.shape
    excess = _excess(out, r_out)
    print(f"{name} out: largest error / phase-4 allowance {excess:.3f}")
    assert excess <= 1.0
    lse, r_lse = res["lse"]
    assert float(np.abs(lse.numpy() - np.asarray(r_lse)).max()) <= 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_dkv_meets_the_card_tolerance(name):
    res = _results(name)
    for what in ("dk", "dv"):
        got, want = res[what]
        assert tuple(got.shape) == want.shape, what
        excess = _excess(got, want)
        print(f"{name} {what}: largest error / phase-4 allowance "
              f"{excess:.3f}")
        assert excess <= 1.0, what


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_dq_meets_the_card_tolerance(name):
    got, want = _results(name)["dq"]
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape
    excess = _excess(got, want)
    print(f"{name} dq: largest error / phase-4 allowance {excess:.3f}")
    assert excess <= 1.0


def test_single_bf16_p_misses_the_tolerance():
    """The same emulation with P and dS rounded once to bf16 (no lo part)
    breaks the tolerance the split meets: the reason for the split."""
    worst = {}
    for name in CASES:
        res = _results(name, split=False)
        for what in ("out", "dq", "dk", "dv"):
            worst[f"{name}/{what}"] = _excess(*res[what])
    print("single-bf16 P and dS, largest error / phase-4 allowance:",
          {k: round(v, 2) for k, v in sorted(worst.items())})
    assert max(worst.values()) > 1.0
    assert worst["gqa_d96/out"] > 1.0
    # dq with a single bf16 dS misses it in every case.
    assert min(v for k, v in worst.items() if k.endswith("/dq")) > 1.0
