"""Parity of the port's flash attention (``dlrover_tpu_torch/ops/
flash_attention.py``) with the JAX package's ``dlrover_tpu/ops/
flash_attention.py``.

On this CPU host the port runs its plain versions; the JAX side runs its
Pallas kernels in interpret mode (``_flash_fwd`` and ``_flash_bwd_pallas``
with ``interpret=True``, as ``tests/test_ops.py`` runs them) and
``jax.grad`` through ``flash_attention(backend="pallas", interpret=True)``.
The CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Inputs come from numpy with a seed.  Tolerances: fp32 atol 1e-5 (the same
fp32 arithmetic, summed in another order: the reference walks 16-wide
blocks with an online softmax, the plain version takes one softmax over
the row); bf16 within 2 bf16 ulps of the reference plus 1e-5 (one rounding
on each side of values that agree to fp32 precision).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import flash_attention as tfa

# The package re-exports the function under the module's name.
jfa = importlib.import_module("dlrover_tpu.ops.flash_attention")

ATOL = 1e-5
BLOCK = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# B, H, KV, S, D, causal, window, segments, dtype
CASES = {
    "gqa_ragged": (1, 4, 2, 37, 24, True, 0, False, "float32"),
    "noncausal": (2, 2, 2, 24, 16, False, 0, False, "float32"),
    "window": (1, 2, 1, 40, 16, True, 9, False, "float32"),
    "segments": (2, 2, 2, 37, 16, True, 0, True, "float32"),
    "segments_noncausal": (1, 4, 2, 29, 16, False, 0, True, "float32"),
    "bf16": (1, 2, 2, 32, 16, True, 0, False, "bfloat16"),
}


def _inputs(case, seed=0):
    B, H, KV, S, D, causal, window, segs, dtype = case
    rng = np.random.RandomState(seed + S + D)
    q, g = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(B, KV, S, D).astype(np.float32) for _ in range(2))
    seg = None
    if segs:
        cuts = np.sort(rng.randint(1, S - 4, size=(B, 2)), axis=1)
        seg = (np.arange(S)[None, :, None] >= cuts[:, None, :]).sum(-1)
        seg = seg.astype(np.int32)
        seg[:, -4:] = -1  # padding, as the packer fills it
    if dtype == "bfloat16":
        # Round once through JAX so both sides see the same bf16 values.
        q, k, v, g = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                      for a in (q, k, v, g))
    return q, k, v, g, seg


# The reference under ``jax.jit`` (eager JAX compiles every primitive,
# the interpreted Pallas kernels' too, anew).
_jit_fwd = jax.jit(jfa._flash_fwd, static_argnums=(3, 4, 5, 6),
                   static_argnames=("window",))
_jit_bwd = jax.jit(jfa._flash_bwd_pallas, static_argnums=(6, 7, 8, 9),
                   static_argnames=("window",))
_jit_reference = jax.jit(jfa.reference_attention, static_argnums=(3,),
                         static_argnames=("window",))


def _jax(a, dtype):
    return None if a is None else jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(
        getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype: str, name: str):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                   err_msg=name)
        return
    a = np.maximum(np.abs(want.astype(np.float64)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(a)) - 7)
    err = np.abs(got - want)
    assert np.all(err <= 2 * ulp + ATOL), (name, float(err.max()))


def _kw(case, seg, lib):
    causal, window = case[5], case[6]
    if lib == "jax":
        return dict(segment_ids=None if seg is None else jnp.asarray(seg),
                    window=window)
    return dict(segment_ids=None if seg is None else torch.from_numpy(seg),
                window=window)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_forward_matches_pallas_forward(name):
    case = CASES[name]
    dtype, causal = case[-1], case[5]
    q, k, v, _, seg = _inputs(case)
    j_out, j_lse = _jit_fwd(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), causal, BLOCK,
        BLOCK, True, **_kw(case, seg, "jax"))
    t_out, t_lse = tfa._flash_fwd_plain(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), causal,
        **_kw(case, seg, "torch"))
    assert t_out.dtype == getattr(torch, dtype)
    assert t_lse.dtype == torch.float32
    _close(t_out, j_out, dtype, "out")
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("name", ["gqa_ragged", "window", "bf16"])
def test_plain_backward_matches_pallas_backward(name):
    """Both sides start from the reference forward's (out, lse)."""
    case = CASES[name]
    dtype, causal = case[-1], case[5]
    q, k, v, g, seg = _inputs(case)
    jq, jk, jv, jg = (_jax(a, dtype) for a in (q, k, v, g))
    jkw = _kw(case, seg, "jax")
    out, lse = _jit_fwd(jq, jk, jv, causal, BLOCK, BLOCK, True, **jkw)
    want = _jit_bwd(jq, jk, jv, out, lse, jg, causal, BLOCK, BLOCK, True,
                    **jkw)
    t_out = _torch(np.array(out, np.float32), dtype)
    got = tfa._flash_bwd_plain(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype), t_out,
        torch.from_numpy(np.array(lse)), _torch(g, dtype), causal,
        **_kw(case, seg, "torch"))
    for t, j, which in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(t.shape) == j.shape, which
        assert t.dtype == getattr(torch, dtype), which
        _close(t, j, dtype, which)


@pytest.mark.parametrize("name", ["gqa_ragged", "segments"])
def test_autograd_matches_jax_grad(name):
    """Gradients of sum(out * w) through the port's autograd function (the
    plain forward and backward here) against ``jax.grad`` through the
    reference's Pallas custom VJP."""
    case = CASES[name]
    causal = case[5]
    q, k, v, g, seg = _inputs(case)
    jkw = _kw(case, seg, "jax")

    def f(q, k, v):
        out = jfa.flash_attention(q, k, v, causal=causal, backend="pallas",
                                  interpret=True, block_q=BLOCK,
                                  block_k=BLOCK, bwd_block_q=BLOCK,
                                  bwd_block_k=BLOCK, **jkw)
        return jnp.sum(out * g)

    want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal,
                              **_kw(case, seg, "torch"))
    torch.sum(out * torch.from_numpy(g)).backward()
    for t, j, which in zip((tq, tk, tv), want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   atol=ATOL, rtol=0, err_msg=which)


@pytest.mark.parametrize("name", ["gqa_ragged", "window",
                                  "segments_noncausal"])
def test_reference_attention_matches_jax(name):
    case = CASES[name]
    causal = case[5]
    q, k, v, _, seg = _inputs(case)
    want = _jit_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal, **_kw(case, seg, "jax"))
    got = tfa.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal,
                                  **_kw(case, seg, "torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_split_wrappers_equal_the_joint_backward():
    """``flash_dq`` and ``flash_dkv`` (the kernels' wrappers, plain here)
    give what ``_flash_bwd_plain`` gives, and launch nothing on the CPU."""
    case = CASES["segments"]
    q, k, v, g, seg = (None if a is None else torch.from_numpy(a)
                       for a in _inputs(case))
    kw = dict(causal=True, segment_ids=seg, window=0)
    before = (tfa.flash_fwd.launches, tfa.flash_dq.launches,
              tfa.flash_dkv.launches)
    out, lse = tfa.flash_fwd(q, k, v, **kw)
    delta = tfa._delta(out, g)
    dq = tfa.flash_dq(q, k, v, g, lse, delta, **kw)
    dk, dv = tfa.flash_dkv(q, k, v, g, lse, delta, **kw)
    want = tfa._flash_bwd_plain(q, k, v, out, lse, g, **kw)
    for a, b in zip((dq, dk, dv), want):
        assert torch.equal(a, b)
    assert (tfa.flash_fwd.launches, tfa.flash_dq.launches,
            tfa.flash_dkv.launches) == before


def test_reference_checks_are_kept():
    x = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="H % KV"):
        tfa.flash_attention(x, torch.zeros(1, 2, 8, 16),
                            torch.zeros(1, 2, 8, 16))
    with pytest.raises(ValueError, match="causal"):
        tfa.flash_attention(x, x, x, causal=False, window=4)
    meta = torch.empty(1, 2, 8, 16, device="meta")
    with pytest.raises(ValueError, match="cuda"):
        tfa.flash_attention(meta, meta, meta)


def test_copy_alignment_check_of_the_tensor_core_path():
    """The bf16 tensor-core wrappers refuse, before any launch, a base or a
    (b, h, s) stride that breaks their 16-byte copies (checked here on CPU
    tensors; on the card ``tests/test_torch_cuda.py`` drives the
    wrappers)."""
    buf = torch.zeros(2 * 4 * 8 * 16 + 8, dtype=torch.bfloat16)
    aligned = buf[:-8].view(2, 4, 8, 16)
    tfa._check_copy_aligned((aligned, aligned.transpose(1, 2)), "probe")
    with pytest.raises(ValueError, match="16-byte"):
        tfa._check_copy_aligned((buf[4:-4].view(2, 4, 8, 16),), "probe")
    narrow = torch.zeros(2, 4, 8, 20, dtype=torch.bfloat16)[..., :12]
    with pytest.raises(ValueError, match="multiples of 8"):
        tfa._check_copy_aligned((narrow,), "probe")
