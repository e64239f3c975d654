"""Parity of the port's RMSNorm (``dlrover_tpu_torch/ops/rmsnorm.py``) with
the JAX package's ``dlrover_tpu/ops/rmsnorm.py``.

On this CPU host the port's wrapper runs its plain PyTorch version; the JAX
side runs its Pallas kernel in interpret mode and its reference, as
``tests/test_ops.py`` does.  The CUDA kernel itself is held against the
plain version on the card by ``chip_smoke.py`` and by
``tests/test_torch_cuda.py``.

Tolerances: fp32 atol 1e-6 (both sides compute in fp32; only the order of
the sum and the rsqrt's last bit differ, about 2 ulp at |out| < 8).  bf16:
at most 1 bf16 ulp of the reference value (fp32 compute, one rounding).
The closed-form backward is held against ``jax.grad`` through the
reference's custom VJP; its tolerances are stated at its tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.ops.rmsnorm import rmsnorm as jax_rmsnorm
from dlrover_tpu_torch.ops import _build
from dlrover_tpu_torch.ops import rmsnorm as rms_mod
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(rows, d, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(rows, d) * 2.0).astype(np.float32)
    w = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
    return x, w


def _bf16_ulp(v: np.ndarray) -> np.ndarray:
    """Spacing of bf16 values at |v| (8 significand bits)."""
    a = np.maximum(np.abs(v.astype(np.float64)), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
@pytest.mark.parametrize("rows,d,eps", [
    (1, 128, 1e-5), (7, 256, 1e-5), (37, 64, 1e-6), (16, 4096, 1e-5),
])
def test_fp32_matches_jax(backend, rows, d, eps):
    x, w = _inputs(rows, d, seed=rows + d)
    ref = np.asarray(jax_rmsnorm(
        jnp.asarray(x), jnp.asarray(w), eps=eps, backend=backend,
        interpret=True,
    ))
    out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w), eps=eps)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["pallas", "reference"])
@pytest.mark.parametrize("rows,d", [(3, 128), (37, 256), (8, 4096)])
def test_bf16_within_one_ulp_of_jax(backend, rows, d):
    x, w = _inputs(rows, d, seed=rows * d)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_rmsnorm(
        xb, jnp.asarray(w), eps=1e-5, backend=backend, interpret=True,
    )).astype(np.float32)
    xt = torch.from_numpy(np.asarray(xb).astype(np.float32)).bfloat16()
    out = rmsnorm(xt, torch.from_numpy(w), eps=1e-5)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - ref)
    assert np.all(err <= _bf16_ulp(ref)), float(err.max())


def test_default_eps_is_the_references():
    """The function's own default is 1e-6 (the model passes rms_eps)."""
    x, w = _inputs(4, 64, seed=3)
    ref = np.asarray(jax_rmsnorm(jnp.asarray(x), jnp.asarray(w),
                                 backend="reference"))
    out = rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_gain_is_not_rounded_before_the_product():
    """x̂ stays fp32 until the gain multiplies it: rounding x̂ to bf16
    first (Hugging Face's habit) gives a different bf16 result."""
    x, w = _inputs(64, 256, seed=11)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w)
    out = rmsnorm(xt, wt, eps=1e-5)
    xf = xt.float()
    xhat = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + 1e-5)
    hf = (xhat.bfloat16().float() * wt).bfloat16()
    assert torch.equal(out, (xhat * wt).bfloat16())
    assert not torch.equal(out, hf)


def test_cpu_path_launches_nothing():
    before = rmsnorm.launches
    x, w = _inputs(2, 64, seed=5)
    rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    assert rmsnorm.launches == before


def test_other_devices_raise_instead_of_running_plain():
    x = torch.empty((2, 64), device="meta")
    w = torch.empty((64,), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        rmsnorm(x, w)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No nvcc under CUDA_HOME: the build raises, there is no fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("rmsnorm", rms_mod.SOURCES)



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_grad(dtype):
    """The closed-form backward against ``jax.grad`` through the
    reference's custom VJP (its ``_bwd``): fp32 atol 1e-5 (same closed
    form, sums in another order); bf16 dx within 2 bf16 ulps plus 1e-6 (fp32
    compute, one rounding each side), dw (fp32) atol 1e-4 (a sum over rows
    of bf16-valued products)."""
    x, w = _inputs(9, 64, seed=21)
    g = np.random.RandomState(22).randn(9, 64).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.asarray(x, jdt)
    x = np.asarray(xj).astype(np.float32)

    def f(x_, w_):
        return jnp.sum(jax_rmsnorm(x_, w_, eps=1e-5).astype(jnp.float32) * g)

    j_dx, j_dw = jax.jit(jax.grad(f, argnums=(0, 1)))(xj, jnp.asarray(w))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = rmsnorm.launches
    torch.sum(rmsnorm(xt, wt, eps=1e-5).float()
              * torch.from_numpy(g)).backward()
    assert rmsnorm.launches == before
    assert xt.grad.dtype == tdt and wt.grad.dtype == torch.float32
    j_dx = np.asarray(j_dx).astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(xt.grad.numpy(), j_dx, atol=1e-5, rtol=0)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(j_dw),
                                   atol=1e-5, rtol=0)
    else:
        err = np.abs(xt.grad.float().numpy() - j_dx)
        assert np.all(err <= 2 * _bf16_ulp(j_dx) + 1e-6), float(err.max())
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(j_dw),
                                   atol=1e-4, rtol=0)


def test_backward_is_the_closed_form_not_autodiff():
    """The gradient comes from the reference's closed form, computed once
    in fp32: equal to ``_backward`` bit for bit."""
    x, w = _inputs(5, 32, seed=4)
    g = torch.from_numpy(np.random.RandomState(5).randn(5, 32)
                         .astype(np.float32))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    rmsnorm(xt, wt, eps=1e-5).backward(g)
    dx, dw = rms_mod._backward(torch.from_numpy(x), torch.from_numpy(w), g,
                               1e-5)
    assert torch.equal(xt.grad, dx) and torch.equal(wt.grad, dw)
