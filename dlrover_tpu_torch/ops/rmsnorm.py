"""RMSNorm: a hand-written CUDA forward kernel, its plain PyTorch version,
and the closed-form backward.

Held against ``dlrover_tpu/ops/rmsnorm.py``: :func:`_reference` is its
``_reference`` and the CUDA kernel ``csrc/rmsnorm.cu`` replaces its Pallas
``_kernel`` (launched by ``_pallas_fwd``).  Both compute
``xf * rsqrt(mean(xf**2) + eps) * w.float()`` in fp32 and cast once, to
``x.dtype``; the normalised ``xf * rsqrt(...)`` is never rounded before the
gain multiplies it.  :func:`_backward` is the reference's closed-form
``_bwd`` in plain PyTorch, on both devices (the reference has no backward
kernel either).

:func:`rmsnorm` runs the plain forward only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
``backend="pallas"`` forces the kernel (a CPU tensor raises) and
``"reference"`` the plain version, as in the reference.
``rmsnorm.launches`` counts the kernel's launches.  When no gradient is
wanted (the decode path) it calls the forward directly, outside autograd.
The launch takes the lean host call of ``ops/_launch.py`` (the caller's
stream read at every call, the device switched in C only when it differs,
plain-int ctypes arguments): at the decode shape the call's host time, not
the kernel, is what a decode step pays.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dlrover_tpu_torch.ops import _backend, _launch
from dlrover_tpu_torch.ops._launch import INT_MAX, LO

SOURCES = ("rmsnorm.cu", "launch.cuh")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return (xf * inv * w.float()).to(x.dtype)


def _backward(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
              eps: float):
    """The reference's ``_bwd``: ``dx = inv * (gw - xhat * mean(gw *
    xhat))`` in fp32, cast to ``x.dtype``; ``dw = sum(g * xhat)`` over
    rows, cast to ``w.dtype``."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt(torch.mean(torch.square(xf), dim=-1, keepdim=True)
                      + eps)
    xhat = xf * inv
    gw = gf * wf
    dx = inv * (gw - xhat * torch.mean(gw * xhat, dim=-1, keepdim=True))
    dw = torch.sum((gf * xhat).reshape(-1, x.shape[-1]), dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNorm(torch.autograd.Function):
    """``forward_fn`` (the kernel's wrapper or the plain version) forward,
    :func:`_backward` backward."""

    @staticmethod
    def forward(ctx, x, w, eps, forward_fn):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return forward_fn(x, w, eps)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _backward(x, w, g, ctx.eps)
        return dx, dw, None, None


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _kernel_fn()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _launch.bind("rmsnorm", SOURCES, "dlr_rmsnorm_fwd")


def _launch_kernel(x: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """Checks (cheapest first), a fresh output, one launch on the caller's
    stream for ``x``'s device."""
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(
            f"rmsnorm kernel takes float32 or bfloat16 x, got {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    shape = x.shape
    D = shape[-1] if shape else 0
    if D == 0:
        raise ValueError(f"rmsnorm over an empty last dim: {tuple(shape)}")
    if w.dtype != torch.float32 or w.shape != (D,):
        raise TypeError(
            f"rmsnorm gain must be float32 [{D}], got {w.dtype} "
            f"{tuple(w.shape)}"
        )
    dev = x.get_device()
    if w.get_device() != dev or not w.is_contiguous():
        raise ValueError(
            f"rmsnorm gain must be contiguous on {x.device}, got "
            f"{w.device}"
        )
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    if rows > INT_MAX or D > INT_MAX:
        raise ValueError(f"rmsnorm kernel: shape {tuple(shape)} is too large")
    fn = _kernel_fn()
    xp, wp, op, st = x.data_ptr(), w.data_ptr(), out.data_ptr(), \
        _launch.stream(dev)
    rc = fn(xp & LO, xp >> 32, wp & LO, wp >> 32, op & LO, op >> 32, rows, D,
            ctypes.c_float(eps), code, dev, st & LO, st >> 32)
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm.launches += 1
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            backend: Optional[str] = None,
            interpret: bool = False) -> torch.Tensor:
    """RMSNorm over the last dim; ``w`` is the fp32 [D] gain.

    ``backend`` takes the reference's values (``ops/_backend.py``):
    ``"pallas"`` launches the kernel or raises, ``"reference"`` runs the
    plain version; ``interpret=True`` raises."""
    if backend is None and not interpret:
        # The decode path's call: no keyword to resolve.
        if x.is_cuda:
            fwd = _launch_kernel
        elif x.is_cpu:
            fwd = _reference
        else:
            raise ValueError(
                f"rmsnorm runs on cuda (kernel) or cpu (plain), got "
                f"{x.device}"
            )
    elif _backend.use_kernel(backend, interpret, x, "rmsnorm"):
        fwd = _launch_kernel
    else:
        fwd = _reference
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _RMSNorm.apply(x, w, eps, fwd)
    return fwd(x, w, eps)


rmsnorm.launches = 0
