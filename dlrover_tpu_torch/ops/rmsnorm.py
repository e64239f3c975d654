"""RMSNorm forward: a hand-written CUDA kernel and its plain PyTorch version.

Held against ``dlrover_tpu/ops/rmsnorm.py``: :func:`_reference` is its
``_reference`` and the CUDA kernel ``csrc/rmsnorm.cu`` replaces its Pallas
``_kernel`` (launched by ``_pallas_fwd``).  Both compute
``xf * rsqrt(mean(xf**2) + eps) * w.float()`` in fp32 and cast once, to
``x.dtype``; the normalised ``xf * rsqrt(...)`` is never rounded before the
gain multiplies it.  The closed-form backward (the reference's ``_bwd``)
comes with the training slice.

:func:`rmsnorm` runs the plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises.
``rmsnorm.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlrover_tpu_torch.ops import _build

SOURCES = ("rmsnorm.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _reference(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + eps)
    return (xf * inv * w.float()).to(x.dtype)


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _kernel_fn()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("rmsnorm", SOURCES).dlr_rmsnorm_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"rmsnorm kernel takes float32 or bfloat16 x, got {x.dtype}"
        )
    if not x.is_contiguous():
        raise ValueError("rmsnorm kernel needs a contiguous x")
    D = x.shape[-1] if x.dim() else 0
    if D == 0:
        raise ValueError(f"rmsnorm over an empty last dim: {tuple(x.shape)}")
    if w.dtype != torch.float32 or tuple(w.shape) != (D,):
        raise TypeError(
            f"rmsnorm gain must be float32 [{D}], got {w.dtype} "
            f"{tuple(w.shape)}"
        )
    if w.device != x.device or not w.is_contiguous():
        raise ValueError(
            f"rmsnorm gain must be contiguous on {x.device}, got "
            f"{w.device}"
        )
    out = torch.empty_like(x)
    rows = x.numel() // D
    if rows == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        rc = fn(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, D,
            float(eps), _DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed: CUDA error {rc}")
    rmsnorm.launches += 1
    return out


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim; ``w`` is the fp32 [D] gain."""
    if x.device.type == "cpu":
        return _reference(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(
            f"rmsnorm runs on cuda (kernel) or cpu (plain), got {x.device}"
        )
    return _launch(x, w, eps)


rmsnorm.launches = 0
