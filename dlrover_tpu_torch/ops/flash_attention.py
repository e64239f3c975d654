"""Flash attention: hand-written CUDA kernels (forward, dq, dk/dv), their
plain PyTorch versions, and the autograd function that joins them.

Held against ``dlrover_tpu/ops/flash_attention.py``:

- :func:`reference_attention` is its ``reference_attention``;
- :func:`_flash_fwd_plain` has the semantics of ``_flash_fwd`` (the Pallas
  ``_fwd_kernel``): q scaled by ``1/sqrt(D)`` in fp32 *before* the QKᵀ
  product, every mask the finite ``NEG_INF = -1e30``, ``l`` floored at
  ``1e-30``, ``lse = m + log(l)`` in fp32;
- :func:`_flash_bwd_plain` has the semantics of ``_flash_bwd_pallas`` (the
  Pallas ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``): ``p = exp(q·kᵀ·scale
  − lse)`` with the scale *after* the product, ``delta = Σ out·g`` in fp32
  from the stored ``out``, dq in q's dtype, dk and dv summed over the GQA
  group in fp32 and cast once to k's dtype, at KV-head size.

The kernels in ``csrc/flash_attention.cu`` replace the three Pallas
kernels.  :func:`flash_fwd`, :func:`flash_dq` and :func:`flash_dkv` are
their wrappers: each runs its plain version only for tensors on the CPU,
launches its kernel for CUDA tensors (or raises), and counts its launches
in ``<wrapper>.launches``.  :func:`flash_attention` is the public entry, a
``torch.autograd.Function`` whose forward is :func:`flash_fwd` (it saves
``out`` and the fp32 ``lse``) and whose backward computes ``delta`` and
runs :func:`flash_dq` and :func:`flash_dkv`.

Which kernel a CUDA tensor reaches is decided by its dtype, not by a
fallback: bf16 runs on the tensor cores (``flash_fwd_wgmma``,
``flash_dq_wgmma``, ``flash_dkv_wgmma``: Hopper ``wgmma`` on bf16 tiles,
P and dS split into two bf16 values so that they keep fp32 precision);
fp32 runs on the CUDA cores.  A bf16 input the tensor-core kernels do not
take (a base pointer or a stride that breaks their 16-byte copies) raises;
it never reaches another kernel or the plain version.

Layout ``[B, H, S, D]`` as in the reference; the kernels take any strides
with a unit last-dim stride, so the model's transposed views pass without a
copy.  GQA: k and v carry ``KV`` heads with ``H % KV == 0``; the kernels
read the shared head in place.  Block sizes are fixed for this card in the
kernel source (:data:`CUDA_TILES`); :func:`flash_attention` accepts the
reference's tile keywords at their defaults only, and their
``DLROVER_TPU_FLASH_*`` environment variables are not carried over.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from dlrover_tpu_torch.ops import _backend, _build

SOURCES = ("flash_attention.cu",)
NEG_INF = -1e30
# The reference's tile keywords and their defaults (``DEFAULT_BLOCK_*`` in
# ``dlrover_tpu/ops/flash_attention.py``), accepted at these values only.
DEFAULT_BLOCK_Q = 512
DEFAULT_BLOCK_K = 512
DEFAULT_BWD_BLOCK_Q = 256
DEFAULT_BWD_BLOCK_K = 512
CUDA_TILES = (
    "bf16: forward and dq 128 query rows x 64 keys, dk/dv 64 keys x 64 "
    "query rows (32 at head dim 128); fp32: 64 x 64"
)
MAX_HEAD_DIM = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _visible(S: int, causal: bool, segment_ids: Optional[torch.Tensor],
             window: int, device) -> Optional[torch.Tensor]:
    """[B or 1, 1, S, S] bool: which (query, key) pairs attend, or None
    when every pair does."""
    mask = None
    if causal or window > 0:
        qpos = torch.arange(S, device=device)[:, None]
        kpos = torch.arange(S, device=device)[None, :]
        diff = qpos - kpos
        mask = diff >= 0 if causal else torch.ones_like(diff, dtype=torch.bool)
        if window > 0:
            mask = mask & (diff >= 0) & (diff < window)
        mask = mask[None, None]
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else mask & seg
    return mask


def _expand_kv(t: torch.Tensor, H: int) -> torch.Tensor:
    KV = t.shape[1]
    return t if KV == H else t.repeat_interleave(H // KV, dim=1)


def reference_attention(q, k, v, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        window: int = 0) -> torch.Tensor:
    """[B,H,S,D] attention with a plain softmax in fp32 (the reference's
    ground truth); differentiable by torch's autograd."""
    H = q.shape[1]
    k, v = _expand_kv(k, H), _expand_kv(v, H)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = _visible(q.shape[2], causal, segment_ids, window, q.device)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)


def _masked(s: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return s
    return torch.where(mask, s, torch.full_like(s, NEG_INF))


def _flash_fwd_plain(q, k, v, causal: bool = True,
                     segment_ids: Optional[torch.Tensor] = None,
                     window: int = 0):
    """``(out, lse)`` as ``_flash_fwd`` computes them: ``out`` in q's
    dtype, ``lse`` fp32 ``[B, H, S]``."""
    H, D = q.shape[1], q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    kf, vf = _expand_kv(k, H).float(), _expand_kv(v, H).float()
    s = torch.matmul(q.float() * scale, kf.transpose(-1, -2))
    s = _masked(s, _visible(q.shape[2], causal, segment_ids, window,
                            q.device))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l_safe = torch.clamp_min(p.sum(dim=-1), 1e-30)
    out = (torch.matmul(p, vf) / l_safe[..., None]).to(q.dtype)
    return out, m + torch.log(l_safe)


def _bwd_parts(q, k, v, g, lse, delta, causal, segment_ids, window,
               want_dq: bool, want_dkv: bool):
    """The recompute-based backward of ``_flash_bwd_pallas`` from the
    saved ``lse`` and a given ``delta``: ``(dq or None, dk or None, dv or
    None)``."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    scale = 1.0 / math.sqrt(D)
    qf, gf = q.float(), g.float()
    kf, vf = _expand_kv(k, H).float(), _expand_kv(v, H).float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = _masked(s, _visible(S, causal, segment_ids, window, q.device))
    p = torch.exp(s - lse.float()[..., None])
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = dk = dv = None
    if want_dq:
        dq = torch.matmul(ds, kf).to(q.dtype)
    if want_dkv:
        rep = H // KV
        dk = torch.matmul(ds.transpose(-1, -2), qf)
        dv = torch.matmul(p.transpose(-1, -2), gf)
        dk = dk.view(B, KV, rep, S, D).sum(dim=2).to(k.dtype)
        dv = dv.view(B, KV, rep, S, D).sum(dim=2).to(v.dtype)
    return dq, dk, dv


def _delta(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """``rowsum(out · g)`` in fp32 from the stored ``out``."""
    return torch.sum(out.float() * g.float(), dim=-1)


def _flash_bwd_plain(q, k, v, out, lse, g, causal: bool = True,
                     segment_ids: Optional[torch.Tensor] = None,
                     window: int = 0):
    """``(dq, dk, dv)`` as ``_flash_bwd_pallas`` computes them."""
    return _bwd_parts(q, k, v, g, lse, _delta(out, g), causal, segment_ids,
                      window, True, True)


def _plain_fwd(q, k, v, *, causal, segment_ids, window):
    return _flash_fwd_plain(q, k, v, causal, segment_ids, window)


def _plain_dq(q, k, v, g, lse, delta, *, causal, segment_ids, window):
    return _bwd_parts(q, k, v, g, lse, delta, causal, segment_ids, window,
                      True, False)[0]


def _plain_dkv(q, k, v, g, lse, delta, *, causal, segment_ids, window):
    return _bwd_parts(q, k, v, g, lse, delta, causal, segment_ids, window,
                      False, True)[1:]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def build() -> None:
    """Compile (if needed) and load the kernels' library."""
    _lib()


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.load("flash_attention", SOURCES)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    shape = [i, i, i, i, i, i, i, ctypes.c_float, i, p]
    lib.dlr_flash_fwd.argtypes = [p] * 6 + [ctypes.POINTER(ll)] + shape
    lib.dlr_flash_bwd_dq.argtypes = [p] * 8 + [ctypes.POINTER(ll)] + shape
    lib.dlr_flash_bwd_dkv.argtypes = [p] * 9 + [ctypes.POINTER(ll)] + shape
    lib.dlr_wgmma_tile_probe.argtypes = [p] * 6
    for fn in (lib.dlr_flash_fwd, lib.dlr_flash_bwd_dq,
               lib.dlr_flash_bwd_dkv, lib.dlr_wgmma_tile_probe):
        fn.restype = ctypes.c_int
    return lib


def _device_of(q: torch.Tensor, name: str) -> str:
    if q.device.type in ("cpu", "cuda"):
        return q.device.type
    raise ValueError(
        f"{name} runs on cuda (kernel) or cpu (plain), got {q.device}"
    )


def check_shapes(q, k, v, causal: bool, window: int) -> None:
    """The reference's checks (``H % KV == 0``, a window needs causal)
    and matching shapes."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [B, H, S, D] q, k and v")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(
            f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match q "
            f"{tuple(q.shape)}"
        )
    if H % k.shape[1] != 0:
        raise ValueError(f"GQA needs H % KV == 0, got H={H} KV={k.shape[1]}")
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal attention")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t with a unit stride on the last dim (a copy only when needed)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _kernel_args(q, k, v, causal, segment_ids, window, tensors):
    """Validate for the kernels; returns ``(seg, strides, shape args)``."""
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"flash kernels take float32 or bfloat16, got {q.dtype}"
        )
    if D > MAX_HEAD_DIM or D % 8 != 0:
        raise ValueError(
            f"flash kernels take a head dim <= {MAX_HEAD_DIM} that is a "
            f"multiple of 8, got {D}"
        )
    if B * H > 65535 or S == 0:
        raise ValueError(f"flash kernels: unsupported shape {tuple(q.shape)}")
    for t in tensors:
        if t.dtype != q.dtype or t.device != q.device or t.stride(-1) != 1:
            raise ValueError(
                "flash kernels need q, k, v (and g) of one dtype on one "
                "device with a unit last-dim stride"
            )
    seg = None
    if segment_ids is not None:
        if tuple(segment_ids.shape) != (B, S):
            raise ValueError(
                f"segment_ids must be [B, S] = {(B, S)}, got "
                f"{tuple(segment_ids.shape)}"
            )
        seg = segment_ids.to(device=q.device, dtype=torch.int32).contiguous()
    vals = []
    for t in tensors:
        vals += [t.stride(0), t.stride(1), t.stride(2)]
    strides = (ctypes.c_longlong * len(vals))(*vals)
    shape = (B, H, k.shape[1], S, D, int(causal), int(window),
             1.0 / math.sqrt(D), _DTYPE_CODES[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    return seg, strides, shape


def _check_copy_aligned(tensors, name: str) -> None:
    """The tensor-core kernels copy 16 bytes (8 bf16) at a time: every
    input's base pointer and (b, h, s) strides must keep that alignment."""
    for t in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]):
            raise ValueError(
                f"{name}: bf16 inputs need a 16-byte aligned base and "
                f"(b, h, s) strides that are multiples of 8 elements, got "
                f"strides {t.stride()} at offset {t.data_ptr() % 16} mod 16"
            )


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def flash_fwd(q, k, v, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None, window: int = 0):
    """``(out, lse)``: the forward kernel for CUDA tensors (bf16: the
    tensor-core ``flash_fwd_wgmma``; fp32: the CUDA-core kernel), the plain
    version for CPU tensors.  ``out`` is laid out ``[B, S, H, D]`` in
    memory and returned as a ``[B, H, S, D]`` view."""
    kw = dict(causal=causal, segment_ids=segment_ids, window=window)
    check_shapes(q, k, v, causal, window)
    if _device_of(q, "flash_fwd") == "cpu":
        return _plain_fwd(q, k, v, **kw)
    q, k, v = _rows(q), _rows(k), _rows(v)
    B, H, S, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    seg, strides, shape = _kernel_args(q, k, v, causal, segment_ids, window,
                                       (q, k, v, out))
    if q.dtype == torch.bfloat16:
        _check_copy_aligned((q, k, v), "flash_fwd")
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), lse.data_ptr(), _ptr(seg),
                               strides, *shape)
    _check_rc(rc, "flash forward")
    flash_fwd.launches += 1
    return out, lse


def flash_dq(q, k, v, g, lse, delta, *, causal: bool = True,
             segment_ids: Optional[torch.Tensor] = None, window: int = 0):
    """dq (in q's dtype): the dq kernel for CUDA tensors (bf16: the
    tensor-core ``flash_dq_wgmma``; fp32: the CUDA-core kernel), the plain
    version for CPU tensors."""
    kw = dict(causal=causal, segment_ids=segment_ids, window=window)
    check_shapes(q, k, v, causal, window)
    if _device_of(q, "flash_dq") == "cpu":
        return _plain_dq(q, k, v, g, lse, delta, **kw)
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    lse, delta = _stats(lse, q), _stats(delta, q)
    dq = torch.empty_like(q)
    seg, strides, shape = _kernel_args(q, k, v, causal, segment_ids, window,
                                       (q, k, v, g, dq))
    if q.dtype == torch.bfloat16:
        _check_copy_aligned((q, k, v, g), "flash_dq")
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_bwd_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  g.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), _ptr(seg), dq.data_ptr(),
                                  strides, *shape)
    _check_rc(rc, "flash dq")
    flash_dq.launches += 1
    return dq


def flash_dkv(q, k, v, g, lse, delta, *, causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None, window: int = 0):
    """``(dk, dv)`` at KV-head size in k's dtype: the dk/dv kernel for CUDA
    tensors (bf16: the tensor-core ``flash_dkv_wgmma``; fp32: the CUDA-core
    kernel), the plain version for CPU tensors."""
    kw = dict(causal=causal, segment_ids=segment_ids, window=window)
    check_shapes(q, k, v, causal, window)
    if _device_of(q, "flash_dkv") == "cpu":
        return _plain_dkv(q, k, v, g, lse, delta, **kw)
    q, k, v, g = _rows(q), _rows(k), _rows(v), _rows(g)
    lse, delta = _stats(lse, q), _stats(delta, q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    seg, strides, shape = _kernel_args(q, k, v, causal, segment_ids, window,
                                       (q, k, v, g, dk, dv))
    if q.dtype == torch.bfloat16:
        _check_copy_aligned((q, k, v, g), "flash_dkv")
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.dlr_flash_bwd_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   g.data_ptr(), lse.data_ptr(),
                                   delta.data_ptr(), _ptr(seg),
                                   dk.data_ptr(), dv.data_ptr(), strides,
                                   *shape)
    _check_rc(rc, "flash dk/dv")
    flash_dkv.launches += 1
    return dk, dv


def _stats(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """A per-row fp32 ``[B, H, S]`` statistic (lse or delta), contiguous,
    on q's device."""
    B, H, S, _ = q.shape
    if tuple(t.shape) != (B, H, S) or t.dtype != torch.float32 \
            or t.device != q.device:
        raise ValueError(
            f"lse/delta must be float32 [{B}, {H}, {S}] on {q.device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


flash_fwd.launches = 0
flash_dq.launches = 0
flash_dkv.launches = 0


def wgmma_tile_probe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """``(s, o)`` from the tensor-core kernels' layout probe on one tile:
    contiguous bf16 ``[64, 64]`` CUDA q, k, v; ``s = q·kᵀ`` as the wgmma
    accumulator holds it and ``o = hi(s)·v + lo(s)·v`` with A taken from
    those registers, both fp32 ``[64, 64]``.  A test hook of the
    shared-memory layout and of the accumulator-to-A-fragment step; no path
    calls it."""
    for t in (q, k, v):
        if t.shape != (64, 64) or t.dtype != torch.bfloat16 \
                or t.device.type != "cuda" or not t.is_contiguous():
            raise ValueError("the probe takes contiguous bf16 [64, 64] "
                             "CUDA tensors")
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty_like(s)
    with torch.cuda.device(q.device):
        rc = _lib().dlr_wgmma_tile_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), torch.cuda.current_stream(q.device).cuda_stream)
    _check_rc(rc, "wgmma tile probe")
    return s, o


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class Impl(NamedTuple):
    """One implementation of the three steps: forward → ``(out, lse)``;
    ``dq(q, k, v, g, lse, delta, ...)``; ``dkv(...)`` → ``(dk, dv)``."""

    fwd: object
    dq: object
    dkv: object


WRAPPERS = Impl(flash_fwd, flash_dq, flash_dkv)
#: The plain versions on any device: the card's comparison runs only.
PLAIN = Impl(_plain_fwd, _plain_dq, _plain_dkv)


class FlashAttention(torch.autograd.Function):
    """Forward saves ``out`` and the fp32 ``lse``; backward computes
    ``delta`` from the stored ``out`` and runs dq, then dk/dv."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, window, impl):
        out, lse = impl.fwd(q, k, v, causal=causal, segment_ids=segment_ids,
                            window=window)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids)
        ctx.causal, ctx.window, ctx.impl = causal, window, impl
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, seg = ctx.saved_tensors
        kw = dict(causal=ctx.causal, segment_ids=seg, window=ctx.window)
        delta = _delta(out, g)
        dq = ctx.impl.dq(q, k, v, g, lse, delta, **kw)
        dk, dv = ctx.impl.dkv(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    bwd_block_q: int = DEFAULT_BWD_BLOCK_Q,
                    bwd_block_k: int = DEFAULT_BWD_BLOCK_K,
                    backend: Optional[str] = None,
                    interpret: bool = False,
                    window: int = 0) -> torch.Tensor:
    """[B, H, S, D] flash attention, differentiable in q, k and v.

    GQA: k/v may carry ``KV < H`` heads (``H % KV == 0``); dk/dv come back
    ``[B, KV, S, D]``.  ``segment_ids`` [B, S] restricts attention to
    same-segment pairs; ``window > 0`` (causal only) keeps ``0 <= q - k <
    window``.  Kernels for CUDA tensors, plain versions for CPU tensors.

    ``backend`` takes the reference's values (``ops/_backend.py``):
    ``"pallas"`` runs the kernels or raises, ``"reference"`` is
    :func:`reference_attention`, as in the reference; ``interpret=True``
    raises.  The tile keywords take the reference's defaults only: the
    CUDA kernels' tiles are fixed (:data:`CUDA_TILES`)."""
    for name, got, want in (("block_q", block_q, DEFAULT_BLOCK_Q),
                            ("block_k", block_k, DEFAULT_BLOCK_K),
                            ("bwd_block_q", bwd_block_q, DEFAULT_BWD_BLOCK_Q),
                            ("bwd_block_k", bwd_block_k,
                             DEFAULT_BWD_BLOCK_K)):
        if got != want:
            raise ValueError(
                f"flash_attention({name}={got}): the CUDA kernels' tiles are "
                f"fixed ({CUDA_TILES}); {name} takes only the reference's "
                f"default {want}"
            )
    check_shapes(q, k, v, causal, window)
    if backend is None and not interpret:
        _device_of(q, "flash_attention")
    elif not _backend.use_kernel(backend, interpret, q, "flash_attention"):
        return reference_attention(q, k, v, causal, segment_ids, window)
    return FlashAttention.apply(q, k, v, segment_ids, causal, int(window),
                                WRAPPERS)
