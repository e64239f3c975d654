"""Softmax cross-entropy: a hand-written CUDA forward kernel, its plain
PyTorch version, and the chunked fused lm-head cross-entropy.

Held against ``dlrover_tpu/ops/cross_entropy.py``:

- :func:`_reference` is its ``_reference``; the CUDA kernel
  ``csrc/cross_entropy.cu`` replaces its Pallas ``_kernel`` (launched by
  ``_pallas_loss``): per row ``logsumexp − logit[label]`` in fp32, the
  target picked by an index compare as ``onehot`` does (a label outside
  ``[0, V)`` selects nothing, so the target is 0);
- :func:`softmax_cross_entropy` is its ``softmax_cross_entropy``: an
  autograd function whose forward is the kernel's wrapper
  :func:`xent_fwd` and whose backward is the closed form ``(softmax −
  onehot)·g`` cast to the logits' dtype, in plain PyTorch (the reference
  has no backward kernel);
- :func:`linear_softmax_cross_entropy` is its
  ``linear_softmax_cross_entropy`` (``_linear_xent`` and its backward):
  plain PyTorch, chunked over rows (``chunk_rows=1024``, the last chunk
  zero-padded), recomputing each chunk's logits in the backward and
  summing dw in fp32.  Its products stay ``torch.matmul``, as the
  reference leaves them to XLA outside any kernel.  The reference's
  ``jnp.dot(x, w, preferred_element_type=float32)`` multiplies bf16
  operands into fp32 logits with no bf16 rounding; a bf16
  ``torch.matmul`` would round its output to bf16.  The port upcasts both
  operands to fp32 first: a product of two bf16 values is exact in fp32,
  so the logits are the reference's up to the order of the fp32 sum.

:func:`xent_fwd` runs the plain version only for a tensor on the CPU; for
a CUDA tensor it launches the kernel or raises.  ``xent_fwd.launches``
counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dlrover_tpu_torch.ops import _build

SOURCES = ("cross_entropy.cu",)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}
DEFAULT_CHUNK_ROWS = 1024


def _target(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``sum(where(iota == label, logits, 0))``: the label's logit, or 0
    for a label outside ``[0, V)``."""
    V = logits.shape[-1]
    inside = (labels >= 0) & (labels < V)
    idx = torch.where(inside, labels, torch.zeros_like(labels)).long()
    picked = torch.gather(logits, -1, idx[..., None])[..., 0]
    return torch.where(inside, picked, torch.zeros_like(picked))


def _reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``logsumexp − logit[label]`` in fp32 (the Pallas kernel's
    arithmetic: max, then the log of the sum of shifted exponentials)."""
    x = logits.float()
    m = x.amax(dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(x - m[..., None]), dim=-1))
    return lse - _target(x, labels)


def _onehot(labels: torch.Tensor, V: int) -> torch.Tensor:
    iota = torch.arange(V, device=labels.device)
    return (iota == labels[..., None]).float()


def _backward(logits: torch.Tensor, labels: torch.Tensor,
              g: torch.Tensor) -> torch.Tensor:
    """``(softmax − onehot)·g`` in fp32, cast to the logits' dtype."""
    p = torch.softmax(logits.float(), dim=-1)
    dlogits = (p - _onehot(labels, logits.shape[-1])) * g.float()[..., None]
    return dlogits.to(logits.dtype)


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _kernel_fn()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.load("cross_entropy", SOURCES).dlr_xent_fwd
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"cross-entropy kernel takes float32 or bfloat16 logits, got "
            f"{logits.dtype}"
        )
    if labels.dtype not in _LABEL_CODES:
        raise TypeError(
            f"cross-entropy kernel takes int32 or int64 labels, got "
            f"{labels.dtype}"
        )
    V = logits.shape[-1] if logits.dim() else 0
    if V == 0 or tuple(labels.shape) != tuple(logits.shape[:-1]):
        raise ValueError(
            f"cross-entropy: logits {tuple(logits.shape)} and labels "
            f"{tuple(labels.shape)} do not match"
        )
    if labels.device != logits.device:
        raise ValueError(
            f"labels on {labels.device}, logits on {logits.device}"
        )
    if not logits.is_contiguous():
        raise ValueError("cross-entropy kernel needs contiguous logits")
    labels = labels.contiguous()
    rows = logits.numel() // V
    loss = torch.empty(labels.shape, dtype=torch.float32,
                       device=logits.device)
    if rows == 0:
        return loss
    if rows > 0x7fffffff:
        raise ValueError(f"cross-entropy kernel: {rows} rows is too many")
    fn = _kernel_fn()
    with torch.cuda.device(logits.device):
        rc = fn(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), rows, V,
            _DTYPE_CODES[logits.dtype], _LABEL_CODES[labels.dtype],
            torch.cuda.current_stream(logits.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"cross-entropy kernel launch failed: CUDA error {rc}"
        )
    xent_fwd.launches += 1
    return loss


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row loss (fp32): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if logits.device.type == "cpu":
        return _reference(logits, labels)
    if logits.device.type != "cuda":
        raise ValueError(
            f"cross-entropy runs on cuda (kernel) or cpu (plain), got "
            f"{logits.device}"
        )
    return _launch(logits, labels)


xent_fwd.launches = 0


class SoftmaxCrossEntropy(torch.autograd.Function):
    """``forward_fn`` (:func:`xent_fwd`, or the plain version in the
    card's comparison runs) forward, the closed form backward."""

    @staticmethod
    def forward(ctx, logits, labels, forward_fn):
        ctx.save_for_backward(logits, labels)
        return forward_fn(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return _backward(logits, labels, g), None, None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """[..., V] logits × [...] int labels → [...] per-token loss (fp32)."""
    return SoftmaxCrossEntropy.apply(logits, labels, xent_fwd)


# ---------------------------------------------------------------------------
# Fused lm-head + cross-entropy (plain PyTorch, as the reference is plain
# JAX): the [tokens, vocab] logits exist one chunk at a time.
# ---------------------------------------------------------------------------


def _chunks(x2: torch.Tensor, labels: torch.Tensor, chunk_rows: int):
    """Zero-pad the rows to a multiple of ``chunk_rows``; returns
    ``(xs [n, chunk, D], ls [n, chunk], pad)``."""
    R = x2.shape[0]
    n = max(1, -(-R // chunk_rows))
    pad = n * chunk_rows - R
    if pad:
        x2 = torch.cat([x2, x2.new_zeros((pad, x2.shape[1]))])
        labels = torch.cat([labels, labels.new_zeros((pad,))])
    return (x2.reshape(n, chunk_rows, x2.shape[1]),
            labels.reshape(n, chunk_rows), pad)


def _chunk_logits(x_c: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """fp32 logits of a chunk with no rounding of the products (see the
    module docstring)."""
    return torch.matmul(x_c.float(), w.float())


class _LinearXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, w, labels, chunk_rows):
        xs, ls, pad = _chunks(x2, labels, chunk_rows)
        losses = []
        for x_c, l_c in zip(xs, ls):
            logits = _chunk_logits(x_c, w)
            m = logits.amax(dim=-1)
            lse = m + torch.log(
                torch.sum(torch.exp(logits - m[:, None]), dim=-1))
            losses.append(lse - _target(logits, l_c))
        loss = torch.cat(losses)
        ctx.save_for_backward(x2, w, labels)
        ctx.chunk_rows = chunk_rows
        return loss[: x2.shape[0]] if pad else loss

    @staticmethod
    def backward(ctx, g):
        x2, w, labels = ctx.saved_tensors
        R = x2.shape[0]
        xs, ls, pad = _chunks(x2, labels, ctx.chunk_rows)
        g = g.float()
        if pad:
            g = torch.cat([g, g.new_zeros((pad,))])
        gs = g.reshape(ls.shape)
        wf = w.float()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dxs = []
        for x_c, l_c, g_c in zip(xs, ls, gs):
            logits = _chunk_logits(x_c, wf)
            p = torch.softmax(logits, dim=-1)
            dlogits = (p - _onehot(l_c, logits.shape[-1])) * g_c[:, None]
            # jnp.dot(dlogits.astype(w.dtype), w.T, fp32): round dlogits
            # to w's dtype, then an exact product summed in fp32.
            dx_c = torch.matmul(dlogits.to(w.dtype).float(), wf.t())
            dw += torch.matmul(x_c.float().t(), dlogits)
            dxs.append(dx_c.to(x2.dtype))
        dx = torch.cat(dxs)[:R]
        return dx, dw.to(w.dtype), None, None


def linear_softmax_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                                 labels: torch.Tensor, *,
                                 chunk_rows: int = DEFAULT_CHUNK_ROWS
                                 ) -> torch.Tensor:
    """Fused ``softmax_cross_entropy(x @ w, labels)`` per-token loss.

    x: [..., D] activations, w: [D, V] lm head, labels: [...] int; returns
    fp32 [...] without materialising the [..., V] logits (one
    [chunk_rows, V] fp32 block at a time)."""
    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    shape = labels.shape
    out = _LinearXent.apply(x.reshape(-1, x.shape[-1]), w,
                            labels.reshape(-1), chunk_rows)
    return out.reshape(shape)
