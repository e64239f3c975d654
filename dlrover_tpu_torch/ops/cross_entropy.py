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
a CUDA tensor it launches the kernel or raises.  The kernel has two routes,
chosen by :func:`route` from the logits' shape alone:

- ``"cluster"`` (``xent_cluster_kernel``): a thread-block cluster of up
  to :data:`CLUSTER` CTAs owns a row and reads each logit from device
  memory once, staged in shared memory (at most :data:`SLICE_BYTES` a CTA;
  the cluster has as few CTAs as that allows).  It takes every row whose
  ``V`` elements fit :data:`CLUSTER` x :data:`SLICE_BYTES` (V <= 65536
  fp32, 131072 bf16), at up to ``2**31 / 8`` rows;
- ``"two_pass"`` (``xent_fwd_kernel``): one block a row that reads it
  twice, for wider rows (or more rows).

A route is not a fallback: the wrapper launches the one the shape names,
and a failed build or launch raises.  ``xent_fwd.launches`` counts the
launches and ``xent_fwd.route_launches`` the launches of each route.  The
launch takes the lean host call of ``ops/_launch.py``.
"""

from __future__ import annotations

import functools

import torch

from dlrover_tpu_torch.ops import _launch
from dlrover_tpu_torch.ops._launch import INT_MAX, LO

SOURCES = ("cross_entropy.cu", "launch.cuh")
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_LABEL_CODES = {torch.int32: 0, torch.int64: 1}
DEFAULT_CHUNK_ROWS = 1024
# The cluster route: CTAs a row at most, and the shared memory a CTA holds
# of it at most (``kMaxCluster`` and ``kSliceBytes`` in
# csrc/cross_entropy.cu).
CLUSTER = 8
SLICE_BYTES = 32 * 1024
ROUTES = ("cluster", "two_pass")  # the entry point's route codes 0 and 1


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
    return _launch.bind("cross_entropy", SOURCES, "dlr_xent_fwd")


def route(rows: int, V: int, element_size: int) -> str:
    """The kernel route for ``rows`` rows of ``V`` logits of
    ``element_size`` bytes (see the module docstring)."""
    if V * element_size <= CLUSTER * SLICE_BYTES and \
            rows <= INT_MAX // CLUSTER:
        return "cluster"
    return "two_pass"


def _launch_kernel(logits: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Checks (cheapest first), a fresh output, one launch of the shape's
    route on the caller's stream for the logits' device."""
    code = _DTYPE_CODES.get(logits.dtype)
    if code is None:
        raise TypeError(
            f"cross-entropy kernel takes float32 or bfloat16 logits, got "
            f"{logits.dtype}"
        )
    label64 = _LABEL_CODES.get(labels.dtype)
    if label64 is None:
        raise TypeError(
            f"cross-entropy kernel takes int32 or int64 labels, got "
            f"{labels.dtype}"
        )
    shape = logits.shape
    V = shape[-1] if shape else 0
    if V == 0 or labels.shape != shape[:-1]:
        raise ValueError(
            f"cross-entropy: logits {tuple(shape)} and labels "
            f"{tuple(labels.shape)} do not match"
        )
    dev = logits.get_device()
    if labels.get_device() != dev:
        raise ValueError(
            f"labels on {labels.device}, logits on {logits.device}"
        )
    if not logits.is_contiguous():
        raise ValueError("cross-entropy kernel needs contiguous logits")
    labels = labels.contiguous()
    loss = torch.empty_like(labels, dtype=torch.float32)
    rows = logits.numel() // V
    if rows == 0:
        return loss
    if rows > INT_MAX or V > INT_MAX:
        raise ValueError(
            f"cross-entropy kernel: logits {tuple(shape)} are too large")
    which = route(rows, V, logits.element_size())
    fn = _kernel_fn()
    xp, lp, op, st = logits.data_ptr(), labels.data_ptr(), loss.data_ptr(), \
        _launch.stream(dev)
    rc = fn(xp & LO, xp >> 32, lp & LO, lp >> 32, op & LO, op >> 32, rows, V,
            code, label64, ROUTES.index(which), dev, st & LO, st >> 32)
    if rc != 0:
        raise RuntimeError(
            f"cross-entropy kernel ({which}) launch failed: CUDA error {rc}"
        )
    xent_fwd.launches += 1
    xent_fwd.route_launches[which] += 1
    return loss


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row loss (fp32): the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if logits.is_cuda:
        return _launch_kernel(logits, labels)
    if logits.is_cpu:
        return _reference(logits, labels)
    raise ValueError(
        f"cross-entropy runs on cuda (kernel) or cpu (plain), got "
        f"{logits.device}"
    )


xent_fwd.launches = 0
xent_fwd.route_launches = dict.fromkeys(ROUTES, 0)


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
