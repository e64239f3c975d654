"""The collectives of a sharded step: all-gather of a leaf's boxes,
reduce-scatter of its gradient back to the boxes, and all-reduce over the
batch group; and the two of sequence-parallel attention: the ring hop
(:func:`ring_hop`, the reference's ``jax.lax.ppermute`` to the next rank
of the axis, ``dlrover_tpu/parallel/ring_attention.py:102``) and the tiled
all-to-all (:func:`all_to_all`, ``jax.lax.all_to_all(..., tiled=True)``,
``dlrover_tpu/parallel/sequence.py:66``).  The reference gets these from
XLA (GSPMD inserts them, and JAX differentiates the last two itself); the
port calls them explicitly, the last two as autograd functions whose
backward is the inverse collective.

The path is chosen from the group's backend and the tensor's device, never
by catching a failure:

- ``nccl`` (a card a process): ``all_gather_into_tensor``,
  ``reduce_scatter_tensor`` and ``all_reduce`` on the card's tensors;
- ``gloo`` with card tensors (processes that share one card): the tensor
  is copied to page-locked host memory (one synchronise), the list form
  of ``all_gather`` or ``all_reduce`` runs there, and the result is copied
  back.  Gloo's reduce-scatter differs between torch releases, so the
  ``gloo`` reduce-scatter all-reduces the gradient over the batch group
  and keeps this rank's box;
- ``gloo`` with CPU tensors: the same collectives on the tensors.

Every call adds to :data:`STATS` (calls, bytes of this rank's output,
host milliseconds) under its kind (a ring hop counts the bytes it
receives, an all-to-all the bytes of its output); :func:`snapshot` reads them and
:func:`stats_delta` gives what changed since a snapshot.  An ``nccl`` call returns once it
is queued, so its host time is not its time: with :data:`TIME_DEVICE` set,
each call on a card tensor also records CUDA events around it on the
current stream, and :func:`take_device_ms` (which synchronises) gives
the milliseconds that stream spent in each kind since the last call.

:class:`LeafComm` is one leaf's plan (its gather group and the boxes of
the group's ranks, its reduction groups) and :func:`gather` the autograd
function: forward gathers the whole leaf from the boxes, backward returns
this rank's box of the global-batch mean gradient:
``(1 / |B|) * sum`` over the batch group ``B`` of each rank's gradient of
the whole leaf.  ``B`` is the group of the reduction axes: the batch axes
and, under sequence parallelism, ``tp``, whose ranks compute different
positions.  Ranks that differ only on axes outside ``B`` (``tp`` when it
is not a sequence axis) computed on the same rows, so their gradients are
equal and are not summed.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from dlrover_tpu_torch.parallel.mesh import AXIS_ORDER
from dlrover_tpu_torch.parallel.sharding import Placement, box_slices

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "ring_hop",
         "all_to_all")
STATS: Dict[str, Dict[str, float]] = {
    k: {"calls": 0, "bytes": 0, "ms": 0.0} for k in KINDS}
#: Record CUDA events around each collective on a card tensor.
TIME_DEVICE = False
_EVENTS: list = []  # (kind, start event, end event)


def snapshot() -> Dict[str, Dict[str, float]]:
    return {k: dict(v) for k, v in STATS.items()}


def _begin(t: torch.Tensor):
    if TIME_DEVICE and t.is_cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return None


def _note(kind: str, nbytes: int, t0: float, ev=None) -> None:
    st = STATS[kind]
    st["calls"] += 1
    st["bytes"] += int(nbytes)
    st["ms"] += (time.perf_counter() - t0) * 1e3
    if ev is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        _EVENTS.append((kind, ev, end))


def take_device_ms() -> Dict[str, float]:
    """Milliseconds the current stream spent in each kind of collective
    since the last call (``TIME_DEVICE``; synchronises)."""
    out = dict.fromkeys(KINDS, 0.0)
    if _EVENTS:
        torch.cuda.synchronize()
    for kind, a, b in _EVENTS:
        out[kind] += a.elapsed_time(b)
    _EVENTS.clear()
    return out


def via_host(t: torch.Tensor, group) -> bool:
    """Card tensors under ``gloo`` go through page-locked host memory."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    torch.cuda.synchronize(t.device)
    return h


def all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t`` in the group's rank order."""
    t = t.contiguous()
    t0, ev = time.perf_counter(), _begin(t)
    if via_host(t, group):
        h = _to_host(t)
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype,
                          pin_memory=True)
        dist.all_gather(list(out.unbind(0)), h, group=group)
        res = out.to(t.device, non_blocking=True)
    elif t.is_cuda:
        # The flat (concatenated) form: every backend and release takes it.
        flat = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(flat, t.reshape(-1), group=group)
        res = flat.view((n,) + tuple(t.shape))
    else:
        res = torch.empty((n,) + tuple(t.shape), dtype=t.dtype)
        dist.all_gather(list(res.unbind(0)), t, group=group)
    _note("all_gather", res.numel() * res.element_size(), t0, ev)
    return res


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over the group, in place."""
    t0, ev = time.perf_counter(), _begin(t)
    if via_host(t, group):
        h = _to_host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h, non_blocking=True)
    else:
        dist.all_reduce(t, group=group)
    _note("all_reduce", t.numel() * t.element_size(), t0, ev)
    return t


def reduce_scatter(chunks: torch.Tensor, group) -> torch.Tensor:
    """``chunks`` ``[n, k]`` (chunk ``i`` for the group's rank ``i``) ->
    this rank's ``[k]``, summed over the group (``nccl`` only)."""
    t0, ev = time.perf_counter(), _begin(chunks)
    out = torch.empty(chunks.shape[1:], dtype=chunks.dtype,
                      device=chunks.device)
    dist.reduce_scatter_tensor(out, chunks.contiguous().reshape(-1),
                               group=group)
    _note("reduce_scatter", out.numel() * out.element_size(), t0, ev)
    return out


class LeafComm:
    """One sharded leaf's collectives on its mesh, given the batch axes."""

    def __init__(self, placement: Placement, batch_axes: Sequence[str]):
        mesh = placement.mesh
        self.placement = placement
        self.box = placement.box()
        self.shape = placement.global_shape
        axes = placement.axes
        self.gather_group = mesh.group(axes)
        self.gather_members = sorted(mesh.members(axes))
        self.gather_boxes = [placement.box(r) for r in self.gather_members]
        batch = [a for a in AXIS_ORDER if a in batch_axes
                 and mesh.axis_size(a) > 1]
        self.batch_size = mesh.axes_size(batch)
        self.batch_group = mesh.group(batch)
        # nccl: reduce-scatter over the batch axes that shard the leaf,
        # all-reduce over the batch axes that do not.
        rs_axes = [a for a in batch if a in axes]
        ar_axes = [a for a in batch if a not in axes]
        self.rs_group = mesh.group(rs_axes)
        self.rs_members = sorted(mesh.members(rs_axes))
        self.rs_boxes = [placement.box(r) for r in self.rs_members]
        self.ar_group = mesh.group(ar_axes)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        n = len(self.gather_members)
        parts = all_gather(local, self.gather_group, n)
        full = torch.empty(self.shape, dtype=local.dtype,
                           device=local.device)
        for box, part in zip(self.gather_boxes, parts.unbind(0)):
            full[box_slices(box)] = part
        return full

    def reduce(self, g: torch.Tensor) -> torch.Tensor:
        """This rank's box of the batch-group mean of the whole-leaf
        gradients ``g``."""
        group = self.batch_group
        if group is not None and dist.get_backend(group) == "gloo":
            all_reduce_(g, group)
            out = g[box_slices(self.box)].contiguous()
        else:
            if self.rs_group is not None:
                chunks = torch.stack([g[box_slices(b)].reshape(-1)
                                      for b in self.rs_boxes])
                out = reduce_scatter(chunks, self.rs_group).view(
                    tuple(e - s for s, e in self.box))
            else:
                out = g[box_slices(self.box)].contiguous()
            if self.ar_group is not None:
                all_reduce_(out, self.ar_group)
        if self.batch_size > 1:
            out.div_(self.batch_size)
        return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, comm):
        ctx.comm = comm
        return comm.gather(local.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce(g.contiguous().clone()), None


def gather(local: torch.Tensor, comm: Optional[LeafComm]) -> torch.Tensor:
    """The whole leaf from this rank's box (the box itself when the leaf is
    not sharded); its gradient reaches the box reduced as above."""
    if comm is None:
        return local
    return _Gather.apply(local, comm)


def _p2p(send: torch.Tensor, dst: int, src: int, group) -> torch.Tensor:
    """Send ``send`` to global rank ``dst`` and receive a tensor of its
    shape and type from global rank ``src``, both at once."""
    send = send.contiguous()
    t0, ev = time.perf_counter(), _begin(send)
    host = via_host(send, group)
    out = torch.empty_like(send, device="cpu", pin_memory=True) \
        if host else torch.empty_like(send)
    src_t = _to_host(send) if host else send
    ops = [dist.P2POp(dist.isend, src_t, dst, group=group),
           dist.P2POp(dist.irecv, out, src, group=group)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    res = out.to(send.device, non_blocking=True) if host else out
    _note("ring_hop", res.numel() * res.element_size(), t0, ev)
    return res


class _RingHop(torch.autograd.Function):
    """Forward: send to the next rank of the ring, receive from the
    previous one; backward: the reverse hop of the gradient."""

    @staticmethod
    def forward(ctx, x, group, nxt, prev):
        ctx.group, ctx.nxt, ctx.prev = group, nxt, prev
        return _p2p(x.detach(), nxt, prev, group)

    @staticmethod
    def backward(ctx, g):
        return _p2p(g, ctx.prev, ctx.nxt, ctx.group), None, None, None


def ring_hop(x: torch.Tensor, group, nxt: int, prev: int) -> torch.Tensor:
    """``x`` of the rank ``prev`` (global ranks), ``x`` itself going to
    ``nxt``: one step of ``ppermute`` with ``perm = [(j, j + 1 mod n)]``
    over the ring ``group``."""
    return _RingHop.apply(x, group, nxt, prev)


def _a2a(x: torch.Tensor, group, order: Sequence[int], split_dim: int,
         concat_dim: int) -> torch.Tensor:
    """``x`` cut into ``n`` equal chunks along ``split_dim``, chunk ``j``
    sent to the rank at place ``j`` of the axis, the received chunks
    joined along ``concat_dim`` in the axis's order.  ``order[j]`` is the
    group rank of the axis's place ``j``."""
    n = len(order)
    chunks = list(x.chunk(n, dim=split_dim))
    send = torch.stack([chunks[order.index(g)] for g in range(n)])
    t0, ev = time.perf_counter(), _begin(send)
    if via_host(send, group):
        h = _to_host(send)
        out = torch.empty_like(h, pin_memory=True)
        dist.all_to_all_single(out, h, group=group)
        out = out.to(x.device, non_blocking=True)
    else:
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send.contiguous(), group=group)
    _note("all_to_all", out.numel() * out.element_size(), t0, ev)
    parts = out.unbind(0)
    return torch.cat([parts[order[j]] for j in range(n)], dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, order, split_dim, concat_dim):
        ctx.args = (group, order, split_dim, concat_dim)
        return _a2a(x.detach(), group, order, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, order, split_dim, concat_dim = ctx.args
        return (_a2a(g.contiguous(), group, order, concat_dim, split_dim),
                None, None, None, None)


def all_to_all(x: torch.Tensor, group, order: Sequence[int], split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all over ``group`` (``jax.lax.all_to_all(x, axis,
    split_axis, concat_axis, tiled=True)``); its gradient is the inverse
    all-to-all.  ``order[j]`` is the group rank of the axis's place
    ``j``."""
    return _AllToAll.apply(x, group, list(order), split_dim, concat_dim)


def stats_delta(before: Dict[str, Dict[str, float]]
                ) -> Dict[str, Dict[str, float]]:
    now = snapshot()
    return {k: {f: now[k][f] - before[k][f] for f in now[k]} for k in KINDS}

