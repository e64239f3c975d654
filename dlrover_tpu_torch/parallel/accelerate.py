"""``accelerate()`` — the port's counterpart of
``dlrover_tpu/parallel/accelerate.py`` (``Strategy``, ``infer_param_specs``
``:176``, ``AcceleratedJob``, ``accelerate``, ``_build_train_step``,
``_compile_candidate``, ``REMAT_POLICIES`` ``:43``).

Given a loss function, a parameter initialiser, an optimizer factory and a
sample batch, it returns ``train_step(state, batch) -> (state, {"loss",
"grad_norm", ...})`` and ``create_state(generator)``.  The step follows the
reference's ``_build_train_step``: with ``grad_accum > 1`` the batch is
split along its first dim into equal microbatches whose losses and
gradients are averaged; ``grad_norm`` is ``optax.global_norm`` of the
(averaged, reduced) gradients, taken before the update.

The state is ``{"params", "opt_state", "step"}`` as in the reference.
PyTorch updates in place: ``params`` is the tree of fp32 master tensors
(this rank's boxes), ``opt_state`` the ``torch.optim.Optimizer`` that owns
their moments, and ``train_step`` returns the same dict with ``step``
advanced.

**The mesh.**  Each process drives one device.  ``Strategy.mesh`` is a
:class:`~.mesh.MeshSpec` over ``dp``, ``fsdp`` and ``tp`` (one ``-1``
filled from the world) or, as before, a dict of sizes in which an absent
``dp`` takes the processes the other axes leave.  The placement of each
parameter leaf is a :class:`~.sharding.PartitionSpec`: by default
:func:`infer_param_specs` (ZeRO-3 on the largest ``fsdp``-divisible
dimension), or ``param_specs=`` as a tree, as a callable of the
(normalized) strategy, or ``"planner"`` (:func:`~.layout_planner.
plan_layout` over ``fsdp`` and ``tp``).  ``create_state`` makes each leaf
as the world-1 run makes it, from the seed, and keeps only this rank's box
(tagged with its :class:`~.sharding.Placement`); the optimizer is built
over the boxes, so its moments are sharded the same way.

PyTorch has no GSPMD, so the step does explicitly what XLA inserts:

- the loss sees the parameters through a view that gathers a sharded
  leaf (``collectives.gather``, an autograd function) when the model
  reads it, so a block's leaves are gathered just before use, and again
  in the backward pass where a remat policy recomputes the block;
- the gather's backward reduce-scatters the leaf's gradient back to this
  rank's box, summed over the batch group and divided by its size;
- the gradients of the leaves that stay whole, and the loss, are
  all-reduced over the batch group in one flat buffer and divided by its
  size (through page-locked host memory under ``gloo`` with card tensors);
- ``grad_norm``: each leaf's sum of squares over its box, divided by the
  number of ranks that hold the box, summed over the world: a leaf
  replicated over an axis is counted once.  An optimizer with a
  ``grad_norm_fn`` attribute (``trainer.ScheduledAdamW``'s clipping) gets
  this global norm.

``batch_axes`` (default ``("dp", "fsdp")``, the reference's) names the
axes the batch is sharded over: each process is given its
``1 / prod(sizes)`` share, and the ranks that differ only on the other
axes (``tp``) compute on the same rows.  A ``tp``-placed weight is
gathered; tensor-parallel (Megatron) compute is a later item.

Remat: ``"block"`` is the model's per-block remat, set by
``loss_fn_builder`` (e.g. ``cfg.remat_block=True``); ``"full"``
checkpoints the whole loss (``torch.utils.checkpoint``, non-reentrant);
``"dots"`` and ``"dots_no_batch"`` do it selectively, keeping the matmul
outputs (``aten.mm``/``addmm``, and for ``"dots"`` the batched
``bmm``/``baddbmm`` too).

A sequence of ``Strategy`` candidates is swept as the reference sweeps
them: a candidate stands only when it builds on every process
(``_all_ok``); the first that stands wins (no cost model yet).  Refused by
name: ``pp`` and ``ep`` axes, several devices a process, the ``offload``
remat, optimizer offload, quantised gradients and 8-bit Adam over a
sharded leaf, fp8, frozen (LoRA) parameters and the strategy search.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import time
from collections.abc import Mapping, Sequence as SequenceABC
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common.constants import (
    MODEL_ITEM,
    QUANT_OFFLOAD_ITEM,
    SEARCH_ITEM,
    TP_COMPUTE_ITEM,
)
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.parallel import collectives
from dlrover_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    BATCH_AXES,
    Mesh,
    MeshSpec,
    build_mesh,
    check_axes,
)
from dlrover_tpu_torch.parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    Rules,
    box_slices,
    named_sharding_tree,
    placement_of,
    shard_leaf,
    tree_map,
)

REMAT_POLICIES = ("none", "block", "full", "dots", "dots_no_batch")


@dataclasses.dataclass
class Strategy:
    """One point of the reference's strategy space.  ``mesh`` is a
    ``MeshSpec`` or a dict of axis sizes (an absent ``dp``: the processes
    the other axes leave)."""

    mesh: Union[Dict[str, int], MeshSpec] = dataclasses.field(
        default_factory=dict)
    remat: str = "none"
    grad_accum: int = 1
    offload_opt: bool = False
    fp8: bool = False
    quant_grads: bool = False
    rules: Optional[Rules] = None

    def describe(self) -> str:
        if isinstance(self.mesh, MeshSpec):
            mesh = self.mesh.describe()
        else:
            mesh = "x".join(f"{a}{s}" for a, s in self.mesh.items()
                            if s != 1) or "single"
        return f"mesh={mesh} remat={self.remat} accum={self.grad_accum}"


def _fmt(sizes: Dict[str, int]) -> str:
    return ", ".join(f"{a}={s}" for a, s in sizes.items() if s != 1) \
        or "single"


def resolve_mesh(mesh: Union[Dict[str, int], MeshSpec],
                 world: int) -> MeshSpec:
    """The ``MeshSpec`` of ``mesh`` over ``world`` processes (one ``-1``
    filled in); raises when it needs more devices than processes (several
    devices a process) or does not cover them."""
    if isinstance(mesh, MeshSpec):
        sizes = dict(zip(AXIS_ORDER, mesh.sizes))
    else:
        for axis in mesh:
            if axis not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {axis!r}")
        sizes = dict(mesh)
        if -1 not in sizes.values():
            sizes.setdefault("dp", -1)
    fixed = math.prod(s for s in sizes.values() if s != -1)
    if fixed > world:
        raise NotImplementedError(
            f"mesh {_fmt({a: s for a, s in sizes.items() if s != -1})} "
            f"over {world} process(es): more than one device a process "
            f"comes with {TP_COMPUTE_ITEM}")
    spec = MeshSpec(**sizes)
    if -1 in spec.sizes:
        spec = spec.normalized(world)
    elif spec.num_devices != world:
        raise ValueError(
            f"mesh {_fmt(sizes)} does not cover the {world} processes of "
            f"the group")
    check_axes(spec)
    return spec


def check_strategy(strategy: Strategy, world: int = 1) -> MeshSpec:
    """Raise for what a world of ``world`` processes, one device each,
    does not run; the normalized mesh otherwise."""
    spec = resolve_mesh(strategy.mesh, world)
    if strategy.remat == "offload":
        raise NotImplementedError(
            f"remat='offload' (activations parked in host memory) comes "
            f"with {QUANT_OFFLOAD_ITEM}")
    if strategy.remat not in REMAT_POLICIES:
        raise ValueError(f"remat must be one of {REMAT_POLICIES}, got "
                         f"{strategy.remat!r}")
    for flag, what, where in (
            ("offload_opt", "optimizer-state offload", QUANT_OFFLOAD_ITEM),
            ("fp8", "fp8 projections", MODEL_ITEM),
            ("quant_grads", "int8 gradient reduction", QUANT_OFFLOAD_ITEM)):
        if getattr(strategy, flag):
            raise NotImplementedError(
                f"Strategy({flag}=True): {what} comes with {where}"
            )
    if strategy.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {strategy.grad_accum}")
    return spec


def infer_param_specs(params: Any, spec: MeshSpec) -> Any:
    """ZeRO-3 placement: each leaf's largest ``fsdp``-divisible dimension
    on ``fsdp`` (ties by the reference's ``sorted`` order), the rest
    whole."""

    def per_leaf(x):
        shape = tuple(x.shape)
        if spec.fsdp <= 1 or not shape:
            return PartitionSpec()
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for dim in order:
            if shape[dim] % spec.fsdp == 0 and shape[dim] >= spec.fsdp:
                parts: List[Optional[str]] = [None] * (dim + 1)
                parts[dim] = "fsdp"
                return PartitionSpec(*parts)
        return PartitionSpec()

    return tree_map(per_leaf, params)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree in the reference's order
    (dict keys sorted, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _to_device(batch: Dict, device: torch.device) -> Dict:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def _as_spec(s) -> PartitionSpec:
    if isinstance(s, PartitionSpec):
        return s
    if isinstance(s, (tuple, list)):
        return PartitionSpec(*s)
    if s is None:
        return PartitionSpec()
    raise TypeError(f"a parameter spec must be a PartitionSpec or a tuple "
                    f"of mesh axes, got {s!r}")


def _is_spec_leaf(x) -> bool:
    return x is None or isinstance(x, PartitionSpec) or (
        isinstance(x, tuple) and all(isinstance(a, (str, tuple, type(None)))
                                     for a in x))


class _TreeView(Mapping):
    """A read-only view of a parameter dict whose sharded leaves are
    gathered when read."""

    def __init__(self, node: dict, comms: dict):
        self._node, self._comms = node, comms

    def __getitem__(self, k):
        return _view(self._node[k], self._comms)

    def __iter__(self):
        return iter(self._node)

    def __len__(self):
        return len(self._node)


class _ListView(SequenceABC):
    def __init__(self, node, comms: dict):
        self._node, self._comms = node, comms

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _ListView(self._node[i], self._comms)
        return _view(self._node[i], self._comms)

    def __len__(self):
        return len(self._node)


def _view(node, comms: dict):
    if isinstance(node, dict):
        return _TreeView(node, comms)
    if isinstance(node, (list, tuple)):
        return _ListView(node, comms)
    if torch.is_tensor(node):
        return collectives.gather(node, comms.get(id(node)))
    return node


class _GradReducer:
    """Sum the gradients of the leaves that stay whole and the loss over
    the batch group with one ``all_reduce`` of a flat buffer, then divide
    by the group's size.  Under ``gloo`` with card tensors the buffer is
    page-locked host memory: the copies to it are ordered on the card's
    stream, and one synchronise before the reduction waits for them."""

    def __init__(self, device: torch.device, group, size: int):
        self.device = device
        self.group = group
        self.size = size
        self.via_host = device.type == "cuda" \
            and dist.get_backend(group) == "gloo"
        self.buf: Optional[torch.Tensor] = None
        self.last_ms: Optional[float] = None  # host clock, via_host only

    def __call__(self, grads: List[torch.Tensor],
                 loss: torch.Tensor) -> torch.Tensor:
        n = sum(g.numel() for g in grads) + 1
        dtype = grads[0].dtype if grads else torch.float32
        if self.buf is None or self.buf.numel() != n \
                or self.buf.dtype != dtype:
            self.buf = (torch.empty(n, dtype=dtype, pin_memory=True)
                        if self.via_host else
                        torch.empty(n, dtype=dtype, device=self.device))
        buf, off = self.buf, 0
        if self.via_host:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        t_all, ev = time.perf_counter(), collectives._begin(loss)
        for g in grads:
            k = g.numel()
            buf[off:off + k].copy_(g.reshape(-1), non_blocking=True)
            off += k
        buf[off:off + 1].copy_(loss.reshape(1), non_blocking=True)
        if self.via_host:
            torch.cuda.synchronize(self.device)
        dist.all_reduce(buf, group=self.group)
        buf.div_(self.size)
        if self.via_host:
            self.last_ms = (time.perf_counter() - t0) * 1e3
        off = 0
        for g in grads:
            k = g.numel()
            g.copy_(buf[off:off + k].view_as(g), non_blocking=True)
            off += k
        collectives._note("all_reduce", n * buf.element_size(), t_all, ev)
        return buf[off].to(self.device)


def _dots_policy(batched: bool):
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    keep = {aten.mm.default, aten.addmm.default}
    if batched:
        keep |= {aten.bmm.default, aten.baddbmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return policy


def _with_remat(loss_fn: Callable, remat: str) -> Callable:
    """The loss under the strategy's remat policy (``"block"`` is the
    model's own, set by ``loss_fn_builder``)."""
    if remat in ("none", "block"):
        return loss_fn
    from torch.utils.checkpoint import (
        checkpoint,
        create_selective_checkpoint_contexts,
    )

    if remat == "full":
        return lambda p, b: checkpoint(loss_fn, p, b, use_reentrant=False)
    policy = _dots_policy(batched=remat == "dots")
    ctx = functools.partial(create_selective_checkpoint_contexts, policy)
    return lambda p, b: checkpoint(loss_fn, p, b, use_reentrant=False,
                                   context_fn=ctx)


@dataclasses.dataclass
class AcceleratedJob:
    """What :func:`accelerate` returns.  ``state_sharding`` (the
    placements' spec tree on the mesh) is filled by ``create_state``,
    which is where the parameters' shapes are first known."""

    strategy: Strategy
    train_step: Callable  # (state, batch) -> (state, metrics)
    create_state: Callable  # (generator) -> state
    device: torch.device
    dp: int = 1  # the batch group's size: processes the batch is split over
    mesh: Optional[Mesh] = None
    batch_axes: Tuple[str, ...] = BATCH_AXES
    state_sharding: Any = None
    batch_sharding: Any = None
    _comms: Dict[int, collectives.LeafComm] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def batch_rank(self) -> Tuple[int, int]:
        """``(index, size)`` of this rank in the batch group: which share
        of each global batch it is given."""
        if self.mesh is None or self.mesh.rank is None:
            return 0, 1
        axes = [a for a in AXIS_ORDER if a in self.batch_axes]
        return self.mesh.index_on(axes), self.mesh.axes_size(axes)

    @property
    def sharded(self) -> bool:
        return bool(self._comms)

    def params_view(self, params: Any) -> Any:
        """``params`` as the loss reads them: sharded leaves gathered when
        read (``params`` itself when nothing is sharded)."""
        return _view(params, self._comms) if self._comms else params

    def gather_state(self, state: Any) -> Dict[str, torch.Tensor]:
        """``{path: whole tensor}`` of every leaf of ``state``, moments
        included (a collective over each sharded leaf's gather group)."""
        from dlrover_tpu_torch.checkpoint import tree_utils

        out = {}
        with torch.no_grad():
            for leaf in tree_utils.state_leaves(state):
                pl = leaf.placement
                t = leaf.tensor
                if pl is not None and pl.sharded:
                    t = collectives.LeafComm(pl, ()).gather(t)
                out[leaf.path] = t
        return out

    def load_state(self, state: Any, whole: Dict[str, torch.Tensor]) -> Any:
        """Copy this rank's box of each whole tensor of ``whole``
        (``{path: tensor}``) into ``state``."""
        from dlrover_tpu_torch.checkpoint import tree_utils

        src = {}
        for leaf in tree_utils.state_leaves(state):
            t = whole[leaf.path]
            pl = leaf.placement
            if pl is not None and pl.sharded:
                t = t[box_slices(pl.box())]
            src[leaf.path] = t.to(leaf.tensor.device)
        return tree_utils.restore_to_target(src, state)


def _batch_axes(batch_axes: Any, sample_batch: Dict) -> Tuple[str, ...]:
    """The mesh axes each process's batch share is cut over."""
    if batch_axes is None:
        return BATCH_AXES
    if isinstance(batch_axes, dict):
        specs = {k: _as_spec(batch_axes[k]) for k in sample_batch}
    else:
        specs = dict.fromkeys(sample_batch, _as_spec(batch_axes))
    found = set()
    for k, arr in sample_batch.items():
        s = specs[k]
        if np.ndim(arr) == 0:
            continue
        if any(part is not None for part in s[1:]):
            raise NotImplementedError(
                f"batch_axes[{k!r}] = {s!r}: sharding a batch leaf past its "
                f"first dimension (sequence parallelism) comes with "
                f"{SEARCH_ITEM}")
        first = s[0] if len(s) else None
        found.add(() if first is None else (
            tuple(first) if isinstance(first, tuple) else (first,)))
    if len(found) > 1:
        raise ValueError(f"batch_axes: every batch leaf must be cut over "
                         f"the same axes, got {sorted(found)}")
    return found.pop() if found else ()


_MESHES: Dict[tuple, Mesh] = {}


def _mesh_for(spec: MeshSpec) -> Mesh:
    """One mesh (and its process groups) per spec and process group: the
    groups are made once, on every rank alike."""
    key = (spec.sizes, dist_env.generation() if dist.is_initialized()
           else None)
    mesh = _MESHES.get(key)
    if mesh is None:
        mesh = _MESHES[key] = build_mesh(spec)
    return mesh


def _build_train_step(loss_fn: Callable, strategy: Strategy,
                      job: AcceleratedJob) -> Callable:
    A = strategy.grad_accum
    device = job.device
    lfn = _with_remat(loss_fn, strategy.remat)
    mesh = job.mesh
    batch = [a for a in AXIS_ORDER if a in job.batch_axes]
    bgroup = mesh.group(batch) if mesh is not None else None
    reducer = (_GradReducer(device, bgroup, mesh.axes_size(batch))
               if bgroup is not None else None)
    world_group = (mesh.group(AXIS_ORDER)
                   if mesh is not None and mesh.size > 1 else None)

    def grad_norm(leaves: List[torch.Tensor]) -> torch.Tensor:
        if not job.sharded:
            return torch.sqrt(sum(torch.sum(p.grad.float() * p.grad.float())
                                  for p in leaves))
        total = torch.zeros((), dtype=torch.float32, device=device)
        for p in leaves:
            pl = placement_of(p)
            reps = pl.replicas if pl is not None else mesh.size
            total = total + torch.sum(p.grad.float() * p.grad.float()) / reps
        if world_group is not None:
            collectives.all_reduce_(total, world_group)
        return torch.sqrt(total)

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        leaves = tree_leaves(params)
        view = job.params_view(params)
        batch = _to_device(batch, device)
        before = collectives.snapshot()
        if A > 1:
            micro = [{k: v.reshape((A, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(A)]
        else:
            micro = [batch]
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for mb in micro:
            loss = lfn(view, mb)
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
        for p in leaves:
            # A parameter the loss does not reach has a zero gradient, as
            # in JAX, so the optimizer still updates it (torch's AdamW
            # skips a None grad; it would not decay the parameter).
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if A > 1:
            for p in leaves:
                p.grad.div_(A)
        loss = loss_sum / A
        metrics = {}
        if reducer is not None:
            whole = [p.grad for p in leaves if id(p) not in job._comms]
            loss = reducer(whole, loss)
            if reducer.last_ms is not None:
                metrics["reduce_ms"] = reducer.last_ms
        gnorm = grad_norm(leaves)
        opt = state["opt_state"]
        if job.sharded and hasattr(opt, "grad_norm_fn"):
            opt.grad_norm_fn = lambda grads, _n=gnorm: _n
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        if mesh is not None and mesh.size > 1:
            metrics["comm"] = collectives.stats_delta(before)
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def _all_ok(ok: bool) -> bool:
    """True on every process when ``ok`` holds on every process (the
    reference's ``_all_ok``: a candidate that failed anywhere is skipped
    everywhere, or the next collective would deadlock)."""
    if dist_env.world_size() <= 1:
        return ok
    return all(dist_env.allgather_ints(1 if ok else 0))


def accelerate(*, loss_fn: Callable, init_fn: Callable, optimizer: Callable,
               sample_batch: Any,
               strategy: Union[str, Strategy, Sequence[Strategy]] = "auto",
               param_specs: Any = None,
               batch_axes: Any = None,
               devices: Any = None,
               profile_steps: int = 0,
               grad_accum: Optional[int] = None,
               search_evals: int = 10,
               cache: Any = None,
               fp8_init: Optional[Callable] = None,
               loss_fn_builder: Optional[Callable] = None,
               frozen: Any = None,
               device: DeviceLike = None) -> AcceleratedJob:
    """Build the train step of one device a process over the mesh.

    ``loss_fn(params, batch) -> scalar``; ``init_fn(generator) -> params``
    (fp32 masters, whole); ``optimizer`` a factory from
    ``dlrover_tpu_torch.optim`` (``adamw(lr)``, ``adam8bit(lr)``);
    ``sample_batch`` a dict of arrays with the global batch dim.
    ``strategy`` is a ``Strategy`` or a sequence of them (the candidates).
    ``param_specs``: ``None`` (:func:`infer_param_specs`), ``"planner"``,
    a tree of PartitionSpecs (or tuples of axes) or a callable of the
    normalized strategy.  ``batch_axes``: a PartitionSpec, or a dict of
    them per batch leaf, whose first entry names the batch axes.
    ``devices`` may name this process's one device.  ``grad_accum``
    forces ``Strategy.grad_accum``, as in the reference.  The reference's
    ``profile_steps``, ``search_evals`` and ``cache`` (the strategy
    search) and ``fp8_init`` raise at any value but their defaults."""
    for name, asked in (("profile_steps", profile_steps != 0),
                        ("search_evals", search_evals != 10),
                        ("cache", cache is not None)):
        if asked:
            raise NotImplementedError(
                f"accelerate({name}=...): the strategy search comes with "
                f"{SEARCH_ITEM}"
            )
    if devices is not None:
        devices = list(devices)
        if len(devices) != 1:
            raise NotImplementedError(
                f"accelerate(devices=...) with {len(devices)} devices: more "
                f"than one device a process comes with "
                f"{TP_COMPUTE_ITEM}")
        if device is None:
            device = devices[0]
    if fp8_init is not None:
        raise NotImplementedError(
            f"accelerate(fp8_init=...): fp8 comes with {MODEL_ITEM}"
        )
    if isinstance(strategy, str):
        raise NotImplementedError(
            f"strategy={strategy!r}: the strategy search comes with "
            f"{SEARCH_ITEM}; pass a Strategy"
        )
    if frozen is not None:
        raise NotImplementedError(
            f"frozen parameters (LoRA) come with {MODEL_ITEM}"
        )
    build = functools.partial(
        _build_job, loss_fn=loss_fn, init_fn=init_fn, optimizer=optimizer,
        sample_batch=sample_batch, grad_accum=grad_accum,
        loss_fn_builder=loss_fn_builder, device=device,
        param_specs=param_specs, batch_axes=batch_axes)
    if isinstance(strategy, Strategy):
        return build(strategy)
    rejections: List[str] = []
    for cand in strategy:
        try:
            job = build(cand)
        except (NotImplementedError, ValueError) as e:
            logger.info("strategy %s rejected: %s", cand.describe(), e)
            rejections.append(f"{cand.describe()}: {type(e).__name__}: {e}")
            job = None
        if not _all_ok(job is not None):
            if job is not None:
                rejections.append(f"{cand.describe()}: rejected on another "
                                  "process (see its logs)")
            continue
        logger.info("accelerate: selected %s", job.strategy.describe())
        return job
    raise RuntimeError(
        f"no viable strategy found — {len(strategy)} candidate(s) "
        f"rejected: {'; '.join(rejections) or 'none given'}")


def _param_specs(param_specs: Any, strategy: Strategy, spec: MeshSpec,
                 params: Any) -> Any:
    if callable(param_specs):
        specs = param_specs(strategy)
    elif isinstance(param_specs, str):
        if param_specs != "planner":
            raise ValueError(f"param_specs must be 'planner', a tree or a "
                             f"callable, got {param_specs!r}")
        from dlrover_tpu_torch.parallel.layout_planner import plan_layout

        specs = plan_layout(params, {"fsdp": spec.fsdp, "tp": spec.tp})
    elif param_specs is not None:
        specs = param_specs
    else:
        specs = infer_param_specs(params, spec)
    return tree_map(_as_spec, specs, is_leaf=_is_spec_leaf)


def _build_job(strategy: Strategy, *, loss_fn, init_fn, optimizer,
               sample_batch, grad_accum, loss_fn_builder, device,
               param_specs, batch_axes) -> AcceleratedJob:
    world = dist_env.world_size()
    if grad_accum is not None:
        strategy = dataclasses.replace(strategy, grad_accum=grad_accum)
    spec = check_strategy(strategy, world)
    if isinstance(strategy.mesh, MeshSpec):
        strategy = dataclasses.replace(strategy, mesh=spec)
    elif -1 in strategy.mesh.values():
        strategy = dataclasses.replace(strategy, mesh={
            a: getattr(spec, a) for a in strategy.mesh})
    if strategy.remat == "block" and loss_fn_builder is None:
        raise ValueError(
            "Strategy.remat='block' requires accelerate(loss_fn_builder=...)"
            " to set the model's per-block remat (e.g. cfg.remat_block=True)"
        )
    axes = _batch_axes(batch_axes, sample_batch)
    n_batch = math.prod(getattr(spec, a) for a in axes)
    for name, arr in sample_batch.items():
        if np.ndim(arr) and np.shape(arr)[0] % (strategy.grad_accum
                                                 * n_batch):
            raise ValueError(
                f"batch[{name!r}] dim 0 ({np.shape(arr)[0]}) is not a "
                f"multiple of grad_accum={strategy.grad_accum} x "
                f"{n_batch} batch share(s) ({'x'.join(axes) or 'none'})"
            )
    dev = resolve_device(device)
    mesh = _mesh_for(spec)
    lfn = loss_fn_builder(strategy) if loss_fn_builder else loss_fn
    job = AcceleratedJob(strategy=strategy, train_step=None,
                         create_state=None, device=dev, dp=n_batch,
                         mesh=mesh, batch_axes=axes)
    job.batch_sharding = {k: NamedSharding(mesh, PartitionSpec(axes or None))
                          for k in sample_batch}

    def create_state(generator: torch.Generator) -> Dict:
        params = init_fn(generator)
        specs = _param_specs(param_specs, strategy, spec, params)
        leaves = []

        def place(x, s):
            if x.dtype != torch.float32 or x.device.type != dev.type:
                raise ValueError(
                    f"init_fn must give fp32 masters on {dev}, got "
                    f"{x.dtype} on {x.device}"
                )
            x = shard_leaf(x, NamedSharding(mesh, s)).requires_grad_(True)
            leaves.append(x)
            return x

        boxes = tree_map(place, params, specs)
        del params
        opt = optimizer(tree_leaves(boxes))
        job._comms = {id(x): collectives.LeafComm(placement_of(x), axes)
                      for x in leaves if placement_of(x).sharded}
        if job._comms:
            from dlrover_tpu_torch.ops.quant import Adam8bit

            if isinstance(opt, Adam8bit):
                raise NotImplementedError(
                    f"8-bit Adam over a sharded leaf comes with "
                    f"{QUANT_OFFLOAD_ITEM}")
        named = named_sharding_tree(specs, mesh)
        job.state_sharding = {"params": named, "opt_state": named,
                              "step": NamedSharding(mesh, PartitionSpec())}
        return {"params": boxes, "opt_state": opt, "step": 0}

    job.create_state = create_state
    job.train_step = _build_train_step(lfn, strategy, job)
    return job
