"""``accelerate()`` — the port's counterpart of
``dlrover_tpu/parallel/accelerate.py`` (``Strategy``, ``infer_param_specs``
``:176``, ``AcceleratedJob``, ``accelerate`` ``:440-680``,
``_build_train_step``, ``_compile_candidate``, ``REMAT_POLICIES`` ``:43``,
``_bcast_blob`` ``:65``, ``_bcast_strategy`` ``:91``, ``aot_analyze``
``:682``, ``search`` ``:972``, ``_device_hbm_bytes`` ``:1151`` and
``_score`` ``:1174``).

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

**Sequence parallelism.**  A ``batch_axes`` spec whose second entry is
``"tp"`` (``P(("dp", "fsdp"), "tp")``) makes ``tp`` the sequence axis
(:attr:`AcceleratedJob.seq_axis`): the ranks of a ``tp`` group are given
the same rows, whole, and the loss (``models.llama.loss_fn(attn_impl=
"ring" | "ulysses", mesh=job.mesh)``) runs each rank's block of
positions.  The ranks of the group then compute different tokens, so
``tp`` joins the batch axes in every reduction: the loss and each
gradient are averaged over ``batch axes x tp``.  The job alone makes that
choice: it runs on ``mesh_for(spec, seq_axis="tp")`` (``job.mesh``), the
mesh the loss must be given, and its step raises when the two disagree:
a loss that cuts the sequence over any other mesh (a ``Strategy(mesh=
MeshSpec(tp=2))`` without the sequence axis, or a searched candidate on
another mesh), or a sequence-parallel job whose loss ran the whole
sequence (``parallel.mesh.stepping``/``claim_sequence``).  Under
``strategy="auto"``/``"bo"`` a sequence-parallel loss therefore needs
``loss_fn_builder`` to give each candidate's loss its own mesh.

Remat: ``"block"`` is the model's per-block remat, set by
``loss_fn_builder`` (e.g. ``cfg.remat_block=True``); ``"full"``
checkpoints the whole loss (``torch.utils.checkpoint``, non-reentrant);
``"dots"`` and ``"dots_no_batch"`` do it selectively, keeping the matmul
outputs (``aten.mm``/``addmm``, and for ``"dots"`` the batched
``bmm``/``baddbmm`` too).

**The strategy search.**  ``strategy="auto"`` sweeps one candidate per
mesh of :func:`~.mesh.candidate_specs` (a sequence of ``Strategy`` is
swept the same way): a candidate stands only when it builds on every
process (``_all_ok``); each is scored, the leader's score broadcast to
every process, and the lowest wins.  ``profile_steps > 0`` scores a
candidate by timed steps (one warm-up step, then the mean of
``profile_steps`` steps on a zeros batch, the card synchronised before the
clock is read); ``profile_steps=0`` by the port's cost model
(:func:`step_cost`): the reference's blend ``flops / 1e12 + bytes / 1e11``
(``:1201-1205``) of what the port's step does on a rank, counted from the
placements ``_build_job`` makes, since the port has no compiler to ask.
With ``cache=`` (a :class:`~.strategy_search.StrategyCache`, its path, or
a :class:`~.strategy_search.MasterStrategyCache`) the leader reads the
entry of the run's :func:`~.strategy_search.fingerprint` and broadcasts
its hit or miss; a hit goes first and, when it builds everywhere, is taken
without scoring the rest; the winner is written back (a forced
``grad_accum`` never is).  ``strategy="bo"`` runs :func:`search`:
:class:`~.strategy_search.BayesStrategySearch` over
:func:`~.strategy_search.default_space`, every process running the same
loop with the leader's measurement broadcast after each evaluation.
:data:`COUNTS` counts the jobs built, and each returned job carries its
search's record (``job.search``).

Refused by name: ``pp`` and ``ep`` axes, several devices a process, the
``offload`` remat, optimizer offload, quantised gradients and 8-bit Adam
over a sharded leaf (item 5c; in a search they score ``inf``), fp8 and
frozen (LoRA) parameters.
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
    candidate_specs,
    check_axes,
    stepping,
)
from dlrover_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    NamedSharding,
    PartitionSpec,
    Placement,
    Rules,
    box_slices,
    named_sharding_tree,
    placement_of,
    shard_leaf,
    tree_map,
)

REMAT_POLICIES = ("none", "block", "full", "dots", "dots_no_batch")
#: Jobs built by ``_build_job`` (candidates included), for counting what a
#: search or a cache hit built.
COUNTS = {"builds": 0}
_BCAST_BYTES = 1024  # fixed blob size for the leader->all broadcast


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
    seq_axis: Optional[str] = None  # "tp" under sequence parallelism
    state_sharding: Any = None
    batch_sharding: Any = None
    cost: Optional[Dict[str, Any]] = None  # step_cost(), once scored
    memory: Optional[Dict[str, Any]] = None  # aot_analyze's estimate
    search: Optional[Dict[str, Any]] = None  # the search that chose it
    sample_batch: Any = dataclasses.field(default=None, repr=False)
    specs_of: Optional[Callable] = dataclasses.field(default=None,
                                                     repr=False)
    _comms: Dict[int, collectives.LeafComm] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def reduce_axes(self) -> Tuple[str, ...]:
        """The axes the loss and the gradients are averaged over: the batch
        axes and, under sequence parallelism, the sequence axis."""
        extra = (self.seq_axis,) if self.seq_axis else ()
        return tuple(a for a in AXIS_ORDER
                     if a in self.batch_axes or a in extra)

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


def _batch_axes(batch_axes: Any, sample_batch: Dict
                ) -> Tuple[Tuple[str, ...], Optional[str]]:
    """``(axes, seq_axis)``: the mesh axes each process's batch share is
    cut over, and the sequence axis (a spec's second entry, ``"tp"``) or
    ``None``."""
    if batch_axes is None:
        return BATCH_AXES, None
    if isinstance(batch_axes, dict):
        specs = {k: _as_spec(batch_axes[k]) for k in sample_batch}
    else:
        specs = dict.fromkeys(sample_batch, _as_spec(batch_axes))
    found, seqs = set(), set()
    for k, arr in sample_batch.items():
        s = specs[k]
        if np.ndim(arr) == 0:
            continue
        if any(part is not None for part in s[2:]):
            raise ValueError(
                f"batch_axes[{k!r}] = {s!r}: a batch leaf is cut over its "
                f"batch and sequence dimensions only")
        second = s[1] if len(s) > 1 else None
        if second is not None:
            if second != "tp":
                raise ValueError(
                    f"batch_axes[{k!r}] = {s!r}: the sequence axis must be "
                    f"'tp' (ring and Ulysses attention run over it)")
            if np.ndim(arr) < 2:
                raise ValueError(f"batch_axes[{k!r}] = {s!r}: a "
                                 f"{np.ndim(arr)}-d leaf has no sequence "
                                 f"dimension")
        seqs.add(second)
        first = s[0] if len(s) else None
        found.add(() if first is None else (
            tuple(first) if isinstance(first, tuple) else (first,)))
    if len(found) > 1:
        raise ValueError(f"batch_axes: every batch leaf must be cut over "
                         f"the same axes, got {sorted(found)}")
    if len(seqs) > 1:
        raise ValueError("batch_axes: every batch leaf must be cut over the "
                         "same sequence axis")
    axes = found.pop() if found else ()
    seq = seqs.pop() if seqs else None
    if seq is not None and seq in axes:
        raise ValueError(f"batch_axes: {seq!r} cuts both the batch and the "
                         f"sequence")
    return axes, seq


_MESHES: Dict[tuple, Mesh] = {}


def mesh_for(spec: Union[MeshSpec, Dict[str, int]],
             seq_axis: Optional[str] = None) -> Mesh:
    """The mesh ``accelerate`` builds for ``spec`` over this process group
    (one mesh, and one set of process groups, per spec and group: the
    groups are made once, on every rank alike), with ``seq_axis`` as its
    sequence axis.  A sequence-parallel job runs on
    ``mesh_for(spec, seq_axis="tp")``, and its loss
    (``llama.loss_fn(attn_impl="ring", mesh=...)``) takes that mesh from
    here; a loss that cuts the sequence over any other mesh raises."""
    if not isinstance(spec, MeshSpec) or -1 in spec.sizes:
        spec = resolve_mesh(spec, dist_env.world_size())
    gen = dist_env.generation() if dist.is_initialized() else None
    base, key = (spec.sizes, gen, None), (spec.sizes, gen, seq_axis)
    if base not in _MESHES:
        _MESHES[base] = build_mesh(spec)
    if key not in _MESHES:
        _MESHES[key] = _MESHES[base].sequence(seq_axis)
    return _MESHES[key]


def _build_train_step(loss_fn: Callable, strategy: Strategy,
                      job: AcceleratedJob) -> Callable:
    A = strategy.grad_accum
    device = job.device
    lfn = _with_remat(loss_fn, strategy.remat)
    mesh = job.mesh
    batch = list(job.reduce_axes)
    bgroup = mesh.group(batch) if mesh is not None else None
    reducer = (_GradReducer(device, bgroup, mesh.axes_size(batch))
               if bgroup is not None else None)
    world_group = (mesh.group(AXIS_ORDER)
                   if mesh is not None and mesh.size > 1 else None)
    seq_cut = mesh.axis_size(job.seq_axis) \
        if mesh is not None and job.seq_axis else 1

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
        with stepping(mesh) as step:
            for mb in micro:
                loss = lfn(view, mb)
                loss.backward()
                loss_sum = loss_sum + loss.detach().float()
        if seq_cut > 1 and not step["cut"]:
            raise ValueError(
                f"the job cuts the sequence over tp={seq_cut} (batch_axes "
                f"or Strategy.rules['seq']), but its loss ran the whole "
                f"sequence on every rank: give the loss attn_impl='ring' or "
                f"'ulysses' and the job's mesh (mesh_for(spec, "
                f"seq_axis='tp'))")
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


def _bcast_blob(payload: Optional[bytes]) -> bytes:
    """The leader's small blob on every process: one fixed-size
    zero-padded buffer broadcast over the host group, so the collective's
    shape is the same everywhere.  An oversize payload goes out as a miss
    (empty): raising on the leader alone would leave the others blocked."""
    buf = torch.zeros(_BCAST_BYTES, dtype=torch.uint8)
    if payload:
        if len(payload) > _BCAST_BYTES:
            logger.warning("strategy blob %dB exceeds the %dB broadcast "
                           "buffer; treating as a cache miss", len(payload),
                           _BCAST_BYTES)
        else:
            buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                                  dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=dist_env.host_group())
    return bytes(buf.numpy().tobytes()).rstrip(b"\x00")


def _bcast_strategy(hit) -> Optional[Strategy]:
    """The leader's cache hit (or miss) on every process."""
    import json

    from dlrover_tpu_torch.parallel.strategy_search import (
        strategy_from_dict,
        strategy_to_dict,
    )

    raw = _bcast_blob(json.dumps(strategy_to_dict(hit)).encode()
                      if hit else b"")
    return strategy_from_dict(json.loads(raw.decode())) if raw else None


def _leader_score(t: float) -> float:
    """The leader's score on every process."""
    if dist_env.world_size() <= 1:
        return t
    buf = torch.tensor([t], dtype=torch.float64)
    dist.broadcast(buf, src=0, group=dist_env.host_group())
    return float(buf.item())


def _is_leader() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class _Abstract:
    """The shapes and types of the parameters (``init_fn`` run on fake
    tensors: no memory, no draw from a real generator) and the optimizer's
    class, made once a call, for the fingerprint, the memory model and the
    cost model."""

    def __init__(self, init_fn: Callable, optimizer: Callable,
                 device: torch.device):
        self.init_fn, self.optimizer, self.device = init_fn, optimizer, device
        self._made = None

    def get(self) -> Tuple[Any, str]:
        if self._made is None:
            from torch._subclasses.fake_tensor import FakeTensorMode

            gen = torch.Generator(device=self.device)
            with FakeTensorMode():
                params = self.init_fn(gen)
                opt = self.optimizer(tree_leaves(params))
            self._made = (params, type(opt).__name__)
        return self._made

    @property
    def params(self) -> Any:
        return self.get()[0]

    def fingerprint(self, sample_batch: Any, n: int) -> str:
        from dlrover_tpu_torch.parallel.strategy_search import fingerprint

        params, opt = self.get()
        return fingerprint(params, sample_batch, n, [f"optimizer:{opt}"])


def _refuse_later(devices, device, fp8_init, frozen, caller: str):
    """``device``, or the one device ``devices`` names; raise for several
    devices a process (item 5d), fp8 and frozen parameters (item 6)."""
    if fp8_init is not None:
        raise NotImplementedError(
            f"{caller}(fp8_init=...): fp8 comes with {MODEL_ITEM}")
    if frozen is not None:
        raise NotImplementedError(
            f"frozen parameters (LoRA) come with {MODEL_ITEM}")
    if devices is None:
        return device
    devices = list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"{caller}(devices=...) with {len(devices)} devices: more than "
            f"one device a process comes with {TP_COMPUTE_ITEM}")
    return devices[0] if device is None else device


def _cache_of(cache: Any):
    from dlrover_tpu_torch.parallel.strategy_search import StrategyCache

    return StrategyCache(cache) if isinstance(cache, str) else cache


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
    ``strategy``: a ``Strategy`` (built as given), a sequence of them (the
    candidates, scored), ``"auto"`` (one candidate per mesh of
    ``candidate_specs``) or ``"bo"`` (:func:`search`).  ``profile_steps``,
    ``cache`` and ``search_evals``: see the module docstring.
    ``param_specs``: ``None`` (:func:`infer_param_specs`), ``"planner"``,
    a tree of PartitionSpecs (or tuples of axes) or a callable of the
    normalized strategy.  ``batch_axes``: a PartitionSpec, or a dict of
    them per batch leaf, whose first entry names the batch axes and whose
    second, ``"tp"``, the sequence axis.  ``devices`` may name this
    process's one device.  ``grad_accum`` forces ``Strategy.grad_accum``,
    as in the reference.  ``fp8_init`` and ``frozen`` raise (item 6)."""
    device = _refuse_later(devices, device, fp8_init, frozen, "accelerate")
    build = functools.partial(
        _build_job, loss_fn=loss_fn, init_fn=init_fn, optimizer=optimizer,
        sample_batch=sample_batch, grad_accum=grad_accum,
        loss_fn_builder=loss_fn_builder, device=device,
        param_specs=param_specs, batch_axes=batch_axes)
    if isinstance(strategy, Strategy):
        return build(strategy)
    dev = resolve_device(device)
    abstract = _Abstract(init_fn, optimizer, dev)
    n = dist_env.world_size()
    record: Dict[str, Any] = {"kind": "candidates", "scores": [],
                              "cache_hit": False}
    if isinstance(strategy, str):
        if strategy == "auto":
            candidates = [Strategy(mesh=s) for s in candidate_specs(n)]
            record["kind"] = "auto"
        elif strategy == "bo":
            job_out: dict = {}
            best = search(
                loss_fn=loss_fn, init_fn=init_fn, optimizer=optimizer,
                sample_batch=sample_batch, param_specs=param_specs,
                batch_axes=batch_axes, device=dev,
                profile_steps=max(2, profile_steps), max_evals=search_evals,
                grad_accum=grad_accum, cache=cache, job_out=job_out,
                loss_fn_builder=loss_fn_builder, _abstract=abstract)
            if job_out.get("job") is not None:
                logger.info("accelerate: selected %s (from search)",
                            best.describe())
                return job_out["job"]
            candidates = [best]
            record = dict(job_out.get("record", {}), kind="bo")
        else:
            raise ValueError(f"strategy must be a Strategy, a sequence of "
                             f"them, 'auto' or 'bo', got {strategy!r}")
    else:
        candidates = list(strategy)
    if loss_fn_builder is None and any(c.remat == "block"
                                       for c in candidates):
        raise ValueError(
            "Strategy.remat='block' requires accelerate(loss_fn_builder=...)"
            " to set the model's per-block remat (e.g. cfg.remat_block=True)"
        )

    # A hit goes first and short-circuits the sweep, with every candidate
    # behind it as fallback; the leader reads the cache and broadcasts its
    # hit or miss, so the processes never diverge on a flaky cache read.
    cache_obj = fp = None
    cache_hit = False
    if cache is not None and strategy == "auto":
        cache_obj = _cache_of(cache)
        fp = abstract.fingerprint(sample_batch, n)
        hit = cache_obj.get(fp) if _is_leader() else None
        if n > 1:
            hit = _bcast_strategy(hit)
        record["fingerprint"] = fp
        if hit is not None:
            if grad_accum is not None:
                hit = dataclasses.replace(hit, grad_accum=grad_accum)
            logger.info("accelerate: strategy cache hit %s", hit.describe())
            candidates = [hit] + candidates
            cache_hit = True

    best: Optional[AcceleratedJob] = None
    best_score = float("inf")
    rejections: List[str] = []
    for i, cand in enumerate(candidates):
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
        if cache_hit and i == 0:
            best = job
            record["cache_hit"] = True
            break
        if len(candidates) == 1:
            best = job
            break
        score = _leader_score(_score(job, profile_steps, abstract))
        record["scores"].append([job.strategy.describe(), score])
        logger.info("strategy %s scored %.4g", cand.describe(), score)
        if score < best_score:
            best, best_score = job, score
    if best is None:
        raise RuntimeError(
            f"no viable strategy found — {len(candidates)} candidate(s) "
            f"rejected: {'; '.join(rejections) or 'none given'}")
    logger.info("accelerate: selected %s", best.strategy.describe())
    if _is_leader() and cache_obj is not None and fp is not None:
        # A forced grad_accum is this run's configuration, not the
        # strategy's: it is never persisted.
        to_cache = best.strategy
        if grad_accum is not None:
            to_cache = dataclasses.replace(to_cache, grad_accum=1)
        cache_obj.put(fp, to_cache)
    record.update(winner=best.strategy.describe(), rejections=rejections)
    best.search = record
    return best


def aot_analyze(*, loss_fn: Callable, init_fn: Callable, optimizer: Callable,
                sample_batch: Any, strategy: Strategy,
                param_specs: Any = None, batch_axes: Any = None,
                devices: Any = None, fp8_init: Optional[Callable] = None,
                loss_fn_builder: Optional[Callable] = None,
                frozen: Any = None,
                device: DeviceLike = None) -> AcceleratedJob:
    """Build one explicit strategy and return its job with the cost model's
    counts (``job.cost``, :func:`step_cost`) and the memory model's
    estimate (``job.memory["estimate_bytes"]``, the reference's
    ``estimate_step_hbm_bytes`` with its TPU-fitted calibration) attached;
    no state is created and no step is run.  The reference reads XLA's
    buffer assignment here; the port has none to read."""
    from dlrover_tpu_torch.parallel.strategy_search import \
        estimate_step_hbm_bytes

    job = accelerate(loss_fn=loss_fn, init_fn=init_fn, optimizer=optimizer,
                     sample_batch=sample_batch, strategy=strategy,
                     param_specs=param_specs, batch_axes=batch_axes,
                     devices=devices, fp8_init=fp8_init,
                     loss_fn_builder=loss_fn_builder, frozen=frozen,
                     device=device)
    abstract = _Abstract(init_fn, optimizer, job.device)
    job.cost = step_cost(job, abstract.params)
    job.memory = {"estimate_bytes": estimate_step_hbm_bytes(
        abstract.params, sample_batch,
        dataclasses.replace(job.strategy, mesh=job.mesh.spec))}
    return job


def search(*, loss_fn: Callable, init_fn: Callable, optimizer: Callable,
           sample_batch: Any, param_specs: Any = None,
           batch_axes: Any = None, devices: Any = None,
           profile_steps: int = 3, max_evals: int = 10,
           grad_accum: Optional[int] = None,
           warm_start: Sequence[Strategy] = (), cache: Any = None,
           job_out: Optional[dict] = None,
           fp8_init: Optional[Callable] = None,
           loss_fn_builder: Optional[Callable] = None, frozen: Any = None,
           device: DeviceLike = None, _abstract: Optional[_Abstract] = None
           ) -> Strategy:
    """Bayesian strategy search with a timed objective and a persistent
    cache (the reference's ``search``).

    Every process runs the same loop: the leader's cache hit or miss is
    broadcast before anyone searches; a candidate stands only if it builds
    on every process; after each evaluation the leader's measured time is
    broadcast, so every process feeds the GP the same observations and
    picks the same next point and winner.  ``profile_steps > 0`` times
    that many steps after a warm-up step; ``0`` scores by the cost model.
    ``job_out`` receives ``"record"`` (the evaluated points and the
    leader's scores) and, in a one-process run, the winner's job under
    ``"job"``."""
    from dlrover_tpu_torch.parallel.strategy_search import (
        REMAT_CHOICES,
        BayesStrategySearch,
        default_space,
        prune_space_by_memory,
    )

    dev = resolve_device(_refuse_later(devices, device, fp8_init, frozen,
                                       "search"))
    n = dist_env.world_size()
    multiproc = n > 1
    abstract = _abstract or _Abstract(init_fn, optimizer, dev)
    cache_obj = _cache_of(cache) if cache is not None else None
    fp = abstract.fingerprint(sample_batch, n)
    record: Dict[str, Any] = {"fingerprint": fp, "evaluated": [],
                              "cache_hit": False}
    if job_out is not None:
        job_out["record"] = record

    def forced(s: Strategy) -> Strategy:
        if grad_accum is not None and s.grad_accum != grad_accum:
            return dataclasses.replace(s, grad_accum=grad_accum)
        return s

    hit: Optional[Strategy] = None
    if _is_leader() and cache_obj is not None:
        hit = cache_obj.get(fp)
    if multiproc:
        hit = _bcast_strategy(hit)
    if hit is not None:
        hit = forced(hit)
        record["cache_hit"] = True
        logger.info("strategy search: cache hit %s -> %s", fp,
                    hit.describe())
        return hit

    build = functools.partial(
        _build_job, loss_fn=loss_fn, init_fn=init_fn, optimizer=optimizer,
        sample_batch=sample_batch, grad_accum=grad_accum,
        loss_fn_builder=loss_fn_builder, device=dev,
        param_specs=param_specs, batch_axes=batch_axes)
    best_job: dict = {}

    def objective(s: Strategy) -> float:
        s = forced(s)
        job, err = None, None
        try:
            job = build(s)
        except Exception as e:  # noqa: BLE001 - the point is infeasible
            err = e
        # A build that failed on some process is agreed on before anyone
        # runs the timed steps (collectives).
        if not _all_ok(job is not None):
            raise err or RuntimeError(
                f"{s.describe()} infeasible on a peer process")
        t = _leader_score(_score(job, profile_steps, abstract))
        if t < best_job.get("cost", float("inf")):
            best_job.update(job=job, cost=t, key=s.describe())
        return t

    space_kw: dict = {}
    if grad_accum is not None:
        space_kw["accum"] = (grad_accum,)
    if loss_fn_builder is None:
        # Without a model-rewriting builder remat="block" is "none" and a
        # pp mesh is pure replication: both are dropped, as the reference
        # drops them.
        space_kw["remat"] = tuple(r for r in REMAT_CHOICES if r != "block")
        space_kw["allow_pp"] = False
    space = default_space(n, **space_kw)
    hbm = _device_hbm_bytes(dev)
    if hbm is not None:
        space = prune_space_by_memory(space, abstract.params, sample_batch,
                                      hbm)
    result = BayesStrategySearch(objective, space, max_evals=max_evals,
                                 warm_start=list(warm_start)).run()
    record["evaluated"] = [[s.describe(), c] for s, c in result.evaluated]
    best = forced(result.best)
    record["winner"] = best.describe()
    if _is_leader() and cache_obj is not None:
        cache_obj.put(fp, best)
    # The built-winner shortcut is one-process only: processes must take
    # the same path.
    if not multiproc and job_out is not None \
            and best_job.get("key") == best.describe():
        best_job["job"].search = dict(record, kind="bo")
        job_out["job"] = best_job["job"]
    return best


def _device_hbm_bytes(device: DeviceLike = None) -> Optional[float]:
    """The memory budget for static pruning: ``DLROVER_TPU_HBM_BYTES``,
    else the card's ``total_memory``, else ``None`` (the CPU: no pruning,
    the run is the arbiter)."""
    import os

    env = os.environ.get("DLROVER_TPU_HBM_BYTES")
    if env:
        return float(env)
    dev = resolve_device(device)
    if dev.type == "cuda":
        return float(torch.cuda.get_device_properties(dev).total_memory)
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _score(job: AcceleratedJob, profile_steps: int,
           abstract: _Abstract) -> float:
    """Lower is better.  ``profile_steps > 0``: the mean seconds of that
    many steps (after one warm-up) from a fresh state on a zeros batch;
    else the cost model's ``flops / 1e12 + bytes / 1e11``."""
    if profile_steps > 0:
        state = job.create_state(
            torch.Generator(device=job.device).manual_seed(0))
        share = {k: np.zeros((np.shape(v)[0] // job.dp,)
                             + tuple(np.shape(v)[1:]), np.asarray(v).dtype)
                 for k, v in job.sample_batch.items()}
        state, _ = job.train_step(state, share)
        _sync(job.device)
        t0 = time.perf_counter()
        for _ in range(profile_steps):
            state, _ = job.train_step(state, share)
        _sync(job.device)
        t = (time.perf_counter() - t0) / profile_steps
        del state
        if job.device.type == "cuda":
            torch.cuda.empty_cache()
        return t
    job.cost = step_cost(job, abstract.params)
    return job.cost["flops"] / 1e12 + job.cost["bytes accessed"] / 1e11 \
        + 1e-9


def step_cost(job: AcceleratedJob, params: Any) -> Dict[str, Any]:
    """What one train step of ``job`` does on this rank, counted from the
    placements of ``params`` (shapes and types; fp32 masters):

    - ``flops``: ``(6 + 2 x recompute) x parameters x local tokens``, the
      local tokens being the largest batch leaf's elements over the batch
      shares and the sequence axis (``tp`` compute is replicated: a ``tp``
      axis that is not a sequence axis does not divide them), with
      ``recompute`` 1 under a remat policy;
    - ``comm``: the bytes the step's ``all_gather``, ``reduce_scatter``
      and ``all_reduce`` calls record in ``collectives.STATS`` (this
      rank's output): each sharded leaf gathered at every read (a forward
      a micro batch, twice under a remat policy) and its gradient reduced
      once a micro batch (the ``gloo`` all-reduce of the whole leaf, or
      the ``nccl`` reduce-scatter and all-reduce of its box), the whole
      leaves' gradients and the loss in one all-reduce, and the gradient
      norm's scalar.  A ``"block"`` remat re-gathers only the blocks'
      leaves: this count takes every leaf twice.  The ring hops and the
      all-to-alls of sequence parallelism depend on the model and are not
      counted;
    - ``update_bytes``: the parameters, gradients and two moments of this
      rank's boxes, read by the update;
    - ``bytes accessed``: ``comm`` plus ``update_bytes``."""
    strategy, mesh = job.strategy, job.mesh
    A = strategy.grad_accum
    reads = A * (1 if strategy.remat == "none" else 2)
    red = [a for a in job.reduce_axes if mesh.axis_size(a) > 1]
    bgroup = mesh.group(red)
    gloo = bgroup is not None and dist.get_backend(bgroup) == "gloo"
    comm = dict.fromkeys(("all_gather", "reduce_scatter", "all_reduce"), 0)
    totals = {"params": 0, "box_bytes": 0, "whole_bytes": 0,
              "sharded": 0}
    specs = job.specs_of(params)

    def leaf(x, spec):
        shape = tuple(int(d) for d in x.shape)
        numel = math.prod(shape)
        esz = 4  # fp32 masters
        pl = Placement(mesh, spec, shape)
        box = math.prod(e - s for s, e in pl.box())
        totals["params"] += numel
        totals["box_bytes"] += box * esz
        if not pl.sharded:
            totals["whole_bytes"] += numel * esz
            return
        totals["sharded"] += 1
        comm["all_gather"] += reads * mesh.axes_size(pl.axes) * box * esz
        if gloo:
            comm["all_reduce"] += A * numel * esz
            return
        if mesh.axes_size([a for a in red if a in pl.axes]) > 1:
            comm["reduce_scatter"] += A * box * esz
        if mesh.axes_size([a for a in red if a not in pl.axes]) > 1:
            comm["all_reduce"] += A * box * esz

    tree_map(leaf, params, specs)
    if bgroup is not None:
        comm["all_reduce"] += totals["whole_bytes"] + 4  # + the loss
    if totals["sharded"] and mesh.size > 1:
        comm["all_reduce"] += 4  # the gradient norm
    tokens = max((math.prod(np.shape(v)) for v in job.sample_batch.values()
                  if np.ndim(v) >= 2), default=0)
    local = tokens / job.dp / (mesh.axis_size(job.seq_axis)
                               if job.seq_axis else 1)
    flops = (6.0 + (0.0 if strategy.remat == "none" else 2.0)) \
        * totals["params"] * local
    update = 4 * totals["box_bytes"]
    return {"flops": flops, "comm": comm, "update_bytes": update,
            "bytes accessed": float(sum(comm.values()) + update)}


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
    COUNTS["builds"] += 1
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
    if batch_axes is None and (strategy.rules or {}).get("seq"):
        rules = {**DEFAULT_RULES, **strategy.rules}
        batch_axes = PartitionSpec(rules["batch"], rules["seq"])
    axes, seq = _batch_axes(batch_axes, sample_batch)
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
    mesh = mesh_for(spec, seq_axis=seq)
    lfn = loss_fn_builder(strategy) if loss_fn_builder else loss_fn
    job = AcceleratedJob(strategy=strategy, train_step=None,
                         create_state=None, device=dev, dp=n_batch,
                         mesh=mesh, batch_axes=axes, seq_axis=seq,
                         sample_batch=sample_batch)
    job.specs_of = lambda params: _param_specs(param_specs, strategy, spec,
                                               params)
    batch_spec = PartitionSpec(axes or None, seq) if seq else \
        PartitionSpec(axes or None)
    job.batch_sharding = {k: NamedSharding(mesh, batch_spec)
                          for k in sample_batch}
    reduce_axes = job.reduce_axes

    def create_state(generator: torch.Generator) -> Dict:
        params = init_fn(generator)
        specs = job.specs_of(params)
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
        job._comms = {id(x): collectives.LeafComm(placement_of(x),
                                                  reduce_axes)
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
