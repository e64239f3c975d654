"""Named parallelism axes over the processes of a ``torch.distributed``
group — the port's own copy of ``dlrover_tpu/parallel/mesh.py``
(``AXIS_ORDER``, ``MeshSpec`` ``:33`` with ``normalized``, ``describe`` and
``num_devices``, ``build_mesh`` ``:77``, ``build_hybrid_mesh`` ``:89``,
``candidate_specs`` ``:151`` and ``_divisors``).

The reference's mesh is an array of JAX devices in the canonical axis
order ``('pp', 'dp', 'fsdp', 'ep', 'tp')`` (outer to inner).  The port
drives one device a process, so its :class:`Mesh` is the same array of
*ranks*: rank ``r`` sits at ``np.unravel_index(r, sizes)`` under
:func:`build_mesh`, which is where the reference puts device ``r`` of
``jax.devices()``.  :func:`build_hybrid_mesh` orders the ranks by the
agent's node rank, so the ``dcn_axes`` (outermost) span the nodes and the
other axes stay inside one node, as the reference's axes span slices.

A mesh owns one process group for every set of its axes whose product is
above 1 (the axes a leaf is sharded over, the batch axes, ...).
``torch.distributed.new_group`` is collective: every rank creates every
group, each set of axes in one fixed order and, inside it, each group in
the row-major order of the other axes' coordinates.  A mesh of more than
one rank needs a process group of exactly that many ranks, and raises
otherwise; a mesh of one rank needs none and makes none.

``pp > 1`` (pipelining) and ``ep > 1`` (experts) raise, naming the items
that bring them.

**The sequence axis.**  A mesh may name ``tp`` its sequence axis
(:meth:`Mesh.sequence`, ``Mesh.seq_axis``): a sequence-parallel job's mesh
(``accelerate`` builds it when its ``batch_axes`` or ``Strategy.rules``
name one).  A loss that runs each rank's block of positions
(``models.llama.loss_fn(attn_impl="ring" | "ulysses", mesh=...)`` with
``tp > 1``) calls :func:`claim_sequence`, which refuses a mesh without
that mark and, while a job's step runs (:func:`stepping`), any mesh but
the job's: the job alone decides whether ``tp`` cuts the sequence, and
its reductions and the loss's cut cannot disagree.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dlrover_tpu_torch.common.constants import (
    HOST_LAYERS,
    MODEL_ITEM,
    TP_COMPUTE_ITEM,
)

AXIS_ORDER = ("pp", "dp", "fsdp", "ep", "tp")
#: The axes the batch is sharded over by default (the reference's
#: ``DEFAULT_RULES["batch"]``).
BATCH_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    pp: int = 1
    dp: int = 1
    fsdp: int = 1
    ep: int = 1
    tp: int = 1

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(getattr(self, a) for a in AXIS_ORDER)

    @property
    def num_devices(self) -> int:
        return math.prod(self.sizes)

    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    def normalized(self, n_devices: int) -> "MeshSpec":
        """Fill a single ``-1`` axis from the device count (torchrun-style
        wildcard)."""
        sizes = list(self.sizes)
        if -1 in sizes:
            i = sizes.index(-1)
            rest = math.prod(s for s in sizes if s != -1)
            if n_devices % rest:
                raise ValueError(
                    f"{n_devices} devices not divisible by {rest}"
                )
            sizes[i] = n_devices // rest
        spec = MeshSpec(**dict(zip(AXIS_ORDER, sizes)))
        if spec.num_devices != n_devices:
            raise ValueError(
                f"mesh {spec} needs {spec.num_devices} devices, "
                f"have {n_devices}"
            )
        return spec

    def describe(self) -> str:
        return "x".join(
            f"{a}{s}" for a, s in zip(AXIS_ORDER, self.sizes) if s > 1
        ) or "single"


def check_axes(spec: MeshSpec) -> None:
    """Raise for the axes the port does not run yet."""
    if spec.pp > 1:
        raise NotImplementedError(
            f"mesh pp={spec.pp}: pipeline parallelism comes with "
            f"{HOST_LAYERS}")
    if spec.ep > 1:
        raise NotImplementedError(
            f"mesh ep={spec.ep}: expert parallelism comes with {MODEL_ITEM}")


class Mesh:
    """The ranks of a world laid out on the named axes, with this rank's
    coordinates and the process groups of its axis sets.

    ``ranks`` is an int array of shape ``spec.sizes`` (axis order
    :data:`AXIS_ORDER`); ``rank`` this process's rank (``None`` for a mesh
    described without a process, e.g. a target seen from another world);
    ``seq_axis`` the sequence axis of a sequence-parallel job's mesh, else
    ``None``.
    """

    def __init__(self, spec: MeshSpec, ranks: np.ndarray,
                 rank: Optional[int], groups: Optional[dict] = None,
                 seq_axis: Optional[str] = None):
        if seq_axis not in (None, "tp"):
            raise ValueError(f"the sequence axis must be 'tp' (ring and "
                             f"Ulysses attention run over it), got "
                             f"{seq_axis!r}")
        self.spec = spec
        self.ranks = np.asarray(ranks, dtype=np.int64).reshape(spec.sizes)
        self.rank = rank
        self.seq_axis = seq_axis
        self._groups: dict = dict(groups or {})

    def sequence(self, axis: Optional[str]) -> "Mesh":
        """This mesh with ``axis`` as its sequence axis (the same ranks and
        process groups)."""
        if axis == self.seq_axis:
            return self
        return Mesh(self.spec, self.ranks, self.rank, self._groups, axis)

    def same_as(self, other: Optional["Mesh"]) -> bool:
        """The same ranks, axes, sequence axis and process groups."""
        return other is self or (
            isinstance(other, Mesh) and self.spec == other.spec
            and self.seq_axis == other.seq_axis and self.rank == other.rank
            and np.array_equal(self.ranks, other.ranks)
            and self._groups == other._groups)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return AXIS_ORDER

    @property
    def size(self) -> int:
        return self.spec.num_devices

    def axis_size(self, axis: str) -> int:
        return getattr(self.spec, axis)

    def coords_of(self, rank: int) -> Dict[str, int]:
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on mesh "
                             f"{self.spec.describe()}")
        return dict(zip(AXIS_ORDER, (int(c) for c in where[0])))

    @property
    def coords(self) -> Dict[str, int]:
        return self.coords_of(self.rank)

    def members(self, axes: Sequence[str], rank: Optional[int] = None
                ) -> List[int]:
        """The ranks that differ from ``rank`` only on ``axes``, in the
        row-major order of those axes' coordinates (the order in which a
        dimension sharded by ``axes`` lays its boxes out)."""
        rank = self.rank if rank is None else rank
        c = self.coords_of(rank)
        index = tuple(slice(None) if a in axes else c[a] for a in AXIS_ORDER)
        sub = self.ranks[index]
        # ``sub`` keeps the axes in AXIS_ORDER; put them in ``axes``' order.
        kept = [a for a in AXIS_ORDER if a in axes]
        order = [kept.index(a) for a in axes if a in kept]
        return [int(r) for r in np.transpose(sub, order).reshape(-1)]

    def index_on(self, axes: Sequence[str], rank: Optional[int] = None
                 ) -> int:
        """This rank's row-major index over ``axes``."""
        c = self.coords_of(self.rank if rank is None else rank)
        idx = 0
        for a in axes:
            idx = idx * self.axis_size(a) + c[a]
        return idx

    def axes_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.axis_size(a) for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group of this rank over ``axes`` (``None`` when the
        axes' product is 1: nothing to communicate)."""
        key = frozenset(a for a in axes if self.axis_size(a) > 1)
        if not key:
            return None
        try:
            return self._groups[key]
        except KeyError:
            raise RuntimeError(
                f"mesh {self.spec.describe()} has no process group over "
                f"{sorted(key)}") from None

    def describe(self) -> str:
        return self.spec.describe()

    def __repr__(self) -> str:
        seq = f", seq_axis={self.seq_axis!r}" if self.seq_axis else ""
        return f"Mesh({self.spec.describe()}, rank={self.rank}{seq})"


_STEP = threading.local()


@contextlib.contextmanager
def stepping(mesh: Optional[Mesh]):
    """Run the block as a step (or an evaluation) of the job on ``mesh``.
    Yields a dict whose ``"cut"`` turns true once a loss claims the
    sequence over ``mesh`` (:func:`claim_sequence`)."""
    prev = getattr(_STEP, "state", None)
    state = _STEP.state = {"mesh": mesh, "cut": False}
    try:
        yield state
    finally:
        _STEP.state = prev


def claim_sequence(mesh: Mesh, who: str) -> None:
    """``who`` is about to run this rank's block of positions over
    ``mesh``'s ``tp`` axis (above 1).  Raises unless ``tp`` is the
    sequence axis of ``mesh`` and, inside a job's step, ``mesh`` is the
    job's: any other mesh would cut the sequence while the job reduces the
    loss and the gradients without ``tp``, or over other ranks."""
    if mesh.seq_axis != "tp":
        raise ValueError(
            f"{who} over mesh {mesh.describe()} cuts each rank's block of "
            f"positions over tp={mesh.axis_size('tp')}, but tp is not the "
            f"mesh's sequence axis: build the job sequence-parallel "
            f"(batch_axes=P(('dp', 'fsdp'), 'tp') or Strategy(rules="
            f"{{'seq': 'tp'}})) and give the loss its mesh "
            f"(accelerate.mesh_for(spec, seq_axis='tp') or job.mesh)")
    state = getattr(_STEP, "state", None)
    if state is None:
        return
    job = state["mesh"]
    if not mesh.same_as(job):
        where = "no mesh" if job is None else job.describe() + (
            "" if job.seq_axis else " without a sequence axis")
        raise ValueError(
            f"{who} cuts the sequence over mesh {mesh.describe()} "
            f"(sequence axis tp), but the job that runs it is on {where}: "
            f"a sequence-parallel loss runs only on its own job's mesh")
    state["cut"] = True


def _axis_sets(spec: MeshSpec) -> List[Tuple[str, ...]]:
    """Every non-empty set of the axes above size 1, in a fixed order."""
    live = [a for a in AXIS_ORDER if getattr(spec, a) > 1]
    out = []
    for k in range(1, len(live) + 1):
        out.extend(itertools.combinations(live, k))
    return out


def _make_groups(spec: MeshSpec, ranks: np.ndarray, rank: int) -> dict:
    """One process group a set of axes (this rank's), every group created
    on every rank in one order (``new_group`` is collective)."""
    import torch.distributed as dist

    from dlrover_tpu_torch.common import dist_env

    world = dist.get_world_size()
    mesh = Mesh(spec, ranks, rank)
    groups = {}
    for axes in _axis_sets(spec):
        if mesh.axes_size(axes) == world:
            groups[frozenset(axes)] = dist.group.WORLD
            continue
        seen = set()
        for r in ranks.reshape(-1):
            members = tuple(mesh.members(axes, int(r)))
            key = tuple(sorted(members))
            if key in seen:
                continue
            seen.add(key)
            g = dist.new_group(list(key), timeout=dist_env.timeout())
            if rank in key:
                groups[frozenset(axes)] = g
    return groups


def _world() -> Tuple[int, int]:
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _finish(spec: MeshSpec, ranks: np.ndarray) -> Mesh:
    world, rank = _world()
    if spec.num_devices != world:
        raise ValueError(
            f"mesh {spec.describe()} ({spec.num_devices} ranks) does not "
            f"cover the process group's {world} process(es)")
    check_axes(spec)
    groups = _make_groups(spec, ranks, rank) if world > 1 else {}
    return Mesh(spec, ranks, rank, groups)


def build_mesh(spec: MeshSpec, devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's world in the canonical axis order:
    rank ``r`` at ``np.unravel_index(r, sizes)``.  ``devices`` may name
    this process's one device (it is ignored: each rank drives one);
    more than one raises."""
    if devices is not None and len(list(devices)) > 1:
        raise NotImplementedError(
            f"build_mesh(devices=...) with {len(list(devices))} devices: "
            f"more than one device a process comes with "
            f"{TP_COMPUTE_ITEM}")
    world, _ = _world()
    spec = spec.normalized(world)
    return _finish(spec, np.arange(world).reshape(spec.sizes))


def build_hybrid_mesh(
    spec: MeshSpec,
    devices: Optional[Sequence] = None,
    *,
    dcn_axes: Tuple[str, ...] = ("pp", "dp"),
    slice_of: Optional[Callable[[int], int]] = None,
) -> Mesh:
    """The hybrid (ICI/DCN) mesh: the axes in ``dcn_axes`` (a prefix of
    the canonical order) span the nodes, every other axis stays inside
    one node.  ``slice_of(rank) -> node`` overrides the node of each rank
    (default: each rank's agent node rank, ``DLROVER_TPU_NODE_RANK``,
    gathered over the group); their product must equal the node count and
    every node must hold the same number of ranks."""
    from dlrover_tpu_torch.common import dist_env
    from dlrover_tpu_torch.common import env as env_utils
    if tuple(dcn_axes) != AXIS_ORDER[: len(dcn_axes)]:
        raise ValueError(
            f"dcn_axes {dcn_axes} must be a prefix of {AXIS_ORDER} "
            "(outer axes ride DCN)"
        )
    if devices is not None and len(list(devices)) > 1:
        raise NotImplementedError(
            f"build_hybrid_mesh(devices=...) with more than one device a "
            f"process comes with {TP_COMPUTE_ITEM}")
    world, _ = _world()
    spec = spec.normalized(world)
    if slice_of is None:
        nodes = (dist_env.allgather_ints(env_utils.get_node_rank())
                 if world > 1 else [env_utils.get_node_rank()])
    else:
        nodes = [int(slice_of(r)) for r in range(world)]
    return _finish(spec, hybrid_layout(spec, nodes, dcn_axes))


def hybrid_layout(spec: MeshSpec, nodes: Sequence[int],
                  dcn_axes: Tuple[str, ...] = ("pp", "dp")) -> np.ndarray:
    """The ranks array of a hybrid mesh: ``nodes[r]`` is rank ``r``'s node;
    the ranks are laid out node by node (nodes in ascending order, ranks
    ascending inside one), as the reference lays out devices slice by
    slice."""
    groups: Dict[int, List[int]] = {}
    for r, n in enumerate(nodes):
        groups.setdefault(n, []).append(r)
    node_ids = sorted(groups)
    sizes = dict(zip(AXIS_ORDER, spec.sizes))
    dcn_total = math.prod(sizes[a] for a in dcn_axes)
    per_node = spec.num_devices // dcn_total
    if dcn_total != len(node_ids):
        raise ValueError(
            f"dcn axes {dcn_axes} give {dcn_total} slices, topology has "
            f"{len(node_ids)}"
        )
    if any(len(groups[s]) != per_node for s in node_ids):
        raise ValueError(
            f"every slice must contribute {per_node} devices, got "
            f"{[len(groups[s]) for s in node_ids]}"
        )
    ordered = [r for s in node_ids for r in groups[s]]
    return np.array(ordered).reshape(spec.sizes)


def batch_share(spec: MeshSpec, rank: int,
                axes: Sequence[str] = BATCH_AXES) -> Tuple[int, int]:
    """``(index, count)``: which of the ``count`` shares of each global
    batch rank ``rank`` of :func:`build_mesh`'s layout is given (its
    row-major index over the batch axes).  Ranks that differ only on the
    other axes (``tp``) share their rows."""
    coords = dict(zip(AXIS_ORDER,
                      (int(c) for c in np.unravel_index(rank, spec.sizes))))
    index, count = 0, 1
    for a in AXIS_ORDER:
        if a in axes:
            index = index * getattr(spec, a) + coords[a]
            count *= getattr(spec, a)
    return index, count


def candidate_specs(
    n_devices: int,
    *,
    max_tp: int = 8,
    allow_pp: bool = False,
    allow_ep: bool = False,
) -> List[MeshSpec]:
    """Plausible factorizations of ``n_devices`` for the strategy search
    (the reference's order, deduplicated)."""
    specs = []
    for tp in [t for t in (1, 2, 4, 8) if t <= min(max_tp, n_devices)]:
        rem = n_devices // tp
        if tp * rem != n_devices:
            continue
        for fsdp in [f for f in _divisors(rem)]:
            dp = rem // fsdp
            specs.append(MeshSpec(dp=dp, fsdp=fsdp, tp=tp))
            if allow_ep and fsdp > 1:
                specs.append(MeshSpec(dp=dp, fsdp=1, ep=fsdp, tp=tp))
        if allow_pp and rem >= 2:
            for pp in (2, 4):
                if rem % pp == 0:
                    specs.append(MeshSpec(pp=pp, dp=rem // pp, tp=tp))
    seen, out = set(), []
    for s in specs:
        if s.sizes not in seen:
            seen.add(s.sizes)
            out.append(s)
    return out


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]
