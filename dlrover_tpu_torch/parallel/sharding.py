"""Logical-axis sharding rules and placements — the port's own copy of
``dlrover_tpu/parallel/sharding.py`` (``Rules``, ``DEFAULT_RULES`` ``:26``,
``logical_to_spec`` ``:40``, ``tree_logical_to_specs`` ``:71``,
``shard_tree`` ``:81``, ``named_sharding_tree`` ``:91``, ``constraint``
``:99``) with a :class:`PartitionSpec` of its own.

Models name the axes of each parameter (``'embed'``, ``'heads'``,
``'mlp'``, ``'vocab'``, ...); a rule table maps those names to mesh axes;
the result is a :class:`PartitionSpec` per leaf, compared with the
reference's element for element (a one-axis tuple is that axis, trailing
``None`` entries are trimmed by :func:`logical_to_spec` only, as in the
reference).

A :class:`Placement` is one leaf's spec on a :class:`~.mesh.Mesh` with the
leaf's global shape: it gives each rank's *box* (``((start, stop), ...)``
per dimension) by the reference's arithmetic: a dimension sharded by the
axes ``(a1, ..., ak)`` is cut into ``prod(sizes)`` equal contiguous
slices, and the rank at row-major index ``i`` over those axes holds slice
``i``.  :func:`shard_tree` keeps this rank's box of each leaf of a tree of
whole tensors and tags the box with its placement (:func:`placement_of`);
the checkpoint and the train step read the tag.

``constraint`` (``with_sharding_constraint`` on activations) is refused by
name: the port does not shard activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from dlrover_tpu_torch.common.constants import TP_COMPUTE_ITEM
from dlrover_tpu_torch.parallel.mesh import AXIS_ORDER, Mesh

Rules = Dict[str, Union[str, Tuple[str, ...], None]]
Box = Tuple[Tuple[int, int], ...]

DEFAULT_RULES: Rules = {
    "batch": ("dp", "fsdp"),
    "seq": None,
    "embed": "fsdp",
    "heads": "tp",
    "kv": None,
    "mlp": "tp",
    "vocab": "tp",
    "layers": None,
    "expert": "ep",
    "expert_mlp": "tp",
}


class PartitionSpec(tuple):
    """Per dimension: ``None`` (whole), a mesh axis, or a tuple of mesh
    axes (a one-axis tuple is stored as the axis, as JAX does)."""

    def __new__(cls, *parts):
        norm = []
        for p in parts:
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                if len(p) == 1:
                    p = p[0]
                elif not p:
                    p = None
            norm.append(p)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(tuple(self))}"

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec names, in order."""
        out = []
        for p in self:
            out.extend(_part_axes(p))
        return tuple(out)


P = PartitionSpec


def _part_axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[Rules] = None) -> PartitionSpec:
    """``('embed', 'mlp') -> PartitionSpec('fsdp', 'tp')`` under the rule
    table; a mesh axis is used once (a later dimension that maps to a used
    axis stays whole); trailing ``None`` entries are trimmed."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    out = []
    used = set()
    for ax in logical_axes:
        if ax is None:
            out.append(None)
            continue
        phys = rules.get(ax)
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, tuple):
            phys = tuple(p for p in phys if p not in used)
            used.update(phys)
            out.append(phys if phys else None)
        else:
            if phys in used:
                out.append(None)
            else:
                used.add(phys)
                out.append(phys)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _is_axes_tuple(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, PartitionSpec) \
        and all(isinstance(a, (str, type(None))) for a in x)


def tree_map(fn: Callable, tree: Any, *rest: Any,
             is_leaf: Optional[Callable[[Any], bool]] = None) -> Any:
    """``fn`` over the leaves of a nested dict/list tree (and the matching
    leaves of ``rest``); a dict keeps its keys, a list its order."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, list) or (isinstance(tree, tuple)
                                  and not isinstance(tree, PartitionSpec)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_logical_to_specs(logical_tree: Any,
                          rules: Optional[Rules] = None) -> Any:
    """A tree of logical-axis tuples -> the tree of PartitionSpecs."""
    return tree_map(lambda axes: logical_to_spec(axes, rules), logical_tree,
                    is_leaf=_is_axes_tuple)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec

    def placement(self, shape: Sequence[int]) -> "Placement":
        return Placement(self.mesh, self.spec,
                         tuple(int(d) for d in shape))


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """One leaf's spec on a mesh, with its global shape."""

    mesh: Mesh
    spec: PartitionSpec
    global_shape: Tuple[int, ...]

    def __post_init__(self):
        validate_spec(self.spec, self.global_shape, self.mesh)

    @property
    def axes(self) -> Tuple[str, ...]:
        """The mesh axes above size 1 that shard the leaf."""
        return tuple(a for a in self.spec.axes()
                     if self.mesh.axis_size(a) > 1)

    @property
    def sharded(self) -> bool:
        return bool(self.axes)

    @property
    def replicas(self) -> int:
        """Ranks that hold each box."""
        return self.mesh.size // self.mesh.axes_size(self.axes)

    def box(self, rank: Optional[int] = None) -> Box:
        """``rank``'s box (this rank's by default)."""
        rank = self.mesh.rank if rank is None else rank
        out = []
        for d, n in enumerate(self.global_shape):
            part = self.spec[d] if d < len(self.spec) else None
            axes = _part_axes(part)
            count = self.mesh.axes_size(axes)
            if count <= 1:
                out.append((0, n))
                continue
            i = self.mesh.index_on(axes, rank)
            step = n // count
            out.append((i * step, (i + 1) * step))
        return tuple(out)

    def owners(self, rank: Optional[int] = None) -> list:
        """The ranks that hold ``rank``'s box, sorted."""
        return sorted(self.mesh.members(
            [a for a in AXIS_ORDER if a not in self.axes], rank))

    def on(self, mesh: Mesh) -> "Placement":
        """The same spec on another mesh (the reference's re-homing)."""
        return Placement(mesh, self.spec, self.global_shape)


def validate_spec(spec: PartitionSpec, shape: Sequence[int],
                  mesh: Mesh) -> None:
    """Raise ``ValueError`` for an unknown or repeated mesh axis, a spec
    longer than the leaf, or a dimension its axes do not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec!r} has more entries than the leaf's "
                         f"{len(shape)} dimensions")
    seen = set()
    for d, part in enumerate(spec):
        axes = _part_axes(part)
        for a in axes:
            if a not in AXIS_ORDER:
                raise ValueError(f"unknown mesh axis {a!r} in {spec!r}")
            if a in seen:
                raise ValueError(f"mesh axis {a!r} used twice in {spec!r}")
            seen.add(a)
        count = mesh.axes_size(axes)
        if count > 1 and shape[d] % count:
            raise ValueError(f"dim {d} ({shape[d]}) of a {tuple(shape)} "
                             f"leaf not divisible by {axes}={count}")


_TAG = "_dlr_placement"


def placement_of(t: torch.Tensor) -> Optional[Placement]:
    """The placement a box was tagged with (``None``: a whole tensor)."""
    return getattr(t, _TAG, None)


def tag(t: torch.Tensor, placement: Optional[Placement]) -> torch.Tensor:
    setattr(t, _TAG, placement)
    return t


def box_slices(box: Box) -> Tuple[slice, ...]:
    return tuple(slice(s, e) for s, e in box)


def shard_leaf(t: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's box of the whole tensor ``t`` (a copy when it is a part),
    tagged with its placement."""
    pl = sharding.placement(t.shape)
    if pl.sharded:
        t = t[box_slices(pl.box())].clone()
    return tag(t, pl)


def shard_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """This rank's box of each leaf of ``tree`` (whole tensors) under
    ``specs`` (the reference's ``device_put`` onto ``NamedSharding``s)."""
    return tree_map(lambda x, s: shard_leaf(x, NamedSharding(mesh, s)),
                    tree, specs)


def named_sharding_tree(specs: Any, mesh: Mesh) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), specs,
                    is_leaf=lambda x: isinstance(x, PartitionSpec))


def constraint(x, logical_axes, rules: Optional[Rules] = None):
    raise NotImplementedError(
        f"constraint(): activation layouts come with {TP_COMPUTE_ITEM}")
