"""The parameter-layout planner — the port's own copy of
``dlrover_tpu/parallel/layout_planner.py`` (``DEFAULT_MIN_SHARD_BYTES``,
``LeafPlan``, ``_assignments``, ``_score``, ``plan_layout`` ``:99``,
``plan_report`` ``:135``, ``validate_layout`` ``:164``).

For every parameter leaf it picks which mesh axes shard which tensor
dimensions by an exhaustive search over axis->dimension assignments,
scored by the bytes a device keeps and a mild penalty that puts ``tp`` on
the last dimension and the other axes elsewhere (the Megatron row/column
convention).  Leaves under ``min_shard_bytes`` stay replicated.  Pure
Python and numpy on shapes: a leaf is anything with ``shape`` and
``dtype`` (a tensor, a ``meta`` tensor).  Paths are named as
``jax.tree_util.keystr`` names them, dict keys in sorted order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.parallel.sharding import PartitionSpec as P
from dlrover_tpu_torch.parallel.sharding import tree_map

DEFAULT_MIN_SHARD_BYTES = 1 << 16


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    path: str
    shape: Tuple[int, ...]
    spec: Any  # PartitionSpec
    bytes_total: int
    bytes_per_device: int


def _itemsize(x) -> int:
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt).element_size()
    return np.dtype(dt if dt is not None else np.float32).itemsize


def _shape(x) -> Tuple[int, ...]:
    return tuple(int(d) for d in getattr(x, "shape", np.shape(x)))


def _leaf_bytes(x) -> int:
    shape = _shape(x)
    n = int(np.prod(shape, dtype=np.int64)) if shape else 1
    return n * _itemsize(x)


def _assignments(ndim: int, axes: Sequence[str]
                 ) -> List[Tuple[Tuple[str, int], ...]]:
    """Every way to map each mesh axis to a distinct dimension (or to
    none)."""
    out: List[Tuple[Tuple[str, int], ...]] = [()]
    for ax in axes:
        new: List[Tuple[Tuple[str, int], ...]] = []
        for partial in out:
            used = {d for _, d in partial}
            new.append(partial)
            for d in range(ndim):
                if d not in used:
                    new.append(partial + ((ax, d),))
        out = new
    return out


def _score(shape: Tuple[int, ...], itemsize: int,
           assign: Tuple[Tuple[str, int], ...], axis_sizes: Dict[str, int],
           prefer_last: Sequence[str]) -> Optional[float]:
    """Lower is better; ``None`` when a dimension is not divisible."""
    per_dev = int(np.prod(shape, dtype=np.int64)) * itemsize
    for ax, d in assign:
        n = axis_sizes[ax]
        if shape[d] % n != 0 or shape[d] < n:
            return None
        per_dev //= n
    cost = float(per_dev)
    for ax, d in assign:
        if ax in prefer_last and d != len(shape) - 1:
            cost *= 1.05
        if ax not in prefer_last and d == len(shape) - 1:
            cost *= 1.05
    return cost


def plan_layout(params: Any, axis_sizes: Dict[str, int], *,
                min_shard_bytes: int = DEFAULT_MIN_SHARD_BYTES,
                tp_axes: Sequence[str] = ("tp",)) -> Any:
    """A tree of leaves -> the tree of PartitionSpecs; ``axis_sizes`` maps
    the shardable mesh axes to their sizes (size-1 axes are ignored)."""
    axes = [a for a, n in axis_sizes.items() if n > 1]

    def per_leaf(x):
        shape = _shape(x)
        if not axes or not shape or _leaf_bytes(x) < min_shard_bytes:
            return P()
        itemsize = _itemsize(x)
        best, best_cost = (), float("inf")
        for assign in _assignments(len(shape), axes):
            cost = _score(shape, itemsize, assign, axis_sizes, tp_axes)
            if cost is not None and cost < best_cost:
                best, best_cost = assign, cost
        parts: List[Any] = [None] * len(shape)
        for ax, d in best:
            parts[d] = ax
        while parts and parts[-1] is None:
            parts.pop()
        return P(*parts)

    return tree_map(per_leaf, params)


def flatten_with_path(tree: Any, is_leaf=None, path: str = ""
                      ) -> List[Tuple[str, Any]]:
    """``[(keystr path, leaf)]`` in ``jax.tree_util``'s order."""
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], is_leaf,
                                            f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [kv for i, v in enumerate(tree)
                for kv in flatten_with_path(v, is_leaf, f"{path}[{i}]")]
    return [(path, tree)]


def _spec_leaves(specs: Any) -> List[Any]:
    return [s for _, s in flatten_with_path(
        specs, is_leaf=lambda v: isinstance(v, P))]


def plan_report(params: Any, specs: Any, axis_sizes: Dict[str, int]
                ) -> List[LeafPlan]:
    """Per leaf: path, shape, spec, bytes in all and per device."""
    out = []
    for (path, leaf), spec in zip(flatten_with_path(params),
                                  _spec_leaves(specs)):
        total = _leaf_bytes(leaf)
        denom = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    denom *= axis_sizes.get(a, 1)
        out.append(LeafPlan(path=path, shape=_shape(leaf), spec=spec,
                            bytes_total=total,
                            bytes_per_device=total // denom))
    return out


def validate_layout(params: Any, specs: Any,
                    axis_sizes: Dict[str, int]) -> None:
    """Raise ``ValueError`` on an unknown axis or an indivisible
    dimension."""
    for (path, leaf), spec in zip(flatten_with_path(params),
                                  _spec_leaves(specs)):
        shape = _shape(leaf)
        for d, ax in enumerate(spec):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is None:
                    continue
                if a not in axis_sizes:
                    raise ValueError(f"{path}: unknown mesh axis {a!r}")
                if shape[d] % axis_sizes[a] != 0:
                    raise ValueError(
                        f"{path}: dim {d} ({shape[d]}) not divisible by "
                        f"{a}={axis_sizes[a]}")
