"""The tiling proof of the resharding planner — the port's own copy of
the part of ``dlrover_tpu/reshard/plan.py`` that the checkpoint reaches:
``box_volume``, ``box_intersect``, ``box_subtract``, ``TensorInfo``,
``MeshLayout``, ``Segment``, ``ReshardPlan`` (``validate``), ``build_plan``,
``layout_from_tensors_info`` and ``ranks_needed``.

A *layout* says where every tensor's bytes live: for each rank, the boxes
(global coordinates) it holds, keyed ``"<path>|<k>"`` as
``checkpoint/tree_utils.flatten_to_shards`` keys the staged state.  A
*plan* is the list of :class:`Segment` transfers that rebuild a target
layout from a source layout, and :meth:`ReshardPlan.validate` proves the
segments tile every target shard exactly once: no gap, no overlap, no
read outside a source shard.  ``checkpoint/slicer.step_covers`` runs that
proof over a step's slices (each tensor's bytes a 1-D tensor, each slice a
1-D box), and the engine's shard selection asks :func:`ranks_needed`.
Everything here is a pure function of its inputs.  The layouts of a mesh
(``MeshSpec``, ``shard_boxes``, ``build_layout``) and the live mover wait
for the multi-card slice (Queue A item 5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

#: A region in global tensor coordinates: ((start, stop), ...) per dim.
Box = Tuple[Tuple[int, int], ...]


class PlanError(ValueError):
    """A layout/plan inconsistency: uncoverable target shard, overlapping
    segments, out-of-bounds source read.  Callers treat this as "live
    reshard impossible" and fall back to the checkpoint-restart ladder."""


def box_volume(box: Box) -> int:
    return int(math.prod(max(0, e - s) for s, e in box))


def box_intersect(a: Box, b: Box) -> Optional[Box]:
    """Overlap of two boxes, or ``None`` when empty.  A 0-d box (scalar
    tensor) intersects itself as ``()`` — callers must test ``is None``,
    not truthiness."""
    out = []
    for (as_, ae), (bs, be) in zip(a, b):
        lo, hi = max(as_, bs), min(ae, be)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def box_subtract(box: Box, hole: Box) -> List[Box]:
    """``box`` minus ``hole`` (which must be fully inside ``box``) as a
    list of disjoint boxes — the axis-sweep decomposition."""
    out: List[Box] = []
    cur = list(box)
    for dim, ((cs, ce), (hs, he)) in enumerate(zip(box, hole)):
        if hs > cs:
            out.append(
                tuple(cur[:dim]) + ((cs, hs),) + tuple(box[dim + 1:])
            )
        if he < ce:
            out.append(
                tuple(cur[:dim]) + ((he, ce),) + tuple(box[dim + 1:])
            )
        cur[dim] = (hs, he)
    return out


@dataclasses.dataclass(frozen=True)
class TensorInfo:
    path: str
    global_shape: Tuple[int, ...]
    dtype: Optional[str] = None  # numpy dtype name; None = unknown

    @property
    def itemsize(self) -> int:
        if self.dtype is None:
            return 1
        return int(np.dtype(self.dtype).itemsize)


@dataclasses.dataclass
class MeshLayout:
    """Where every tensor's bytes live: rank -> {shard key -> box}."""

    tensors: Dict[str, TensorInfo]
    #: rank -> key ("<path>|<k>") -> box in global coords
    shards: Dict[int, Dict[str, Box]]

    def ranks(self) -> List[int]:
        return sorted(self.shards)

    def boxes_of(self, path: str) -> List[Tuple[int, str, Box]]:
        """All (rank, key, box) pieces of one tensor across ranks."""
        out = []
        for rank in self.ranks():
            for key, box in self.shards[rank].items():
                if key.rsplit("|", 1)[0] == path:
                    out.append((rank, key, box))
        return out

    def total_bytes(self, rank: int) -> int:
        total = 0
        for key, box in self.shards.get(rank, {}).items():
            info = self.tensors[key.rsplit("|", 1)[0]]
            total += box_volume(box) * info.itemsize
        return total


def layout_from_tensors_info(
    infos_by_rank: Dict[int, Dict[str, dict]],
    dtypes: Optional[Dict[str, str]] = None,
) -> MeshLayout:
    """Layout from checkpoint/arena ``tensors_info`` metadata (the
    ``{key: {path, global_shape, index}}`` dicts ``flatten_to_shards``
    produces and every shard file embeds) — how the checkpoint engine
    reuses the planner to restore to whatever mesh the new world has."""
    tensors: Dict[str, TensorInfo] = {}
    shards: Dict[int, Dict[str, Box]] = {}
    for rank, infos in infos_by_rank.items():
        keyed: Dict[str, Box] = {}
        for key, meta in infos.items():
            path = meta["path"]
            box = tuple(tuple(int(v) for v in p) for p in meta["index"])
            keyed[key] = box
            shape = tuple(int(d) for d in meta["global_shape"])
            dtype = meta.get("dtype") or (dtypes or {}).get(path)
            known = tensors.get(path)
            if known is None:
                tensors[path] = TensorInfo(path, shape, dtype)
            elif known.global_shape != shape:
                raise PlanError(
                    f"{path}: global shape disagrees across ranks "
                    f"({known.global_shape} vs {shape})"
                )
        shards[rank] = keyed
    return MeshLayout(tensors=tensors, shards=shards)


def _contiguous_byte_range(
    seg_box: Box, src_box: Box, itemsize: int
) -> Optional[Tuple[int, int]]:
    """(offset, length) of ``seg_box`` inside the C-ordered buffer of the
    source shard ``src_box``, when the region is one contiguous run."""
    src_shape = tuple(e - s for s, e in src_box)
    local = tuple(
        (bs - ss, be - ss) for (bs, be), (ss, _) in zip(seg_box, src_box)
    )
    extents = tuple(e - s for s, e in local)
    # Contiguity in row-major order: trailing dims fully covered, at most
    # one partial dim before them, and every dim before that singleton.
    j = len(extents)
    while j > 0 and extents[j - 1] == src_shape[j - 1]:
        j -= 1
    if j > 0:
        j -= 1  # dim j may be partial
    if any(extents[i] != 1 for i in range(j)):
        return None
    stride = itemsize
    strides = [0] * len(src_shape)
    for i in range(len(src_shape) - 1, -1, -1):
        strides[i] = stride
        stride *= max(1, src_shape[i])
    offset = sum(local[i][0] * strides[i] for i in range(len(src_shape)))
    length = int(math.prod(extents)) * itemsize
    return offset, length


@dataclasses.dataclass(frozen=True)
class Segment:
    """One transfer: bytes of ``box`` (global coords) move from source
    shard ``src_key`` on ``src_rank`` into destination shard ``dst_key``
    on ``dst_rank``.  ``byte_range`` is the contiguous (offset, length)
    within the source shard's buffer when the region is one run — the
    zero-copy fast path; ``None`` means a strided gather."""

    path: str
    src_rank: int
    dst_rank: int
    src_key: str
    dst_key: str
    box: Box
    src_box: Box
    dst_box: Box
    nbytes: int
    byte_range: Optional[Tuple[int, int]] = None

    @property
    def local(self) -> bool:
        return self.src_rank == self.dst_rank


@dataclasses.dataclass
class ReshardPlan:
    src: MeshLayout
    dst: MeshLayout
    segments: List[Segment]

    def for_dst_rank(self, rank: int) -> List[Segment]:
        return [s for s in self.segments if s.dst_rank == rank]

    def src_ranks_needed(self, dst_rank: int) -> List[int]:
        """Peers ``dst_rank`` must pull from (itself excluded)."""
        return sorted(
            {
                s.src_rank
                for s in self.segments
                if s.dst_rank == dst_rank and not s.local
            }
        )

    def stats(self) -> dict:
        local = sum(s.nbytes for s in self.segments if s.local)
        cross = sum(s.nbytes for s in self.segments if not s.local)
        return {
            "segments": len(self.segments),
            "local_bytes": int(local),
            "cross_bytes": int(cross),
            "contiguous_segments": sum(
                1 for s in self.segments if s.byte_range is not None
            ),
        }

    # -- the proof obligation ------------------------------------------------
    def validate(self) -> None:
        """Prove the plan: every target shard is tiled exactly once by its
        segments (full coverage, no overlap), and every segment reads
        strictly inside a real source shard.  Raises :class:`PlanError`."""
        by_dst: Dict[Tuple[int, str], List[Segment]] = {}
        for seg in self.segments:
            by_dst.setdefault((seg.dst_rank, seg.dst_key), []).append(seg)
            src_shards = self.src.shards.get(seg.src_rank)
            if src_shards is None or seg.src_key not in src_shards:
                raise PlanError(
                    f"segment reads {seg.src_key!r} which rank "
                    f"{seg.src_rank} does not hold"
                )
            src_box = src_shards[seg.src_key]
            if src_box != seg.src_box or box_intersect(
                seg.box, src_box
            ) != seg.box:
                raise PlanError(
                    f"segment {seg.box} escapes its source shard "
                    f"{src_box} ({seg.src_key!r})"
                )
        for dst_rank, shard_map in self.dst.shards.items():
            for key, box in shard_map.items():
                info = self.dst.tensors[key.rsplit("|", 1)[0]]
                vol = box_volume(box)
                segs = by_dst.get((dst_rank, key), [])
                if vol == 0:
                    if segs:
                        raise PlanError(
                            f"empty target shard {key!r} has segments"
                        )
                    continue
                total = 0
                for seg in segs:
                    if box_intersect(seg.box, box) != seg.box:
                        raise PlanError(
                            f"segment {seg.box} escapes target shard "
                            f"{box} ({key!r} on rank {dst_rank})"
                        )
                    total += box_volume(seg.box)
                if total != vol:
                    raise PlanError(
                        f"target shard {key!r} on rank {dst_rank} covered "
                        f"{total}/{vol} cells"
                    )
                # Exactly-once: volumes match AND pairwise disjoint.
                for i in range(len(segs)):
                    for j in range(i + 1, len(segs)):
                        if box_intersect(
                            segs[i].box, segs[j].box
                        ) is not None:
                            raise PlanError(
                                f"segments overlap inside {key!r}: "
                                f"{segs[i].box} vs {segs[j].box}"
                            )
                # dtype coherence source vs destination.
                for seg in segs:
                    src_info = self.src.tensors.get(seg.path)
                    if (
                        src_info is not None
                        and src_info.dtype
                        and info.dtype
                        and src_info.dtype != info.dtype
                    ):
                        raise PlanError(
                            f"{seg.path}: dtype changes across the plan "
                            f"({src_info.dtype} -> {info.dtype})"
                        )


def build_plan(
    src: MeshLayout, dst: MeshLayout, validate: bool = True
) -> ReshardPlan:
    """Cover every target shard from the source pieces, preferring
    same-rank sources (replicated leaves then move zero bytes), closest
    ranks next.  Raises :class:`PlanError` when any target region is not
    covered by the union of source pieces.
    The plan is a function of the two layouts only."""
    segments: List[Segment] = []
    piece_cache: Dict[str, List[Tuple[int, str, Box]]] = {}
    for path in dst.tensors:
        if path not in src.tensors:
            raise PlanError(f"source layout has no tensor {path!r}")
        piece_cache[path] = [
            (r, k, b)
            for (r, k, b) in src.boxes_of(path)
            if box_volume(b) > 0
        ]
    for dst_rank in dst.ranks():
        for dst_key, dst_box in dst.shards[dst_rank].items():
            if box_volume(dst_box) == 0:
                continue
            path = dst_key.rsplit("|", 1)[0]
            info = dst.tensors[path]
            pieces = sorted(
                piece_cache[path],
                key=lambda p: (p[0] != dst_rank, abs(p[0] - dst_rank), p[0], p[1]),
            )
            uncovered: List[Box] = [dst_box]
            for src_rank, src_key, src_box in pieces:
                if not uncovered:
                    break
                next_uncovered: List[Box] = []
                for hole in uncovered:
                    inter = box_intersect(hole, src_box)
                    if inter is None:
                        next_uncovered.append(hole)
                        continue
                    segments.append(
                        Segment(
                            path=path,
                            src_rank=src_rank,
                            dst_rank=dst_rank,
                            src_key=src_key,
                            dst_key=dst_key,
                            box=inter,
                            src_box=src_box,
                            dst_box=dst_box,
                            nbytes=box_volume(inter) * info.itemsize,
                            byte_range=_contiguous_byte_range(
                                inter, src_box, info.itemsize
                            ),
                        )
                    )
                    next_uncovered.extend(box_subtract(hole, inter))
                uncovered = next_uncovered
            if uncovered:
                raise PlanError(
                    f"target shard {dst_key!r} on rank {dst_rank} has "
                    f"uncovered regions {uncovered[:3]} (source layout "
                    "does not hold these bytes)"
                )
    plan = ReshardPlan(src=src, dst=dst, segments=segments)
    if validate:
        plan.validate()
    return plan


def ranks_needed(
    src_infos_by_rank: Dict[int, Dict[str, dict]],
    dst_boxes: Dict[str, Iterable[Box]],
    dst_rank: int = 0,
) -> List[int]:
    """Which source ranks' shards a single destination rank must read to
    cover ``dst_boxes`` (``{path: [box, ...]}``) — the checkpoint
    engine's selective-shard-read question.  Raises :class:`PlanError`
    when the sources cannot cover the target."""
    src = layout_from_tensors_info(src_infos_by_rank)
    keyed: Dict[str, Box] = {}
    tensors: Dict[str, TensorInfo] = {}
    for path, boxes in dst_boxes.items():
        if path not in src.tensors:
            raise PlanError(f"source layout has no tensor {path!r}")
        tensors[path] = src.tensors[path]
        for k, box in enumerate(sorted({tuple(b) for b in boxes})):
            keyed[f"{path}|{k}"] = box
    dst = MeshLayout(tensors=tensors, shards={dst_rank: keyed})
    plan = build_plan(src, dst, validate=False)
    return sorted({s.src_rank for s in plan.segments})
