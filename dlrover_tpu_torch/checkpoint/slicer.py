"""Cross-replica sliced persist and dirty-fence incremental saves — the
port's own copy of ``dlrover_tpu/checkpoint/slicer.py`` (``SLICE_MIN_BYTES``,
``slice_bounds``, ``owner_of_small``, ``_effective_owners``,
``SliceHolder``, ``DirtyTracker``, ``PersistPlan``, ``plan_persist``,
``step_covers``, ``commit_gate``; ``:51-435``) over torch tensors.

- **Slicing** (:func:`plan_persist`): when a tensor's box is held by
  several ranks (``owners`` in the staged ``tensors_info``; in data
  parallelism every rank holds every box), each owner writes only a
  disjoint, element-aligned, byte-balanced range of the box's C-order
  bytes, so the save's aggregate bandwidth grows with the ranks.  A tensor
  of at most :data:`SLICE_MIN_BYTES` goes whole to one owner chosen by a
  hash of its key.  Every rank computes the same partition from the same
  inputs, with no negotiation.
- **Dirty fences** (:class:`DirtyTracker`): a save skips a tensor whose
  staged bytes have the CRC-32 this rank persisted at its *holder* step,
  and writes a meta ``ref`` to the holder's bytes instead.  The probe runs
  on the persist path, never in the train stall.  The tracker is lost on
  restart: the next save is then full, never wrong.
- **The coverage proof** (:func:`step_covers`): a step is committed only
  when its present shards' slices provably tile every tensor, by the
  resharding planner's proof (``reshard/plan.py``): each box's bytes a 1-D
  tensor, each slice a 1-D box; then the boxes must tile each tensor.

The reference's ``integrity_counters`` have no counterpart: a blocked
commit is logged.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.tensor_bytes import byte_view, dtype_key

#: Below this size a tensor is not shredded across owners: it goes whole
#: to one deterministically-chosen owner (hash-balanced across keys).
SLICE_MIN_BYTES = 1 << 16


def slice_bounds(nbytes: int, itemsize: int, n_owners: int,
                 owner_index: int) -> Tuple[int, int]:
    """Byte range ``[lo, hi)`` of one owner's slice of an ``nbytes``
    buffer split across ``n_owners``: element-aligned, contiguous across
    owners, byte-balanced to within one element."""
    if n_owners <= 1:
        return 0, nbytes
    isz = max(1, int(itemsize))
    n_elems = nbytes // isz
    i = int(owner_index)
    lo = (i * n_elems // n_owners) * isz
    if i == n_owners - 1:
        return lo, nbytes
    return lo, ((i + 1) * n_elems // n_owners) * isz


def owner_of_small(key: str, n_owners: int) -> int:
    """The one owner index of a small tensor, spread by a hash of its key
    so that many small tensors balance across the owners."""
    return zlib.crc32(key.encode()) % max(1, n_owners)


def _effective_owners(meta: Optional[dict], world: int) -> Optional[list]:
    """The ranks holding this key's exact box, or ``None`` when unknown
    (then never sliced).  A host leaf is the same on every rank, so the
    whole world owns it."""
    if meta is None:
        return None
    owners = meta.get("owners")
    if owners is not None:
        return [int(r) for r in owners]
    if meta.get("host"):
        return list(range(world))
    return None


@dataclasses.dataclass
class SliceHolder:
    """Where one key's slice bytes live and the CRC they were persisted
    with."""

    step: int
    lo: int
    hi: int
    full_nbytes: int
    crc32: int  # CRC of the staged slice bytes == the written blob's CRC


class DirtyTracker:
    """This rank's memory of what was persisted where."""

    def __init__(self):
        self._holders: Dict[str, SliceHolder] = {}

    def holder(self, key: str) -> Optional[SliceHolder]:
        return self._holders.get(key)

    def note_plan(self, plan: "PersistPlan", step: int,
                  crcs: Dict[str, int]) -> None:
        """Record a successful write of ``plan`` at ``step``: written keys
        get this step as holder, with the writer's CRCs; ref'd keys keep
        theirs."""
        for key, (lo, hi, full) in plan.layout.items():
            if key in plan.refs:
                continue
            crc = crcs.get(key)
            if crc is None:
                continue
            self._holders[key] = SliceHolder(step=int(step), lo=lo, hi=hi,
                                             full_nbytes=full, crc32=int(crc))

    def reset(self) -> None:
        self._holders.clear()


@dataclasses.dataclass
class PersistPlan:
    """What one rank streams for one save."""

    tensors: Dict[str, torch.Tensor]  # payloads to write
    meta_extra: Dict[str, dict]  # per-key shard-meta overlays
    extra: dict  # shard extra (a copy; ref_steps / sliced added)
    layout: Dict[str, Tuple[int, int, int]]  # key -> (lo, hi, full_nbytes)
    refs: Dict[str, int]  # key -> holder step (skipped writes)
    skipped: int
    written_bytes: int  # tensor bytes this rank streams
    logical_bytes: int  # this rank's full unsliced staged bytes


def plan_persist(tensors: Dict[str, torch.Tensor], extra: dict, *,
                 process_id: int = 0, num_processes: int = 1,
                 sliced: bool = True,
                 tracker: Optional[DirtyTracker] = None,
                 holder_exists=None) -> PersistPlan:
    """This rank's part of a staged state (CPU ``tensors``): its slice of
    each box it shares, each whole box it holds alone, and a ``ref`` where
    the bytes match the holder's CRC and ``holder_exists(step)`` confirms
    the holder's shard is still on storage (a lost holder forces a
    rewrite, never a dangling ref)."""
    from dlrover_tpu_torch.checkpoint.shard_file import crc32_bytes

    info = extra.get("tensors_info") or {}
    out: Dict[str, torch.Tensor] = {}
    meta_extra: Dict[str, dict] = {}
    layout: Dict[str, Tuple[int, int, int]] = {}
    refs: Dict[str, int] = {}
    skipped = written = logical = 0
    holder_alive: Dict[int, bool] = {}
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        logical += n
        owners = _effective_owners(info.get(key), num_processes)
        lo, hi = 0, n
        if sliced and owners and len(owners) > 1 \
                and process_id in owners and n > 0:
            if n <= SLICE_MIN_BYTES:
                mine = owner_of_small(key, len(owners))
                lo, hi = (0, n) if owners.index(process_id) == mine \
                    else (0, 0)
            else:
                lo, hi = slice_bounds(n, t.element_size(), len(owners),
                                      owners.index(process_id))
        part = (lo, hi) != (0, n)
        base_meta = {"dtype": dtype_key(t.dtype), "shape": list(t.shape)}
        if part:
            base_meta["slice"] = [lo, hi]
            base_meta["full_nbytes"] = n
        layout[key] = (lo, hi, n)
        view = torch.from_numpy(byte_view(t)[lo:hi]) if part else None
        h = tracker.holder(key) if tracker is not None else None
        if h is not None and (h.lo, h.hi, h.full_nbytes) == (lo, hi, n) \
                and hi > lo:
            alive = holder_alive.get(h.step)
            if alive is None:
                alive = bool(holder_exists(h.step)) if holder_exists \
                    else False
                holder_alive[h.step] = alive
            probe = view.numpy() if view is not None else byte_view(t)
            if alive and crc32_bytes(probe) == h.crc32:
                # The payload is empty, so full_nbytes rides the meta even
                # for a whole entry: the coverage proof reads the covered
                # range from it, never from the payload's size.
                out[key] = torch.empty(0, dtype=torch.uint8)
                meta_extra[key] = dict(
                    base_meta, full_nbytes=n,
                    ref={"step": h.step, "crc32": h.crc32,
                         "nbytes": hi - lo})
                refs[key] = h.step
                skipped += 1
                continue
        out[key] = view if part else t
        if part:
            meta_extra[key] = base_meta
        written += out[key].numel() * out[key].element_size()
    write_extra = dict(extra)
    if refs:
        write_extra["ref_steps"] = sorted({int(s) for s in refs.values()})
    if any("slice" in m for m in meta_extra.values()):
        write_extra["sliced"] = True
    return PersistPlan(tensors=out, meta_extra=meta_extra, extra=write_extra,
                       layout=layout, refs=refs, skipped=skipped,
                       written_bytes=written, logical_bytes=logical)


# -- the coverage proof (commit gate) ------------------------------------


def step_covers(storage, ckpt_dir: str, step: int,
                manifests: Optional[dict] = None) -> Tuple[bool, str]:
    """Prove that the step's present shards cover every tensor exactly,
    with the reshard planner's :meth:`ReshardPlan.validate`, run twice:

    1. **Bytes of each box**: pieces are named by ``(path, box)`` from the
       shard's placement info (not by the per-rank key), and each box's
       present byte slices must tile its full C-order buffer.
    2. **Boxes of each tensor**: the boxes must tile the tensor's global
       shape, so that a dead rank's exclusive box is caught even when a
       lying done vote hides the loss.

    A ref entry covers its range (its bytes are durable elsewhere; fsck
    checks the chain).  Returns ``(ok, reason)``; any failure means "do
    not commit"."""
    from dlrover_tpu_torch.checkpoint import shard_file
    from dlrover_tpu_torch.reshard.plan import (
        MeshLayout,
        PlanError,
        TensorInfo,
        build_plan,
    )

    if manifests is None:
        manifests = {}
        try:
            pids = shard_file.list_shard_ids(storage, ckpt_dir, step)
        except Exception as e:  # noqa: BLE001 - unlistable step dir
            return False, f"step dir unlistable: {e}"
        for pid in pids:
            try:
                man = shard_file.read_shard_manifest(storage, ckpt_dir,
                                                     step, pid)
            except shard_file.ShardCorruptionError as e:
                return False, f"shard {pid} meta unreadable: {e}"
            if man is not None:
                manifests[pid] = man
    if not manifests:
        return False, "no shards present"
    box_full: Dict[str, int] = {}  # box id -> full byte size
    paths_expected: set = set()
    paths_present: set = set()
    byte_shards: Dict[int, Dict[str, tuple]] = {}
    nd_tensors: Dict[str, TensorInfo] = {}
    nd_shards: Dict[int, Dict[str, tuple]] = {}
    for pid, man in manifests.items():
        for p in man.extra.get("tree_paths") or []:
            paths_expected.add(p)
        info = man.extra.get("tensors_info") or {}
        keyed: Dict[str, tuple] = {}
        nd_keyed: Dict[str, tuple] = {}
        for key, tm in man.tensors.items():
            im = info.get(key)
            if not isinstance(im, dict) or "path" not in im \
                    or "index" not in im:
                # Bytes without a place cannot be proven to cover anything.
                return False, f"shard {pid}: no placement for {key!r}"
            path = im["path"]
            paths_present.add(path)
            box = tuple((int(s), int(e)) for s, e in im["index"])
            bid = f"{path}@{'/'.join(f'{s}:{e}' for s, e in box)}"
            sl = tm.get("slice")
            ref = tm.get("ref") if isinstance(tm.get("ref"), dict) else None
            n_full = int(
                tm.get("full_nbytes")
                # older incremental meta: an unsliced ref's payload is the
                # full tensor, so the ref's byte count stands in
                or ((ref or {}).get("nbytes", 0) if not sl else 0)
                or tm.get("nbytes")
                or 0
            )
            lo, hi = (int(sl[0]), int(sl[1])) if sl else (0, n_full)
            prev = box_full.get(bid)
            if prev is not None and prev != n_full:
                return False, (f"{bid!r}: full size disagrees across ranks "
                               f"({prev} vs {n_full})")
            box_full[bid] = n_full
            if hi > lo:
                keyed[f"{bid}|{pid}"] = ((lo, hi),)
            gshape = tuple(int(d) for d in im.get("global_shape") or [])
            ti = nd_tensors.get(path)
            if ti is None:
                nd_tensors[path] = TensorInfo(path=path, global_shape=gshape,
                                              dtype=None)
            elif ti.global_shape != gshape:
                return False, (f"{path!r}: global shape disagrees across "
                               f"ranks ({ti.global_shape} vs {gshape})")
            nd_keyed[f"{path}|@{bid}"] = box
        byte_shards[int(pid)] = keyed
        nd_shards[int(pid)] = nd_keyed
    missing_paths = paths_expected - paths_present
    if missing_paths:
        return False, (f"tensor paths absent from every present shard: "
                       f"{sorted(missing_paths)[:3]}")
    tinfos = {bid: TensorInfo(path=bid, global_shape=(n,), dtype="uint8")
              for bid, n in box_full.items()}
    src = MeshLayout(tensors=tinfos, shards=byte_shards)
    dst = MeshLayout(tensors=tinfos, shards={
        -1: {f"{bid}|full": ((0, n),) for bid, n in box_full.items()
             if n > 0}})
    try:
        build_plan(src, dst).validate()  # proof 1: slice bytes tile boxes
    except PlanError as e:
        return False, str(e)
    nd_dst = MeshLayout(tensors=nd_tensors, shards={
        -1: {f"{path}|full": tuple((0, d) for d in ti.global_shape)
             for path, ti in nd_tensors.items()}})
    try:
        build_plan(MeshLayout(tensors=nd_tensors, shards=nd_shards),
                   nd_dst).validate()  # proof 2: boxes tile the tensors
    except PlanError as e:
        return False, f"box coverage: {e}"
    return True, "ok"


def commit_gate(storage, ckpt_dir: str, step: int) -> bool:
    """:func:`step_covers` at commit time, logged loudly when it fails: a
    gated step keeps the previous committed step as the restore point."""
    ok, reason = step_covers(storage, ckpt_dir, step)
    if not ok:
        logger.error("NOT committing step %d: slice coverage unproven (%s)",
                     step, reason)
    return ok
