"""Incremental (dirty-fence) persist for one process — the port's own copy
of ``dlrover_tpu/checkpoint/slicer.py`` ``SliceHolder``, ``DirtyTracker``,
``PersistPlan`` and ``plan_persist`` with ``num_processes == 1``.

A save skips a tensor whose staged bytes have the CRC-32 this process
persisted at its *holder* step, and writes a meta ``ref`` to the holder's
bytes instead; ``shard_file.read_shard_pieces`` follows the ref, rotation
keeps referenced steps, and fsck checks the chain.  The dirty probe CRCs
the staged bytes on the persist thread, never in the train stall.  The
tracker is lost on restart: the next save is then full, never wrong.

Slicing replicated tensors across ranks (``slice_bounds``,
``owner_of_small``, the coverage proof ``step_covers``/``commit_gate``)
comes with Queue A item 3 (elastic training across processes):
``plan_persist`` raises for ``num_processes > 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.common.tensor_bytes import byte_view, dtype_key

MULTIPROCESS_SLICE = "Queue A item 3 of the port (see ROADMAP.md)"


@dataclasses.dataclass
class SliceHolder:
    """Where one key's bytes live and the CRC they were persisted with."""

    step: int
    lo: int
    hi: int
    full_nbytes: int
    crc32: int


class DirtyTracker:
    """This process's memory of what was persisted where."""

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


@dataclasses.dataclass
class PersistPlan:
    """What one process streams for one save."""

    tensors: Dict[str, torch.Tensor]  # payloads to write
    meta_extra: Dict[str, dict]  # per-key shard-meta overlays
    extra: dict  # shard extra (a copy, ref_steps added)
    layout: Dict[str, Tuple[int, int, int]]  # key -> (lo, hi, full_nbytes)
    refs: Dict[str, int]  # key -> holder step (skipped writes)
    skipped: int
    written_bytes: int
    logical_bytes: int


def plan_persist(tensors: Dict[str, torch.Tensor], extra: dict, *,
                 process_id: int = 0, num_processes: int = 1,
                 tracker: Optional[DirtyTracker] = None,
                 holder_exists=None) -> PersistPlan:
    """The staged CPU ``tensors`` as this process writes them: whole, or a
    ``ref`` where the bytes match the holder's CRC and
    ``holder_exists(step)`` confirms the holder's shard is still on
    storage (a lost holder forces a rewrite, never a dangling ref)."""
    from dlrover_tpu_torch.checkpoint.shard_file import crc32_bytes

    if num_processes != 1 or process_id != 0:
        raise NotImplementedError(
            f"persist plan for process {process_id} of {num_processes}: "
            f"slicing across processes comes with {MULTIPROCESS_SLICE}")
    out: Dict[str, torch.Tensor] = {}
    meta_extra: Dict[str, dict] = {}
    layout: Dict[str, Tuple[int, int, int]] = {}
    refs: Dict[str, int] = {}
    skipped = written = logical = 0
    holder_alive: Dict[int, bool] = {}
    for key, t in tensors.items():
        n = t.numel() * t.element_size()
        logical += n
        layout[key] = (0, n, n)
        h = tracker.holder(key) if tracker is not None else None
        if h is not None and (h.lo, h.hi, h.full_nbytes) == (0, n, n) \
                and n > 0:
            alive = holder_alive.get(h.step)
            if alive is None:
                alive = bool(holder_exists(h.step)) if holder_exists \
                    else False
                holder_alive[h.step] = alive
            if alive and crc32_bytes(byte_view(t)) == h.crc32:
                # The payload is empty, so full_nbytes rides the meta.
                out[key] = torch.empty(0, dtype=torch.uint8)
                meta_extra[key] = {
                    "dtype": dtype_key(t.dtype), "shape": list(t.shape),
                    "full_nbytes": n,
                    "ref": {"step": h.step, "crc32": h.crc32, "nbytes": n},
                }
                refs[key] = h.step
                skipped += 1
                continue
        out[key] = t
        written += n
    write_extra = dict(extra)
    if refs:
        write_extra["ref_steps"] = sorted({int(s) for s in refs.values()})
    return PersistPlan(tensors=out, meta_extra=meta_extra, extra=write_extra,
                       layout=layout, refs=refs, skipped=skipped,
                       written_bytes=written, logical_bytes=logical)
