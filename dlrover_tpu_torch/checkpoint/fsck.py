"""Offline checkpoint fsck — the port's own copy of
``dlrover_tpu/checkpoint/fsck.py`` (``fsck``, ``main``).

Walks a flash-checkpoint directory, verifies every shard against its CRCs
in bounded chunks (v2; v1 shards get structural checks only), and checks
the commit protocol of each step: tracker -> step dir, done votes <->
shard files, the committed step's shards all present, and every ``ref``
of an incremental shard resolving to a live holder with the promised CRC.
Quarantined dirs (``step_N.corrupt`` / ``.quarantined`` marker) are
verified again so that the report names the damaged shard.  The slice
coverage proof of a committed *sliced* step (``slicer.step_covers``) comes
with the multi-process slice (Queue A item 3); one process writes no
slices.

Usage::

    python -m dlrover_tpu_torch.checkpoint.fsck /ckpt/run1 [--json]

Exit codes: ``0`` clean, ``1`` damage found, ``2`` bad invocation.  It
imports neither the engine nor the model code.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

from dlrover_tpu_torch.checkpoint import shard_file
from dlrover_tpu_torch.common.storage import (
    CheckpointStorage,
    PosixDiskStorage,
)

SEV_DAMAGE = "DAMAGE"
SEV_WARN = "WARN"
SEV_INFO = "INFO"


@dataclasses.dataclass
class Finding:
    severity: str  # DAMAGE | WARN | INFO
    step: int  # -1 for directory-level findings
    path: str
    reason: str


@dataclasses.dataclass
class FsckReport:
    ckpt_dir: str
    committed_step: Optional[int] = None
    steps_checked: int = 0
    shards_checked: int = 0
    quarantined_steps: List[int] = dataclasses.field(default_factory=list)
    findings: List[Finding] = dataclasses.field(default_factory=list)

    def add(self, severity: str, step: int, path: str, reason: str) -> None:
        self.findings.append(Finding(severity, step, path, reason))

    @property
    def damaged(self) -> bool:
        return any(f.severity == SEV_DAMAGE for f in self.findings)

    def to_dict(self) -> dict:
        return {
            "ckpt_dir": self.ckpt_dir,
            "committed_step": self.committed_step,
            "steps_checked": self.steps_checked,
            "shards_checked": self.shards_checked,
            "quarantined_steps": self.quarantined_steps,
            "damaged": self.damaged,
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }


def _scan_step_dir(storage: CheckpointStorage, dirpath: str):
    """(shard pid -> filename, done pids) from a step dir's listing —
    path-based, so it also works on quarantine-renamed dirs."""
    shards, done = {}, set()
    for name in storage.listdir(dirpath):
        if name.startswith("shard_") and name.endswith(".ckpt"):
            try:
                shards[int(name[len("shard_") : -len(".ckpt")])] = name
            except ValueError:
                pass
        elif name.startswith(".done_"):
            try:
                done.add(int(name[len(".done_"):]))
            except ValueError:
                pass
    return shards, done


def _check_ref_chain(
    report: FsckReport,
    storage: CheckpointStorage,
    ckpt_dir: str,
    step: int,
    pid: int,
    path: str,
    committed: bool,
) -> None:
    """Verify an incremental shard's reference chain: every ``ref`` entry
    must resolve to a live holder shard whose entry has the same slice
    bounds and the promised CRC.  A broken chain on the committed step is
    damage (the promised restore point cannot be rebuilt); on an
    uncommitted step it only warns (the restore ladder skips it)."""
    sev = SEV_DAMAGE if committed else SEV_WARN
    try:
        man = shard_file.read_shard_manifest(storage, ckpt_dir, step, pid)
    except shard_file.ShardCorruptionError:
        return  # already reported by the shard verification pass
    if man is None:
        return
    cache: dict = {}
    refs = 0
    for key, tm in man.tensors.items():
        if not isinstance(tm.get("ref"), dict):
            continue
        refs += 1
        ref_step = tm["ref"].get("step")
        if isinstance(ref_step, int) and shard_file.is_step_quarantined(
            storage, ckpt_dir, ref_step
        ):
            report.add(
                sev, step, path,
                f"tensor {key!r} references QUARANTINED step {ref_step}",
            )
            continue
        try:
            shard_file._read_ref_blob(
                storage, ckpt_dir, pid, key, tm, cache
            )
        except shard_file.ShardCorruptionError as e:
            report.add(
                sev, step, path, f"broken ref chain: {e.reason}"
            )
    if refs:
        report.add(
            SEV_INFO, step, path,
            f"incremental shard: {refs} tensor(s) reference prior steps "
            f"{sorted(man.extra.get('ref_steps') or [])}",
        )


def _check_step_dir(
    report: FsckReport,
    storage: CheckpointStorage,
    ckpt_dir: str,
    dirpath: str,
    step: int,
    committed: bool,
) -> None:
    shards, done = _scan_step_dir(storage, dirpath)
    world: Optional[int] = None
    verified = set()
    ref_shards: list = []  # (pid, path) needing a chain check
    for pid in sorted(shards):
        path = os.path.join(dirpath, shards[pid])
        # Stream + incremental CRC: peak memory is one chunk (+ meta).
        # An unreadable shard of the committed step is damage: that
        # checkpoint is not restorable as promised.
        f = storage.open_read(path)
        if f is None:
            report.add(
                SEV_DAMAGE if committed else SEV_WARN, step, path,
                "shard listed but unreadable",
            )
            continue
        report.shards_checked += 1
        try:
            with f:
                extra, version = shard_file.verify_shard_file(f, path=path)
        except shard_file.ShardCorruptionError as e:
            report.add(SEV_DAMAGE, step, path, f"corrupt shard: {e.reason}")
            continue
        except OSError as e:
            report.add(
                SEV_DAMAGE if committed else SEV_WARN, step, path,
                f"shard unreadable mid-verify: {e}",
            )
            continue
        verified.add(pid)
        if version == 1:
            report.add(
                SEV_INFO, step, path, "legacy v1 shard (no CRCs to verify)"
            )
        # Refs resolve against the live layout: only an in-place step
        # dir's chain can be checked.
        if extra.get("ref_steps") and \
                dirpath == shard_file.step_dir(ckpt_dir, step):
            ref_shards.append((pid, path))
        w = extra.get("num_processes")
        if isinstance(w, int) and w > 0:
            world = max(world or 0, w)
        if pid not in done:
            report.add(
                SEV_DAMAGE if committed else SEV_WARN, step, path,
                "shard present without its done vote"
                + ("" if committed else " (persist may be in flight)"),
            )
    for pid in sorted(done - set(shards)):
        report.add(
            SEV_DAMAGE, step, os.path.join(dirpath, f".done_{pid:05d}"),
            "done vote present but its shard file is missing",
        )
    # Done votes also bound the world: with every shard unreadable the
    # verified extras can't name num_processes, and the coverage check
    # must still fire for a committed step.
    if done:
        world = max(world or 0, max(done) + 1)
    if committed and world:
        missing = sorted(set(range(world)) - verified)
        if missing:
            report.add(
                SEV_DAMAGE, step, dirpath,
                f"committed step covers {len(verified)}/{world} shards "
                f"(missing or corrupt: {missing})",
            )
    for pid, path in ref_shards:
        _check_ref_chain(report, storage, ckpt_dir, step, pid, path,
                         committed)


def fsck(
    ckpt_dir: str, storage: Optional[CheckpointStorage] = None
) -> FsckReport:
    storage = storage or PosixDiskStorage()
    report = FsckReport(ckpt_dir=ckpt_dir)

    tracker_raw = storage.read(shard_file.tracker_path(ckpt_dir), mode="r")
    committed: Optional[int] = None
    if tracker_raw is None:
        report.add(
            SEV_INFO, -1, shard_file.tracker_path(ckpt_dir),
            "no tracker (nothing committed yet)",
        )
    else:
        try:
            committed = int(str(tracker_raw).strip())
        except ValueError:
            report.add(
                SEV_DAMAGE, -1, shard_file.tracker_path(ckpt_dir),
                f"tracker content is garbage: {str(tracker_raw)[:80]!r}",
            )
    report.committed_step = committed

    live_steps = sorted(shard_file.list_steps(storage, ckpt_dir))
    quarantined = shard_file.list_quarantined(storage, ckpt_dir)
    report.quarantined_steps = [s for s, _ in quarantined]

    if committed is not None and committed not in live_steps:
        reason = "tracker names step with no step dir (GC'd or lost)"
        if committed in report.quarantined_steps:
            reason = "tracker names a QUARANTINED step"
        report.add(
            SEV_DAMAGE, committed,
            shard_file.step_dir(ckpt_dir, committed), reason,
        )

    for step in live_steps:
        report.steps_checked += 1
        _check_step_dir(
            report, storage, ckpt_dir,
            shard_file.step_dir(ckpt_dir, step), step,
            committed=(step == committed),
        )

    # Quarantined dirs count as damage (the quarantine itself is the
    # evidence) and are re-verified so the report names the bad shard.
    for step, dirpath in quarantined:
        report.add(
            SEV_DAMAGE, step, dirpath,
            "step is quarantined (failed verification during restore)",
        )
        _check_step_dir(
            report, storage, ckpt_dir, dirpath, step, committed=False
        )

    return report


def _print_human(report: FsckReport) -> None:
    print(
        f"fsck {report.ckpt_dir}: {report.steps_checked} live step(s), "
        f"{report.shards_checked} shard(s) checked, committed step "
        f"{report.committed_step if report.committed_step is not None else '-'}"
        + (
            f", quarantined: {report.quarantined_steps}"
            if report.quarantined_steps
            else ""
        )
    )
    for f in report.findings:
        where = f"step {f.step}" if f.step >= 0 else "dir"
        print(f"  {f.severity} {where}: {f.path}: {f.reason}")
    damage = sum(1 for f in report.findings if f.severity == SEV_DAMAGE)
    print(f"fsck: {'DAMAGED (%d problem(s))' % damage if damage else 'clean'}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dlrover_tpu_torch.checkpoint.fsck",
        description=(
            "Verify a flash-checkpoint directory: shard CRCs, commit "
            "protocol, coverage.  Exits 1 when damage is found."
        ),
    )
    ap.add_argument("ckpt_dir", help="checkpoint directory to verify")
    ap.add_argument(
        "--json", action="store_true", help="machine-readable report"
    )
    args = ap.parse_args(argv)
    storage = PosixDiskStorage()
    if not storage.exists(args.ckpt_dir):
        print(
            f"fsck: {args.ckpt_dir}: no such checkpoint directory",
            file=sys.stderr,
        )
        return 2
    report = fsck(args.ckpt_dir, storage)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        _print_human(report)
    return 1 if report.damaged else 0


if __name__ == "__main__":
    sys.exit(main())
