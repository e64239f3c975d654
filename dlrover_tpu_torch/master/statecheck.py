"""The control-state journal's fsck: ``python -m
dlrover_tpu_torch.master.statecheck STATE_DIR [--json]`` — the port's own
copy of ``dlrover_tpu/master/statecheck.py`` (``check_state_dir`` ``:72``,
``main``).

It checks a master HA state dir (``master/state.py``):

- framing: the WAL's and the snapshot's magic, every frame's CRC-32 and
  length.  A torn tail (a crash mid-append) is reported and counted and
  is clean; a bad frame anywhere else is damage;
- sequence: seqs increase, generations never go back;
- replay: the snapshot and the records replayed into a fresh set of the
  port's managers, through their own methods; a divergence (a grant that
  gives another task id than the journal promised) is damage;
- replay-equivalence: the replayed state survives capture, restore and
  capture unchanged, so the snapshot surface a standby depends on drops
  nothing.

It reads the reference's directories as well as the port's.  Exit codes:
0 clean (a torn tail allowed), 1 damage, 2 usage.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any

from dlrover_tpu_torch.master.state import MasterState, read_state_dir


def _fresh_state() -> MasterState:
    from dlrover_tpu_torch.common.constants import RendezvousName
    from dlrover_tpu_torch.master.kv_store import KVStoreService
    from dlrover_tpu_torch.master.node_manager import LocalJobManager
    from dlrover_tpu_torch.master.rendezvous import (
        ElasticTrainingRendezvousManager,
        NetworkCheckRendezvousManager,
    )
    from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
    from dlrover_tpu_torch.master.sync_service import SyncService
    from dlrover_tpu_torch.master.task_manager import TaskManager

    return MasterState(
        kv_store=KVStoreService(), task_manager=TaskManager(),
        rdzv_managers={
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        },
        job_manager=LocalJobManager(), speed_monitor=SpeedMonitor(),
        sync_service=SyncService())


def _canon(obj: Any) -> Any:
    """An order-insensitive form of a state dict, for comparison."""
    if isinstance(obj, dict):
        return tuple((k, _canon(v))
                     for k, v in sorted(obj.items(), key=lambda i: str(i[0])))
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(v) for v in obj)
    return obj


def check_state_dir(state_dir: str) -> dict:
    """Every check; the report (``clean``, ``damage`` and the counts)."""
    contents = read_state_dir(state_dir)
    report: dict = {
        "state_dir": state_dir,
        "records": len(contents.records),
        "snapshot": contents.snapshot is not None,
        "snapshot_seq": contents.snap_seq,
        "torn_tail_bytes": contents.torn_tail_bytes,
        "damage": list(contents.damage),
        "divergences": [],
        "kinds": {},
        "generations": [],
    }
    # Records at or below the snapshot's label are a legitimate overlap
    # (a crash between the snapshot's write and the compaction); replay
    # applies them again idempotently.
    last_seq = last_gen = overlap = 0
    for rec in contents.records:
        kind = rec.get("k", "?")
        report["kinds"][kind] = report["kinds"].get(kind, 0) + 1
        seq, gen = int(rec.get("s", -1)), int(rec.get("g", 0))
        overlap += seq <= contents.snap_seq
        if seq <= last_seq:
            report["damage"].append(f"seq not increasing: {seq} after "
                                    f"{last_seq}")
        if gen < last_gen:
            report["damage"].append(f"generation went backwards: {gen} "
                                    f"after {last_gen} (seq {seq})")
        if gen != last_gen:
            report["generations"].append(gen)
        last_seq, last_gen = seq, gen
    report["last_seq"] = last_seq
    report["snapshot_overlap_records"] = overlap

    state = _fresh_state()
    if contents.snapshot is not None:
        try:
            state.restore(contents.snapshot)
        except Exception as e:  # noqa: BLE001 - classified as damage
            report["damage"].append(
                f"snapshot restore raised {type(e).__name__}: {e}")
    report["divergences"] = state.replay(contents.records)
    report["damage"].extend(report["divergences"])
    try:
        s1 = state.capture()
        again = _fresh_state()
        again.restore(s1)
        s2 = again.capture()
        if _canon(s1) != _canon(s2):
            keys = [k for k in s1 if _canon(s1.get(k)) != _canon(s2.get(k))]
            report["damage"].append("replay-equivalence failed: capture/"
                                    f"restore round trip diverged in {keys}")
    except Exception as e:  # noqa: BLE001 - classified as damage
        report["damage"].append(
            f"replay-equivalence raised {type(e).__name__}: {e}")
    report["clean"] = not report["damage"]
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "dlrover_tpu_torch.master.statecheck",
        description="verify a master HA control-state dir")
    p.add_argument("state_dir")
    p.add_argument("--json", action="store_true", dest="as_json")
    try:
        args = p.parse_args(argv)
    except SystemExit:
        return 2
    if not os.path.isdir(args.state_dir):
        print(f"statecheck: {args.state_dir} is not a directory",
              file=sys.stderr)
        return 2
    report = check_state_dir(args.state_dir)
    if args.as_json:
        print(json.dumps(report, indent=2))
    else:
        snap = (f"seq {report['snapshot_seq']}" if report["snapshot"]
                else "none")
        print(f"state dir:      {report['state_dir']}")
        print(f"snapshot:       {snap}")
        print(f"wal records:    {report['records']} (last seq "
              f"{report['last_seq']})")
        if report["torn_tail_bytes"]:
            print(f"torn tail:      {report['torn_tail_bytes']} bytes "
                  "(crash mid-append; truncated at next writer open)")
        for kind, n in sorted(report["kinds"].items()):
            print(f"  {kind:<18} {n}")
        if report["damage"]:
            print("DAMAGE:")
            for d in report["damage"]:
                print(f"  - {d}")
        print("clean" if report["clean"] else "DAMAGED")
    return 0 if report["clean"] else 1


if __name__ == "__main__":
    sys.exit(main())
