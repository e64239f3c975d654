"""The master's durable control state — the port's own copy of
``dlrover_tpu/master/state.py`` (``JournalBound`` ``:96``,
``_atomic_write``, ``write_addr``/``read_addr``/``read_lease``
``:133-160``, ``JournalContents`` and ``read_state_dir`` ``:221``,
``JournalTail`` ``:275``, ``ControlStateJournal`` ``:365``, ``MasterState``
``:588``, ``recover_into`` ``:882``, ``JournalKeeper`` ``:893``,
``attach_state`` ``:930``).

A master started with a state dir journals every mutation of its managers
before it acks the RPC, so an acked write is durable, and a relaunched
master or a warm standby (``master/standby.py``) rebuilds the same state:

- :class:`ControlStateJournal` — a CRC-framed append log (``wal.log``,
  ``DLRTPUW1`` then frames ``u32 len | u32 crc32(payload) | payload``, the
  payload msgpack ``{"s": seq, "g": generation, "t": wall, "k": kind, "d":
  fields}``), with a snapshot (``snap.bin``) and WAL compaction every
  ``ha_snapshot_every`` records, and the leader lease file.  A torn tail
  (a crash mid-append) is truncated at the next writer open: exactly the
  unacked record is lost.
- :class:`MasterState` — the managers one journal protects: ``capture``
  (the snapshot), ``restore`` and ``apply`` (replay one record through the
  managers' own methods).
- :class:`JournalTail` — the standby's incremental reader.

The record kinds are the reference's (``kv.*``, ``task.*``, ``rdzv.*``,
``node.meta``/``node.status``, ``speed.step``, ``sync.*``, ``ha.*``), and
the files are the reference's byte for byte for the same manager calls
and clock: the port packs with its own ``common/msgpack_lite.py``, which
gives msgpack's smallest form.  The reshard and cell records (``reshard.*``,
``cell.placement``) are reported as divergences, as the port has neither
manager yet (``constants.HOST_LAYERS``); a reference snapshot's ``reshard``
and ``cell`` parts are skipped.  The reference's chaos site inside
``append`` (``master.journal_torn``) belongs to ``constants.CHAOS_LAYER``,
and its observability events to ``obs/``; the port counts its appends
instead (:attr:`ControlStateJournal.appends`, ``append_s``).

Replay is idempotent (token caches dedupe grants and adds, joins dedupe on
the attempt id, world and status records overwrite), so the snapshot is
labelled with the sequence number read before the capture starts, and
records after the label simply apply again.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from time import perf_counter
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.log import logger

WAL_MAGIC = b"DLRTPUW1"
SNAP_MAGIC = b"DLRTPUS1"
_FRAME_HDR = struct.Struct("<II")  # payload len, payload crc32
_SNAP_HDR = struct.Struct("<QI")  # payload len, payload crc32
#: A frame longer than this is a damaged length, not a torn tail.
_MAX_FRAME = 64 << 20

WAL_NAME = "wal.log"
SNAP_NAME = "snap.bin"
LEASE_NAME = "lease"
ADDR_NAME = "addr"


class JournalBound:
    """The manager side of the journal: ``self._jrec(kind, **fields)`` at
    each mutation, a no-op until :meth:`MasterState.bind` gives the
    manager a journal (replay runs unbound, so applying a record never
    appends it again)."""

    _journal: Optional["ControlStateJournal"] = None

    def bind_journal(self, journal) -> None:
        self._journal = journal

    def _jrec(self, kind: str, **fields) -> None:
        if self._journal is not None:
            self._journal.append(kind, fields)


def _crc32(buf: bytes) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


def _unpack(payload: bytes) -> Any:
    return msgpack_lite.unpackb(payload, strict_map_key=False)


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_addr(state_dir: str, addr: str) -> None:
    """Publish the leader's serving address; clients with the state dir
    read it again after a transport failure."""
    _atomic_write(os.path.join(state_dir, ADDR_NAME), addr.encode())


def read_addr(state_dir: str) -> str:
    try:
        with open(os.path.join(state_dir, ADDR_NAME), "rb") as f:
            return f.read().decode().strip()
    except OSError:
        return ""


def read_lease(state_dir: str) -> str:
    """The lease file's content.  Liveness is read on the reader's side:
    the content changing restarts the reader's own clock; it is never
    compared with the reader's wall time."""
    try:
        with open(os.path.join(state_dir, LEASE_NAME), "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


# -- the read side ------------------------------------------------------------

@dataclasses.dataclass
class JournalContents:
    """What one scan of a state dir found."""

    snapshot: Optional[dict] = None
    snap_seq: int = 0  # records up to this seq are inside the snapshot
    snap_gen: int = 0
    records: List[dict] = dataclasses.field(default_factory=list)
    wal_end: int = 0  # end of the last whole frame
    torn_tail_bytes: int = 0
    damage: List[str] = dataclasses.field(default_factory=list)

    @property
    def last_seq(self) -> int:
        return int(self.records[-1]["s"]) if self.records else self.snap_seq

    @property
    def last_gen(self) -> int:
        return max([int(r.get("g", 0)) for r in self.records]
                   + [self.snap_gen])


def _read_snapshot(path: str, out: JournalContents) -> None:
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return
    if len(blob) < len(SNAP_MAGIC) + _SNAP_HDR.size:
        out.damage.append("snapshot: short file")
        return
    if blob[:len(SNAP_MAGIC)] != SNAP_MAGIC:
        out.damage.append("snapshot: bad magic")
        return
    plen, crc = _SNAP_HDR.unpack_from(blob, len(SNAP_MAGIC))
    payload = blob[len(SNAP_MAGIC) + _SNAP_HDR.size:][:plen]
    if len(payload) < plen:
        out.damage.append("snapshot: payload truncated")
        return
    if _crc32(payload) != crc:
        out.damage.append("snapshot: payload CRC mismatch")
        return
    try:
        snap = _unpack(payload)
    except ValueError as e:
        out.damage.append(f"snapshot: undecodable ({type(e).__name__})")
        return
    out.snapshot = snap.get("state")
    out.snap_seq = int(snap.get("seq", 0))
    out.snap_gen = int(snap.get("gen", 0))


def read_state_dir(state_dir: str) -> JournalContents:
    """Scan the snapshot and the WAL.  An incomplete last frame is a torn
    tail (``torn_tail_bytes``); a whole frame that fails its CRC or does
    not decode is ``damage``, and the scan stops there."""
    out = JournalContents()
    _read_snapshot(os.path.join(state_dir, SNAP_NAME), out)
    try:
        with open(os.path.join(state_dir, WAL_NAME), "rb") as f:
            blob = f.read()
    except OSError:
        return out
    if len(blob) < len(WAL_MAGIC):
        if blob:
            out.damage.append("wal: short header")
        return out
    if blob[:len(WAL_MAGIC)] != WAL_MAGIC:
        out.damage.append("wal: bad magic")
        return out
    off = good_end = len(WAL_MAGIC)
    while off + _FRAME_HDR.size <= len(blob):
        plen, crc = _FRAME_HDR.unpack_from(blob, off)
        end = off + _FRAME_HDR.size + plen
        if plen > _MAX_FRAME:
            out.damage.append(f"wal: implausible frame length at {off}")
            break
        if end > len(blob):
            break  # an incomplete last frame: a crash mid-append
        payload = blob[off + _FRAME_HDR.size:end]
        if _crc32(payload) != crc:
            # All the frame's bytes are there: a crash leaves only an
            # incomplete suffix, so this is corruption.
            out.damage.append(f"wal: frame CRC mismatch at {off}")
            break
        try:
            rec = _unpack(payload)
        except ValueError as e:
            out.damage.append(
                f"wal: undecodable frame at {off} ({type(e).__name__})")
            break
        out.records.append(rec)
        off = good_end = end
    out.wal_end = good_end
    out.torn_tail_bytes = len(blob) - good_end
    return out


class JournalTail:
    """The standby's incremental WAL reader.  It reopens after the
    writer's compaction (a new inode or a shorter file; records are
    deduped by seq) and waits out an append in flight."""

    def __init__(self, state_dir: str, from_seq: int = 0):
        self._wal = os.path.join(state_dir, WAL_NAME)
        self._f = None
        self._ino = -1
        self._offset = 0
        self.last_seq = from_seq
        #: A record came with seq > last_seq + 1: the records between were
        #: compacted away before this tail read them (they are in the
        #: snapshot), so the reader must bootstrap again.
        self.gap = False

    def _reopen(self) -> bool:
        self.close()
        try:
            self._f = open(self._wal, "rb")
            self._ino = os.fstat(self._f.fileno()).st_ino
        except OSError:
            return False
        if self._f.read(len(WAL_MAGIC)) != WAL_MAGIC:
            self.close()
            return False
        self._offset = len(WAL_MAGIC)
        return True

    def poll(self) -> List[dict]:
        """The whole records written since the last poll."""
        try:
            st = os.stat(self._wal)
        except OSError:
            return []
        if (self._f is None or st.st_ino != self._ino
                or st.st_size < self._offset) and not self._reopen():
            return []
        out: List[dict] = []
        f = self._f
        while True:
            f.seek(self._offset)
            hdr = f.read(_FRAME_HDR.size)
            if len(hdr) < _FRAME_HDR.size:
                break
            plen, crc = _FRAME_HDR.unpack(hdr)
            if plen > _MAX_FRAME:
                break  # a damaged length: the takeover's scan decides
            payload = f.read(plen)
            if len(payload) < plen or _crc32(payload) != crc:
                break  # an append in flight (or a torn tail): wait
            try:
                rec = _unpack(payload)
            except ValueError:
                break
            self._offset += _FRAME_HDR.size + plen
            seq = int(rec.get("s", 0))
            if seq <= self.last_seq:
                continue  # overlap after a compaction
            if self.last_seq > 0 and seq > self.last_seq + 1:
                self.gap = True
            self.last_seq = seq
            out.append(rec)
        return out

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None


# -- the write side -----------------------------------------------------------

class ControlStateJournal:
    """The master's WAL, snapshot and lease writer.

    Opening it as the writer recovers the dir: the torn tail is truncated,
    the seq resumes after the last good record, and the writer claims the
    next ``generation`` with an ``ha.owner`` record.  ``recovered`` holds
    what the open found, for the caller to replay (then
    ``drop_recovered``).  ``appends``, ``append_bytes`` and ``append_s``
    (host seconds spent in :meth:`append`, fsync included) count this
    writer's records."""

    def __init__(self, state_dir: str, *, fsync: bool = True,
                 snapshot_every: int = 1000):
        os.makedirs(state_dir, exist_ok=True)
        self.state_dir = state_dir
        self._fsync = fsync
        self._snapshot_every = max(1, int(snapshot_every))
        self._mu = threading.Lock()
        self._closed = False
        self.appends = 0
        self.append_bytes = 0
        self.append_s = 0.0
        self._wal_path = os.path.join(state_dir, WAL_NAME)
        self.recovered = read_state_dir(state_dir)
        if self.recovered.damage:
            logger.warning("control journal %s opened with damage: %s",
                           state_dir, "; ".join(self.recovered.damage))
        self._seq = self.recovered.last_seq
        self.generation = self.recovered.last_gen + 1
        self._since_snapshot = len(self.recovered.records)
        self._lease_count = 0
        fresh = not os.path.exists(self._wal_path)
        if not fresh and self.recovered.wal_end < len(WAL_MAGIC):
            # No readable header survived: truncating to 8 bytes would
            # zero-fill it.  No record was readable; start again.
            logger.warning("control journal: wal has no readable header "
                           "(%d bytes); rewriting",
                           os.path.getsize(self._wal_path))
            os.unlink(self._wal_path)
            fresh = True
        self._f = open(self._wal_path, "ab" if fresh else "r+b")
        if fresh:
            self._f.write(WAL_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        else:
            if self.recovered.torn_tail_bytes:
                logger.warning("control journal: truncating %d torn tail "
                               "bytes (the record was never acked)",
                               self.recovered.torn_tail_bytes)
            self._f.truncate(self.recovered.wal_end)
            self._f.seek(self.recovered.wal_end)
        self.append("ha.owner", {"pid": os.getpid()})

    @property
    def seq(self) -> int:
        with self._mu:
            return self._seq

    def drop_recovered(self) -> None:
        self.recovered = JournalContents()

    def append(self, kind: str, fields: Dict[str, Any]) -> int:
        """Append one record durably, before the mutation is acked; its
        seq.  ``-1`` once closed: teardown races the managers' last
        mutations, which must not fail on a closed file."""
        t0 = perf_counter()
        with self._mu:
            if self._closed:
                return -1
            self._seq += 1
            payload = msgpack_lite.packb(
                {"s": self._seq, "g": self.generation, "t": time.time(),
                 "k": kind, "d": fields})
            frame = _FRAME_HDR.pack(len(payload), _crc32(payload)) + payload
            self._f.write(frame)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._since_snapshot += 1
            self.appends += 1
            self.append_bytes += len(frame)
            self.append_s += perf_counter() - t0
            return self._seq

    def stats(self) -> str:
        """One line of this writer's append counters."""
        mean_ms = 1e3 * self.append_s / max(1, self.appends)
        return (f"appends={self.appends} bytes={self.append_bytes} "
                f"mean_append_ms={mean_ms:.4f} fsync={self._fsync}")

    # -- snapshots ------------------------------------------------------------
    def snapshot_due(self) -> bool:
        with self._mu:
            return self._since_snapshot >= self._snapshot_every

    def maybe_snapshot(self, state_fn: Callable[[], dict]) -> bool:
        """Snapshot and compact when due.  Never called from ``append``:
        appenders hold manager locks that ``state_fn`` takes."""
        if not self.snapshot_due():
            return False
        self.snapshot(state_fn)
        return True

    def snapshot(self, state_fn: Callable[[], dict]) -> int:
        with self._mu:
            label = self._seq  # every record up to here is in the state
        state = state_fn()  # manager locks only, not the journal's
        payload = msgpack_lite.packb(
            {"seq": label, "gen": self.generation, "t": time.time(),
             "state": state})
        blob = (SNAP_MAGIC + _SNAP_HDR.pack(len(payload), _crc32(payload))
                + payload)
        _atomic_write(os.path.join(self.state_dir, SNAP_NAME), blob)
        with self._mu:
            self._compact_locked(label)
            self._since_snapshot = max(0, self._seq - label)
        logger.info("control journal: snapshot at seq=%d (%d bytes), wal "
                    "compacted", label, len(blob))
        return label

    def _compact_locked(self, keep_after_seq: int) -> None:
        """Rewrite the WAL with only the frames after ``keep_after_seq``
        (tmp file and rename: a tailing reader sees the inode change)."""
        self._f.flush()
        os.fsync(self._f.fileno())
        tmp = self._wal_path + ".compact"
        with open(self._wal_path, "rb") as src, open(tmp, "wb") as dst:
            dst.write(WAL_MAGIC)
            src.seek(len(WAL_MAGIC))
            while True:
                hdr = src.read(_FRAME_HDR.size)
                if len(hdr) < _FRAME_HDR.size:
                    break
                plen, crc = _FRAME_HDR.unpack(hdr)
                payload = src.read(plen)
                if len(payload) < plen or _crc32(payload) != crc:
                    break
                if int(_unpack(payload).get("s", 0)) > keep_after_seq:
                    dst.write(hdr + payload)
            dst.flush()
            os.fsync(dst.fileno())
        self._f.close()
        os.replace(tmp, self._wal_path)
        self._f = open(self._wal_path, "r+b")
        self._f.seek(0, os.SEEK_END)

    # -- the lease ------------------------------------------------------------
    def write_lease(self) -> None:
        """Bump the leader lease: its content changes at every write."""
        self._lease_count += 1
        _atomic_write(os.path.join(self.state_dir, LEASE_NAME),
                      f"{self.generation}:{self._lease_count}\n".encode())

    def close(self) -> None:
        with self._mu:
            self._closed = True
            try:
                self._f.flush()
                os.fsync(self._f.fileno())
            except (OSError, ValueError):
                pass
            try:
                self._f.close()
            except OSError:
                pass


# -- the state machine ----------------------------------------------------------

class MasterState:
    """The managers one journal protects.  ``apply`` replays a record
    through the managers' own methods, which are deterministic (FIFO task
    queues, seeded shuffles, tokened dedupe); a rendezvous world is a
    wall-clock decision and is journaled and applied as a state record."""

    def __init__(self, *, kv_store=None, task_manager=None,
                 rdzv_managers=None, reshard_manager=None, job_manager=None,
                 speed_monitor=None, sync_service=None, cell_manager=None):
        if reshard_manager is not None or cell_manager is not None:
            from dlrover_tpu_torch.common.constants import HOST_LAYERS

            raise NotImplementedError(
                f"the reshard and cell managers (reshard_manager=, "
                f"cell_manager=) come with {HOST_LAYERS}")
        self.kv_store = kv_store
        self.task_manager = task_manager
        self.rdzv_managers = rdzv_managers or {}
        self.job_manager = job_manager
        self.speed_monitor = speed_monitor
        self.sync_service = sync_service

    @classmethod
    def of_master(cls, master) -> "MasterState":
        return cls(kv_store=master.kv_store,
                   task_manager=master.task_manager,
                   rdzv_managers=master.rdzv_managers,
                   job_manager=master.job_manager,
                   speed_monitor=master.speed_monitor,
                   sync_service=master.sync_service)

    def _managers(self) -> list:
        out = [self.kv_store, self.task_manager, self.job_manager,
               self.speed_monitor, self.sync_service,
               *self.rdzv_managers.values()]
        return [mgr for mgr in out if mgr is not None]

    def bind(self, journal: Optional[ControlStateJournal]) -> None:
        """Give every manager the journal (``None`` unbinds)."""
        for mgr in self._managers():
            mgr.bind_journal(journal)

    # -- the snapshot ---------------------------------------------------------
    def capture(self) -> dict:
        """The reference's snapshot layout, without the managers the port
        does not have (``reshard``, ``cell``)."""
        state: Dict[str, Any] = {}
        if self.kv_store is not None:
            state["kv"] = self.kv_store.dump_state()
        if self.task_manager is not None:
            from dlrover_tpu_torch.master.task_manager import grants_as_data

            state["task"] = grants_as_data(self.task_manager.dump_state())
        if self.rdzv_managers:
            state["rdzv"] = {name: mgr.dump_state()
                             for name, mgr in self.rdzv_managers.items()}
        if self.job_manager is not None:
            state["nodes"] = self.job_manager.dump_state()
        if self.speed_monitor is not None:
            state["speed"] = self.speed_monitor.dump_state()
        if self.sync_service is not None:
            state["sync"] = self.sync_service.dump_state()
        return state

    def restore(self, state: dict) -> None:
        parts = (("kv", self.kv_store), ("task", self.task_manager),
                 ("nodes", self.job_manager), ("speed", self.speed_monitor),
                 ("sync", self.sync_service))
        for key, mgr in parts:
            if mgr is not None and key in state:
                mgr.load_state(state[key])
        for name, sub in (state.get("rdzv") or {}).items():
            mgr = self.rdzv_managers.get(name)
            if mgr is not None:
                mgr.load_state(sub)

    # -- replay ---------------------------------------------------------------
    def apply(self, rec: dict) -> Optional[str]:
        """Apply one record; a divergence (the replay did not give what
        the journal promised) as text, else ``None``."""
        kind = rec.get("k", "")
        try:
            return self._apply(kind, rec.get("d", {}) or {})
        except Exception as e:  # noqa: BLE001 - replay reports, never dies
            return f"{kind}: apply raised {type(e).__name__}: {e}"

    def _apply(self, kind: str, d: dict) -> Optional[str]:
        if kind in ("ha.owner", "ha.takeover", "ha.shutdown", "ha.lease"):
            return None
        family = kind.split(".", 1)[0]
        if family in ("reshard", "cell"):
            return f"{kind}: the port has no {family} manager to apply to"
        handler = {"kv": self._apply_kv, "task": self._apply_task,
                   "rdzv": self._apply_rdzv, "node": self._apply_node,
                   "speed": self._apply_speed,
                   "sync": self._apply_sync}.get(family)
        if handler is None:
            return f"unknown journal kind {kind}"
        return handler(kind, d)

    def _apply_kv(self, kind: str, d: dict) -> Optional[str]:
        kv = self.kv_store
        if kv is None:
            return f"{kind}: no kv store to apply to"
        if kind == "kv.set":
            kv.set(d["key"], d["value"])
        elif kind == "kv.multi_set":
            kv.multi_set(d["kvs"])
        elif kind == "kv.add":
            got = kv.add(d["key"], d["delta"], token=d.get("token", ""))
            want = d.get("result")
            if want is not None and got != want:
                return f"kv.add {d['key']}: replayed {got}, wanted {want}"
        elif kind == "kv.delete":
            kv.delete(d["key"], token=d.get("token", ""))
        elif kind == "kv.clear":
            kv.clear(d.get("prefix", ""))
        else:
            return f"unknown journal kind {kind}"
        return None

    def _apply_task(self, kind: str, d: dict) -> Optional[str]:
        tm = self.task_manager
        if tm is None:
            return f"{kind}: no task manager to apply to"
        if kind == "task.dataset":
            from dlrover_tpu_torch.master.dataset_splitter import (
                new_dataset_splitter,
            )

            params = dict(d["params"])
            if not tm.has_dataset(params["dataset_name"]):
                tm.new_dataset(new_dataset_splitter(**params), params=params)
        elif kind == "task.grant":
            got = tm.get_task(d["dataset"], d["worker"],
                              token=d.get("token", ""))
            want = d.get("task_id", -1)
            got_id = got[0] if got is not None else -1
            if got_id != want:
                return (f"task.grant {d['dataset']}: replayed task "
                        f"{got_id}, journal promised {want}")
        elif kind == "task.report":
            tm.report_task_result(d["dataset"], d["task_id"], d["success"])
        elif kind == "task.recover":
            tm.recover_worker_tasks(d["worker"])
        elif kind == "task.requeue":
            tm.requeue_tasks(d["dataset"], d["task_ids"])
        elif kind == "task.restore":
            tm.restore_dataset(d["dataset"], d["content"])
        else:
            return f"unknown journal kind {kind}"
        return None

    def _apply_rdzv(self, kind: str, d: dict) -> Optional[str]:
        mgr = self.rdzv_managers.get(d.get("name", ""))
        if mgr is None:
            return f"{kind}: no rendezvous manager {d.get('name')!r}"
        if kind == "rdzv.join":
            mgr.join(d["node_id"], d["node_rank"], d["local_world_size"],
                     host=d.get("host", ""),
                     coordinator_port=d.get("coordinator_port", 0),
                     slice_id=d.get("slice_id", ""),
                     host_id=d.get("host_id", ""),
                     attempt_id=d.get("attempt_id", ""))
        elif kind == "rdzv.remove":
            mgr.remove_alive_node(d["node_id"])
        elif kind == "rdzv.world":
            mgr.restore_world(d)
        elif kind == "rdzv.ckpt_vote":
            mgr.sync_ckpt_nodes(d["node_id"], d["step"])
        else:
            return f"unknown journal kind {kind}"
        return None

    def _apply_node(self, kind: str, d: dict) -> Optional[str]:
        from dlrover_tpu_torch.common import messages as m

        if kind not in ("node.meta", "node.status"):
            return f"unknown journal kind {kind}"
        if self.job_manager is None:
            return None
        if kind == "node.meta":
            self.job_manager.register_node_meta(m.NodeMeta(**d))
        else:
            self.job_manager.update_node_status(
                d["node_id"], d.get("node_type", ""), d["status"],
                d.get("exit_reason", ""))
        return None

    def _apply_speed(self, kind: str, d: dict) -> Optional[str]:
        if kind != "speed.step":
            return f"unknown journal kind {kind}"
        if self.speed_monitor is not None:
            self.speed_monitor.collect_global_step(d["step"],
                                                   d.get("ts", 0.0))
        return None

    def _apply_sync(self, kind: str, d: dict) -> Optional[str]:
        ss = self.sync_service
        if ss is None:
            return f"{kind}: no sync service to apply to"
        if kind == "sync.world":
            ss.set_world(d.get("nodes", []))
        elif kind == "sync.join":
            ss.join_sync(d["name"], d["node_id"])
        elif kind == "sync.finished":
            ss.finish_sync(d["name"])
        elif kind == "sync.remove":
            ss.remove_sync(d["name"])
        else:
            return f"unknown journal kind {kind}"
        return None

    def replay(self, records: List[dict]) -> List[str]:
        """Apply records in order; the divergences."""
        out = []
        for rec in records:
            div = self.apply(rec)
            if div is not None:
                out.append(f"seq {rec.get('s', '?')}: {div}")
        return out

    def rearm(self) -> None:
        """Restart every replayed deadline on this process's clock (task
        timeouts, heartbeats, rendezvous windows): a deadline from the
        dead primary's clock would fire at once or never."""
        if self.task_manager is not None:
            self.task_manager.rearm_doing()
        if self.job_manager is not None:
            self.job_manager.rearm_heartbeats()
        for mgr in self.rdzv_managers.values():
            mgr.rearm_clocks()


def recover_into(state: MasterState, contents: JournalContents
                 ) -> Tuple[int, List[str]]:
    """Restore the snapshot and replay the records of ``contents``; the
    records applied and the divergences.  Bind the journal after this, so
    that replay appends nothing."""
    if contents.snapshot is not None:
        state.restore(contents.snapshot)
    return len(contents.records), state.replay(contents.records)


class JournalKeeper:
    """The leader's housekeeping thread: every ``lease_interval_s`` it
    bumps the lease, takes a due snapshot, and logs the journal's append
    counters if they changed (so that a master killed without a word has
    left them in its log)."""

    def __init__(self, journal: ControlStateJournal, state: MasterState,
                 lease_interval_s: float = 1.0):
        self._journal = journal
        self._state = state
        self._interval = lease_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="ha-keeper", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)

    def _loop(self) -> None:
        logged = 0
        while not self._stop.wait(self._interval):
            try:
                self._journal.write_lease()
            except OSError as e:
                logger.warning("ha keeper: lease write failed: %s", e)
            try:
                self._journal.maybe_snapshot(self._state.capture)
            except Exception:  # noqa: BLE001 - the keeper keeps leasing
                logger.warning("ha keeper: snapshot failed", exc_info=True)
            if self._journal.appends != logged:
                logged = self._journal.appends
                logger.info("control journal: %s", self._journal.stats())


def attach_state(master, state_dir: str, *, recover: bool = True,
                 fsync: bool = True) -> ControlStateJournal:
    """Give ``master`` its durable state: replay what an earlier
    incarnation journaled, open the journal as the next writer generation
    and bind it to every manager.  ``prepare`` then publishes the address
    and starts the keeper."""
    from dlrover_tpu_torch.common.global_context import get_context

    ctx = get_context()
    state = MasterState.of_master(master)
    journal = ControlStateJournal(state_dir, fsync=fsync,
                                  snapshot_every=ctx.ha_snapshot_every)
    if recover and (journal.recovered.snapshot is not None
                    or journal.recovered.records):
        applied, divergences = recover_into(state, journal.recovered)
        for div in divergences:
            logger.warning("control journal recovery divergence: %s", div)
        state.rearm()
        logger.info("control journal: recovered %d records (snapshot "
                    "seq=%d, generation now %d)", applied,
                    journal.recovered.snap_seq, journal.generation)
    journal.drop_recovered()
    state.bind(journal)
    master._ha_state = state
    master._ha_journal = journal
    master._ha_keeper = JournalKeeper(
        journal, state, lease_interval_s=ctx.ha_lease_interval_s)
    return journal
