"""The warm standby master — the port's own copy of
``dlrover_tpu/master/standby.py`` (``RpcJournalSource`` ``:60``,
``StandbyMaster`` ``:172`` with ``watch``, ``take_over``, ``rebootstrap``
and ``run``).

A :class:`StandbyMaster` builds the primary's set of managers with its RPC
port bound but not served, bootstraps them from the state dir's snapshot
and WAL, and tails the journal, applying each record as it lands.  The
primary is alive while the journal or its lease file keeps changing, as
seen on the standby's own clock (``time.monotonic``; the two processes'
clocks are never compared).  After ``ha_lease_s`` of silence, and only if
the primary's address no longer takes a TCP connection (a stalled file
system must not split the brain), the standby:

1. opens the journal as the next writer generation (the torn tail is
   truncated: exactly the unacked record is lost);
2. applies the records its tail had not seen yet;
3. re-arms every clocked state (task timeouts, heartbeats, rendezvous
   windows) on its own clock;
4. binds the journal, serves, and publishes its address in the state dir,
   where clients that know the dir find it at their next transport
   failure.

The idempotency tokens that replay puts back into the dedupe caches make
an RPC retried across the gap apply once.  The journal's transport is the
shared dir; where the dirs are not shared, :class:`RpcJournalSource`
mirrors the primary's snapshot and WAL bytes over ``JournalFetch`` into a
local dir, which the standby tails as it would the shared one.  The
reference's re-announce of a cell master and its observability events
come with ``constants.HOST_LAYERS``.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import addr_connectable
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.master.state import (
    SNAP_NAME,
    WAL_NAME,
    ControlStateJournal,
    JournalKeeper,
    JournalTail,
    MasterState,
    _atomic_write,
    read_addr,
    read_lease,
    read_state_dir,
    recover_into,
)


class RpcJournalSource:
    """Mirror the primary's snapshot and WAL into ``dest_dir`` byte for
    byte over ``JournalFetch`` (``transport.call(msg) -> reply``, an
    ``RpcClient``).  When the primary compacts its WAL (another inode, or
    a size below the mirrored offset) the mirror fetches the snapshot
    again and replaces its WAL with the compacted bytes; the tail sees the
    new inode and dedupes by seq."""

    def __init__(self, transport, dest_dir: str):
        from dlrover_tpu_torch.common import messages as m

        self._m = m
        self._transport = transport
        self.dest_dir = dest_dir
        os.makedirs(dest_dir, exist_ok=True)
        self._wal_path = os.path.join(dest_dir, WAL_NAME)
        self._offset = (os.path.getsize(self._wal_path)
                        if os.path.exists(self._wal_path) else 0)
        self._remote_ino = 0
        self.fetch_snapshot()

    def _fetch(self, offset: int):
        """One chunk, or ``None`` when the primary does not answer or
        keeps no journal."""
        try:
            chunk = self._transport.call(self._m.JournalFetch(offset=offset))
        except Exception as e:  # noqa: BLE001 - the primary may be dying
            logger.debug("journal source: fetch at %d failed: %s", offset, e)
            return None
        return chunk if getattr(chunk, "found", False) else None

    def fetch_snapshot(self) -> bool:
        chunk = self._fetch(-1)
        if chunk is None or not chunk.data:
            return False
        _atomic_write(os.path.join(self.dest_dir, SNAP_NAME), chunk.data)
        return True

    def sync(self) -> int:
        """Pull the new WAL bytes; how many were added."""
        total = 0
        while True:
            chunk = self._fetch(self._offset)
            if chunk is None:
                return total
            swapped = (self._remote_ino and chunk.wal_ino
                       and chunk.wal_ino != self._remote_ino)
            if swapped or 0 <= chunk.wal_size < self._offset:
                # Compacted under us (the inode tells it even when the new
                # file is longer than our offset): rebuild from it.
                self.fetch_snapshot()
                rebuilt = self._rebuild_wal()
                if rebuilt == 0:
                    return total
                total += rebuilt
                continue
            if chunk.wal_ino:
                self._remote_ino = chunk.wal_ino
            if not chunk.data:
                return total
            with open(self._wal_path, "ab") as f:
                f.write(chunk.data)
            self._offset += len(chunk.data)
            total += len(chunk.data)
            if chunk.eof:
                return total

    def _rebuild_wal(self) -> int:
        """Replace the local WAL with the remote's whole file (a rename:
        a tailing reader reopens and skips the records it applied)."""
        blob, offset = b"", 0
        while True:
            chunk = self._fetch(offset)
            if chunk is None:
                return 0
            blob += chunk.data
            offset += len(chunk.data)
            self._remote_ino = chunk.wal_ino
            if chunk.eof or not chunk.data:
                break
        _atomic_write(self._wal_path, blob)
        self._offset = len(blob)
        logger.info("journal source: mirror rebuilt after the primary's "
                    "compaction (%d bytes)", len(blob))
        return len(blob)


class StandbyMaster:
    """A warm standby for a local master."""

    def __init__(self, state_dir: str, *, port: int = 0,
                 primary_addr: str = "", job_name: str = "local-job",
                 min_nodes: int = 1, max_nodes: int = 1, node_unit: int = 1,
                 network_check: bool = False,
                 lease_s: Optional[float] = None,
                 tail_poll_s: Optional[float] = None,
                 rpc_source: Optional[RpcJournalSource] = None,
                 run_config: Optional[dict] = None,
                 cell_id: str = "", cell_registry_addr: str = ""):
        if cell_id or cell_registry_addr:
            from dlrover_tpu_torch.common.constants import HOST_LAYERS

            raise NotImplementedError(
                f"a standby of a cell master (cell_id=, "
                f"cell_registry_addr=) comes with {HOST_LAYERS}")
        ctx = get_context()
        self.state_dir = state_dir
        self.lease_s = ctx.ha_lease_s if lease_s is None else lease_s
        self.tail_poll_s = (ctx.ha_tail_poll_s if tail_poll_s is None
                            else tail_poll_s)
        self.primary_addr = primary_addr or read_addr(state_dir)
        self._rpc_source = rpc_source
        # The primary's composition, port bound but not served, and no
        # state dir: the standby must not write the primary's journal.
        self.master = LocalJobMaster(
            port, job_name=job_name, min_nodes=min_nodes,
            max_nodes=max_nodes, node_unit=node_unit,
            network_check=network_check, run_config=run_config)
        self.state = MasterState.of_master(self.master)
        contents = read_state_dir(state_dir)
        for div in recover_into(self.state, contents)[1]:
            logger.warning("standby bootstrap divergence: %s", div)
        self.records_applied = len(contents.records)
        # A standby started after the leader's clean shutdown has no job to
        # back (the reference's would take the finished job over).
        self._ended = bool(contents.records) and \
            contents.records[-1].get("k") == "ha.shutdown"
        self._tail = JournalTail(state_dir, from_seq=contents.last_seq)
        self._last_lease = read_lease(state_dir)
        self._last_change = time.monotonic()
        self._stop = threading.Event()
        self._took_over = threading.Event()
        self.takeover_s = 0.0  # from the silence verdict to serving
        logger.info("standby master bound on %s tailing %s (%d records "
                    "warm, lease %.1fs)", self.addr, state_dir,
                    self.records_applied, self.lease_s)

    @property
    def addr(self) -> str:
        return self.master.addr

    @property
    def port(self) -> int:
        return self.master.port

    def took_over(self) -> bool:
        return self._took_over.is_set()

    def wait_takeover(self, timeout: float) -> bool:
        return self._took_over.wait(timeout)

    def rebootstrap(self) -> None:
        """Rebuild the warm state from the snapshot and the WAL (the tail
        found a gap that a compaction left)."""
        contents = read_state_dir(self.state_dir)
        for div in recover_into(self.state, contents)[1]:
            logger.warning("standby rebootstrap divergence: %s", div)
        self.records_applied = len(contents.records)
        self._tail.last_seq = max(self._tail.last_seq, contents.last_seq)
        self._tail.gap = False
        self._last_change = time.monotonic()
        logger.info("standby: bootstrapped again from snapshot seq=%d and "
                    "%d records (a compaction outran the tail)",
                    contents.snap_seq, len(contents.records))

    def stop(self) -> None:
        """End the watch; a standby that took over stops its master, one
        that did not closes its bound port."""
        self._stop.set()
        if self._took_over.is_set():
            self.master.request_stop(True, "standby stopped")
            self.master.stop()
        else:
            self.master._server.stop()

    # -- the watch --------------------------------------------------------------
    def poll(self) -> Optional[bool]:
        """One pass of the watch: ``True`` once it took over, ``False``
        when the primary shut down cleanly (stand down), else ``None``."""
        if self._ended:
            logger.info("standby: the job already ended (ha.shutdown); "
                        "standing down")
            return False
        if self._rpc_source is not None:
            self._rpc_source.sync()
        recs = self._tail.poll()
        if self._tail.gap:
            self.rebootstrap()
            return None
        if recs:
            if any(r.get("k") == "ha.shutdown" for r in recs):
                # The job ended on purpose; taking its state over would
                # bring a finished job back.
                logger.info("standby: primary shut down cleanly; standing "
                            "down without takeover")
                return False
            for div in self.state.replay(recs):
                logger.warning("standby tail divergence: %s", div)
            self.records_applied += len(recs)
            self._last_change = time.monotonic()
            return None
        lease = read_lease(self.state_dir)
        if lease != self._last_lease:
            self._last_lease = lease
            self._last_change = time.monotonic()
            return None
        if time.monotonic() - self._last_change < self.lease_s:
            return None
        if self.primary_addr and addr_connectable(self.primary_addr,
                                                  timeout=0.5):
            # The journal is silent but the primary still answers: hold.
            self._last_change = time.monotonic()
            logger.warning("standby: journal silent %.1fs but primary %s "
                           "still connectable; holding", self.lease_s,
                           self.primary_addr)
            return None
        self.take_over("primary silent")
        return True

    def watch(self) -> bool:
        """Poll every ``tail_poll_s`` until a takeover (``True``), a clean
        shutdown of the primary or :meth:`stop` (``False``)."""
        while not self._stop.wait(self.tail_poll_s):
            verdict = self.poll()
            if verdict is not None:
                return verdict
        return False

    def take_over(self, reason: str = "") -> None:
        """Adopt the journaled state and serve."""
        t0 = time.monotonic()
        ctx = get_context()
        journal = ControlStateJournal(self.state_dir,
                                      snapshot_every=ctx.ha_snapshot_every)
        found = journal.recovered
        missed = [r for r in found.records
                  if int(r.get("s", 0)) > self._tail.last_seq]
        if self._tail.gap or (missed and int(missed[0].get("s", 0))
                              > self._tail.last_seq + 1):
            # A compaction since the last poll left a hole: adopt the
            # whole snapshot and every record.
            if found.snapshot is not None:
                self.state.restore(found.snapshot)
            missed = found.records
        for div in self.state.replay(missed):
            logger.warning("standby takeover divergence: %s", div)
        self.records_applied += len(missed)
        journal.drop_recovered()
        self._tail.close()
        self.state.rearm()
        self.state.bind(journal)
        master = self.master
        master.state_dir = self.state_dir
        master._ha_journal = journal
        master._ha_state = self.state
        master._ha_keeper = JournalKeeper(
            journal, self.state, lease_interval_s=ctx.ha_lease_interval_s)
        journal.append("ha.takeover", {"reason": reason,
                                       "addr": master.addr,
                                       "records": self.records_applied})
        master.prepare()  # serves, publishes the address, starts the keeper
        self.takeover_s = time.monotonic() - t0
        self._took_over.set()
        logger.warning("standby TOOK OVER as generation %d on %s (%s): %d "
                       "records replayed, takeover %.1f ms",
                       journal.generation, master.addr,
                       reason or "requested", self.records_applied,
                       self.takeover_s * 1e3)

    def run(self) -> int:
        """Watch; after a takeover, run the master to the job's end."""
        if not self.watch():
            return 0
        return self.master.run()
