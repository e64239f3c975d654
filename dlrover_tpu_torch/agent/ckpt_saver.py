"""Agent-side async checkpoint saver — the port's own copy of
``dlrover_tpu/agent/ckpt_saver.py`` ``AsyncCheckpointSaver`` (``start``,
``stop``, ``_event_loop``, ``_handle_save``, ``_persist``, ``_commit``,
``update_world``, ``save_shm_to_storage``, ``agg_persist_mbps``,
``last_stall_ms``, ``staged_mbps``).

It runs in the per-node *agent* process, so a persist survives a worker's
crash.  It hosts the worker-facing primitives (``common/multi_process.py``):
the save-event ``SharedQueue``, one fencing ``SharedLock`` per local rank
and the stat ``SharedDict`` (``checkpoint/engine.py``
``ckpt_{queue,lock,stat}_name``); a worker's ``CheckpointEngine`` finds
the queue's socket and runs in agent mode.  For each save event it streams
that rank's arena to storage under the rank's lock (its slice of the
replicated state, a ref where the dirty fence holds), votes with the done
file, and for process 0 commits once every vote is in and the coverage
proof holds.

Breakpoint save (:meth:`save_shm_to_storage`): before the agent stops its
workers (a failure, or a change of membership) it persists every staged
step not yet persisted, as *full* shards: a dying partial world must leave
shards that restore alone, not orphan slices.

With a master client (the agent's), each persist is reported to the
master as a throughput-only ``CkptPerf`` and process 0's commit first
waits, bounded, on the master's step barrier
(``shard_file.wait_sync_barrier``), as the reference's do.

Not ported: the cross-node in-memory replicas (``checkpoint/replica.py``:
the replica loop and :meth:`seed_from_replicas`) raise, naming Queue A
item 5; the reference's ``journal``, ``perf_stats``,
``integrity_counters`` and ``chaos`` hooks have no counterpart.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Dict, Optional

from dlrover_tpu_torch.checkpoint import shard_file, slicer
from dlrover_tpu_torch.checkpoint.engine import (
    ckpt_lock_name,
    ckpt_queue_name,
    ckpt_stat_name,
)
from dlrover_tpu_torch.common.constants import REPLICA_ITEM
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
)
from dlrover_tpu_torch.common.shm import SharedMemoryArena, arena_name
from dlrover_tpu_torch.common.storage import PosixDiskStorage

#: Threads for the commits (a commit waits for the other ranks' votes).
IO_WORKERS = 4
#: Seconds a breakpoint save waits for the commit it started: the votes of
#: ranks on other nodes may never come (a dead node); the commit itself
#: runs on to its own deadline.
BREAKPOINT_COMMIT_WAIT_S = 5.0
#: Seconds to wait for a rank's fencing lock; a live holder that keeps it
#: longer (a hung worker) has its rank skipped ("lock busy").
LOCK_TIMEOUT_S = 60.0


class AsyncCheckpointSaver:
    def __init__(self, job_name: str, nproc_per_node: int, *,
                 master_client=None, storage=None):
        self.job_name = job_name
        self.nproc = nproc_per_node
        self.client = master_client
        self.storage = storage or PosixDiskStorage()
        # Server side of the worker-facing primitives.
        self._queue = SharedQueue(ckpt_queue_name(job_name), create=True)
        self._locks = [SharedLock(ckpt_lock_name(job_name, lr), create=True)
                       for lr in range(nproc_per_node)]
        self._stat = SharedDict(ckpt_stat_name(job_name), create=True)
        # One arena object and one in-process mutex per rank: the event
        # thread and a breakpoint save share the arena, and reopen()
        # unmaps it.  The mutex is taken inside the fencing lock, never
        # around it.
        self._arenas: Dict[int, SharedMemoryArena] = {
            lr: SharedMemoryArena(arena_name(job_name, lr))
            for lr in range(nproc_per_node)}
        self._arena_mus: Dict[int, threading.Lock] = {
            lr: threading.Lock() for lr in range(nproc_per_node)}
        self._persisted: Dict[int, int] = {}  # local_rank -> step
        # Dirty-fence memory per local rank, keyed by the (ckpt_dir,
        # process_id, world) it was built for: a rank that changes its
        # identity starts a fresh tracker (the next save is full).
        self._dirty: Dict[int, slicer.DirtyTracker] = {}
        self._dirty_scope: Dict[int, tuple] = {}
        self._perf_cache: tuple = (0.0, {})  # (fetched_at, stat snapshot)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool = ThreadPoolExecutor(max_workers=IO_WORKERS,
                                        thread_name_prefix="ckpt-io")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._event_loop, name="async-ckpt-saver",
                daemon=True)
            self._thread.start()
            logger.info("async checkpoint saver up (job=%s nproc=%d)",
                        self.job_name, self.nproc)

    def update_world(self, node_rank: int, world_size: int) -> None:
        """After a rendezvous round the reference refreshes its replica
        ring here; the port has no replicas, so there is nothing to do."""

    def _replica_loop(self) -> None:
        raise NotImplementedError(
            f"cross-node checkpoint replicas come with {REPLICA_ITEM}")

    def seed_from_replicas(self, process_ids: Dict[int, int],
                           num_processes: int) -> int:
        raise NotImplementedError(
            f"seeding arenas from cross-node replicas comes with "
            f"{REPLICA_ITEM}")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._pool.shutdown(wait=True)
        self._queue.close()
        for lock in self._locks:
            lock.close()
        self._stat.close()
        for arena in self._arenas.values():
            arena.close()

    # -- event loop ---------------------------------------------------------
    def _event_loop(self) -> None:
        while not self._stop.is_set():
            try:
                event = self._queue.get(timeout=0.5)
            except TimeoutError:
                continue
            except Exception:  # noqa: BLE001
                if not self._stop.is_set():
                    logger.exception("ckpt saver queue error")
                    time.sleep(1.0)
                continue
            if not isinstance(event, dict) or event.get("event") != "save":
                continue
            try:
                self._handle_save(event)
            except Exception:  # noqa: BLE001
                logger.exception("ckpt save event failed: %s", event)

    def _handle_save(self, event: dict):
        """Stream one rank's arena straight to storage, holding its fencing
        lock and arena mutex for the whole persist (the views are the
        mapping's bytes): a worker staging its next step waits.  Returns
        the future of process 0's commit, else ``None``."""
        lr = int(event.get("local_rank", 0))
        step = int(event.get("step", 0))
        pid = int(event.get("process_id", lr))
        world = int(event.get("num_processes", self.nproc))
        ckpt_dir = event["ckpt_dir"]
        keep_last = shard_file.resolve_keep_last(event.get("max_to_keep"))
        lock = self._locks[lr] if lr < len(self._locks) else None
        if lock is not None and not lock.acquire(timeout=LOCK_TIMEOUT_S):
            logger.warning("saver: lock for rank %d busy; skipping", lr)
            return
        try:
            arena = self._arenas[lr]
            with self._arena_mus[lr]:
                arena.reopen()
                read = arena.read_state(copy=False)
                if read is None:
                    logger.warning("saver: arena for rank %d empty", lr)
                    return
                tensors, extra = read
                staged = int(extra.get("step", -1))
                if staged != step:
                    logger.info("saver: arena holds step %d (event wanted "
                                "%d) — persisting the staged one", staged,
                                step)
                    step = staged
                reason = shard_file.validate_staged_state(
                    tensors, extra, expect_process_id=pid,
                    expect_num_processes=world)
                if reason is not None:
                    logger.error("saver: rank %d staged state rejected, NOT "
                                 "persisted (%s)", lr, reason)
                    return
                stats = self._persist(ckpt_dir, step, pid, tensors, extra,
                                      lr=lr,
                                      sliced=not event.get("breakpoint"),
                                      world=world)
                del tensors
        finally:
            if lock is not None:
                lock.release()
        self._report_persist_perf(step, stats["mbps"])
        self._persisted[lr] = step
        self._stat.update({
            f"persisted_{lr}": step,
            f"persist_mbps_{lr}": round(stats["mbps"], 1),
            f"tensors_skipped_{lr}": stats.get("skipped", 0),
        })
        logger.info("saver: persisted rank %d step %d in %.2fs (%.0f MB/s, "
                    "%d bytes, %d tensors ref'd unchanged)", lr, step,
                    stats["seconds"], stats["mbps"], stats["total_bytes"],
                    stats.get("skipped", 0))
        if pid == 0:
            # The commit waits for the other ranks' shards: never block
            # the event loop on it (it may persist them itself).
            return self._pool.submit(self._commit, ckpt_dir, step, world,
                                     keep_last)
        return None

    def _tracker(self, lr: int, ckpt_dir: str, pid: int,
                 world: int) -> slicer.DirtyTracker:
        scope = (ckpt_dir, pid, world)
        if self._dirty_scope.get(lr) != scope:
            self._dirty[lr] = slicer.DirtyTracker()
            self._dirty_scope[lr] = scope
        return self._dirty[lr]

    def _persist(self, ckpt_dir: str, step: int, pid: int, tensors, extra,
                 *, lr: int = 0, sliced: bool = True,
                 world: Optional[int] = None) -> dict:
        """One streamed shard write and its rate: this rank's slice of the
        replicated tensors (whole with ``sliced=False``), a ref where the
        dirty fence holds."""
        t0 = time.perf_counter()
        world = int(world or extra.get("num_processes") or self.nproc)
        tracker = self._tracker(lr, ckpt_dir, pid, world)
        plan = slicer.plan_persist(
            tensors, extra, process_id=pid, num_processes=world,
            sliced=sliced, tracker=tracker,
            # A holder at this very step is the file being rewritten: a
            # ref to it would point at itself.
            holder_exists=lambda s: s != step and self.storage.exists(
                shard_file.shard_path(ckpt_dir, s, pid)))
        stats = shard_file.write_shard_from_views(
            self.storage, ckpt_dir, step, pid, plan.tensors, plan.extra,
            meta_extra=plan.meta_extra)
        tracker.note_plan(plan, step, stats.get("crcs", {}))
        stats["seconds"] = max(1e-9, time.perf_counter() - t0)
        stats["mbps"] = stats["total_bytes"] / stats["seconds"] / (1 << 20)
        stats["skipped"] = plan.skipped
        stats["written_bytes"] = plan.written_bytes
        return stats

    def _report_persist_perf(self, step: int, mbps: float) -> None:
        """A throughput-only ``CkptPerf`` (``stall_ms=0``) with the node's
        aggregate persist rate, after the lock is released; best effort."""
        if self.client is None:
            return
        try:
            self.client.report_ckpt_perf(
                step=step, stall_ms=0.0, persist_mbps=mbps,
                agg_persist_mbps=self.agg_persist_mbps(),
                tensors_skipped=self.tensors_skipped_total())
        except Exception as e:  # noqa: BLE001
            logger.debug("persist perf report failed: %s", e)

    def _commit(self, ckpt_dir: str, step: int, world: int,
                keep_last: int = 3, timeout: float = 600.0) -> bool:
        deadline = time.time() + timeout
        if not shard_file.wait_sync_barrier(
                self.client, step, min(60.0, timeout / 4), self._stop) \
                and not self._stop.is_set():
            logger.warning("saver: step-%d sync barrier did not open; "
                           "committing on done files alone", step)
        while time.time() < deadline:
            if shard_file.all_shards_done(self.storage, ckpt_dir, step,
                                          world):
                # Votes in hand, writes finished: an unprovable cover is
                # final for this step (the previous one stays committed).
                if not slicer.commit_gate(self.storage, ckpt_dir, step):
                    return False
                shard_file.commit(self.storage, ckpt_dir, step,
                                  keep_last=keep_last)
                return True
            if self._stop.is_set():
                logger.info("saver: commit of step %d aborted (stop)", step)
                return False
            time.sleep(0.2)
        logger.warning("saver: commit of step %d timed out", step)
        return False

    # -- the workers' stats -------------------------------------------------
    def worker_perf(self) -> Dict[str, float]:
        """One snapshot of the workers' stats: one short round trip,
        cached for a second."""
        ts, snap = self._perf_cache
        if time.monotonic() - ts < 1.0:
            return snap
        try:
            snap = self._stat.to_dict(timeout=2.0) or {}
        except Exception as e:  # noqa: BLE001
            logger.debug("perf stat snapshot failed: %s", e)
            snap = {}
        self._perf_cache = (time.monotonic(), snap)
        return snap

    def tensors_skipped_total(self) -> int:
        """Sum of every local rank's last dirty-fence skip count."""
        return int(sum(int(v) for k, v in self.worker_perf().items()
                       if k.startswith("tensors_skipped_") and v is not None))

    def agg_persist_mbps(self) -> float:
        """Sum of every local rank's last persist rate: the node's
        aggregate bandwidth, which the sliced persist exists to raise."""
        return sum(float(v) for k, v in self.worker_perf().items()
                   if k.startswith("persist_mbps_") and v is not None)

    def last_stall_ms(self) -> float:
        """The worst save stall across local ranks, as the engines report
        it."""
        return max((float(v) for k, v in self.worker_perf().items()
                    if k.startswith("stall_ms_") and v is not None),
                   default=0.0)

    def staged_mbps(self) -> float:
        """The slowest rank's staging rate."""
        return min((float(v) for k, v in self.worker_perf().items()
                    if k.startswith("staged_mbps_") and v is not None),
                   default=0.0)

    # -- breakpoint save ----------------------------------------------------
    def save_shm_to_storage(self, reason: str = "") -> None:
        """Persist every staged-but-unpersisted arena now (the agent calls
        it right before it stops its workers); returns once the commit it
        started has ended, or after ``BREAKPOINT_COMMIT_WAIT_S`` (a rank of
        another node may never vote: its shard is not needed to restore,
        the full breakpoint shards are)."""
        commits = []
        for lr in range(self.nproc):
            try:
                arena = self._arenas[lr]
                # The fencing lock first, so that a write in flight ends: a
                # peek mid-write reads the dirty flag and would skip it.
                lock = self._locks[lr] if lr < len(self._locks) else None
                if lock is not None and \
                        not lock.acquire(timeout=LOCK_TIMEOUT_S):
                    logger.warning("breakpoint save: rank %d lock busy; "
                                   "skipping", lr)
                    continue
                try:
                    with self._arena_mus[lr]:
                        arena.reopen()
                        meta = arena.metadata()
                finally:
                    if lock is not None:
                        lock.release()
            except (FileNotFoundError, OSError) as e:
                logger.warning("breakpoint save: arena peek failed for rank "
                               "%d (state NOT persisted): %s", lr, e)
                continue
            if meta is None:
                continue
            extra = meta.get("extra", {})
            step = int(extra.get("step", -1))
            ckpt_dir = extra.get("ckpt_dir", "")
            if step < 0 or not ckpt_dir:
                continue
            if self._persisted.get(lr, -1) >= step:
                continue
            logger.info("breakpoint save (%s): persisting rank %d step %d",
                        reason, lr, step)
            commits.append(self._handle_save({
                "event": "save", "step": step, "local_rank": lr,
                "process_id": extra.get("process_id", lr),
                "num_processes": extra.get("num_processes", self.nproc),
                "ckpt_dir": ckpt_dir,
                # The last write of a dying world: full shards, which
                # restore alone, not slices.
                "breakpoint": True,
            }))
        pending = [f for f in commits if f is not None]
        if pending:
            _, late = futures_wait(pending, timeout=BREAKPOINT_COMMIT_WAIT_S)
            if late:
                logger.warning("breakpoint save: commit still waiting for "
                               "other ranks' votes after %.0fs; going on",
                               BREAKPOINT_COMMIT_WAIT_S)
