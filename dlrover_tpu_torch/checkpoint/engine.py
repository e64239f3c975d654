"""Worker-side checkpoint engine: training state -> shm arena -> (async)
storage, and back — the port's own counterpart of
``dlrover_tpu/checkpoint/engine.py`` ``CheckpointEngine`` for any number
of data-parallel processes: ``_stage``, ``save_to_memory``,
``save_to_storage``, ``_persist`` / ``_stream_shard`` (each rank writes its
slice of the replicated state), the leader's ``_commit_when_ready`` (every
done vote, then the coverage proof ``slicer.commit_gate``, then
``commit``), ``wait``, and ``load`` through the shm-then-storage ladder
with the cross-rank agreement (``_all_ranks_ok``, ``_agree_shm_step``,
``_agree_storage_step`` over ``common/dist_env.host_group``) and the
restore across slices (``_manifest``, ``_needed_keys``, ``_select_pids``,
``_read_step`` over every rank's file, ``_read_many``).  A restore at
another world size reads storage (the arena's layout is the old world's)
and assembles each leaf from the slices of every rank.

Sharded states (``parallel/accelerate.py`` over an FSDP or TP mesh) are
saved as the reference saves them: each rank writes its own box of each
sharded leaf, with the leaf's global shape, the box and the ranks that
hold it in the shard's ``tensors_info``.  A restore reads the boxes the
target needs (``_target_boxes``, reference ``engine.py:751``: each target
leaf's box on its mesh) and assembles each from whatever boxes the
checkpoint holds (``_finish_load``, ``:646``: the exact box, else the
overlap copy), so a checkpoint saved on one mesh restores onto another.
``load(target_mesh=)`` (``_retarget``, ``:725``) first moves each target
leaf's spec onto that mesh.

Two modes, found at construction, as in the reference:

- **agent mode**, when the agent-side saver's queue socket exists
  (``agent/ckpt_saver.py``): ``save_to_storage`` stages into the arena
  under the rank's ``SharedLock`` and puts a save event on the
  ``SharedQueue``; the saver persists and commits, so a crashing worker
  loses nothing.  The stall and staging rate go to the ``SharedDict``.
- **standalone mode**: a one-thread pool in the worker persists.

``_stage`` is the train stall.  It copies every card tensor to page-locked
host memory (``non_blocking``, then one synchronise per card) and then into
the arena, all before ``save_*`` returns: ``opt.step()`` updates
parameters in place, so the persist streams only from the arena's staged
copy, never from a live tensor.  The stall, its parts, the staged and
written bytes and the persist's time and MB/s stay as attributes
(:meth:`stats`) and in the log.

The reference's ``perf_stats``, ``journal``, master reports and
``chaos.inject`` hooks have no counterpart.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.checkpoint import shard_file, slicer, tree_utils
from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.multi_process import (
    SharedDict,
    SharedLock,
    SharedQueue,
    socket_path,
)
from dlrover_tpu_torch.common.shm import SharedMemoryArena, arena_name
from dlrover_tpu_torch.common.storage import CheckpointStorage, storage_for
from dlrover_tpu_torch.common.tensor_bytes import nbytes

# Page-locked staging comes in chunks of this size: the host allocator
# rounds a request up to a power of two, which one buffer of the whole
# state (9.3 GB at Llama-800M with AdamW) would nearly double.
_PINNED_CHUNK = 1 << 30
_ALIGN = 128
#: Shards a restore reads at once.
SHARD_IO_WORKERS = 4


def _optimizers(node) -> list:
    if isinstance(node, torch.optim.Optimizer):
        return [node]
    if isinstance(node, dict):
        return [o for v in node.values() for o in _optimizers(v)]
    if isinstance(node, (list, tuple)):
        return [o for v in node for o in _optimizers(v)]
    return []


def ckpt_queue_name(job_name: str) -> str:
    return env_utils.run_scoped(f"{job_name}-ckptq")


def ckpt_lock_name(job_name: str, local_rank: int) -> str:
    return env_utils.run_scoped(f"{job_name}-ckptlock-{local_rank}")


def ckpt_stat_name(job_name: str) -> str:
    return env_utils.run_scoped(f"{job_name}-ckptstat")


class _HostStage:
    """Page-locked host copies of a state's card tensors, kept across saves
    while the state's layout stays the same."""

    def __init__(self):
        self._layout = None
        self._chunks = []
        self._views: Dict[str, torch.Tensor] = {}

    def views(self, tensors: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        layout = [(k, t.dtype, tuple(t.shape)) for k, t in tensors.items()]
        if layout != self._layout:
            self._views, self._chunks = {}, []
            place, sizes = [], [0]
            for k, t in tensors.items():
                n = nbytes(t)
                n_al = (n + _ALIGN - 1) // _ALIGN * _ALIGN
                if sizes[-1] and sizes[-1] + n_al > _PINNED_CHUNK:
                    sizes.append(0)
                place.append((k, t, len(sizes) - 1, sizes[-1], n))
                sizes[-1] += n_al
            self._chunks = [torch.empty(max(s, 1), dtype=torch.uint8,
                                        pin_memory=True) for s in sizes]
            for k, t, c, off, n in place:
                self._views[k] = self._chunks[c][off:off + n].view(
                    t.dtype).reshape(t.shape)
            self._layout = layout
        return self._views

    def release(self) -> None:
        self._layout, self._chunks, self._views = None, [], {}


class CheckpointEngine:
    def __init__(
        self,
        ckpt_dir: str,
        *,
        job_name: str = "",
        storage: Optional[CheckpointStorage] = None,
        # None = keep 3 steps; 0 = keep all; N > 0 = keep the newest N.
        max_to_keep: Optional[int] = None,
        # How long the leader waits for the other ranks' done votes.
        commit_timeout: float = 600.0,
    ):
        self.ckpt_dir = ckpt_dir
        self.job_name = job_name or env_utils.get_job_name()
        self.storage = storage or storage_for(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.commit_timeout = commit_timeout
        self.process_id = env_utils.get_process_id()
        self.num_processes = env_utils.get_num_processes()
        self.local_rank = env_utils.get_local_rank()
        self.arena = SharedMemoryArena(
            arena_name(self.job_name, self.local_rank))
        # Fences the arena between the trainer's staging and the persist
        # thread's stream from its mapping; taken inside the agent's
        # fencing lock, never around it.
        self._arena_mu = threading.Lock()
        self._host = _HostStage()
        self._dirty = slicer.DirtyTracker()
        self._futures: list = []
        self._last_storage_step = -1
        self._step_had_corruption: Dict[int, bool] = {}
        self._restore_boxes: Optional[Dict[str, list]] = None
        self._man_cache: Dict[Tuple[int, int], Any] = {}
        self.agent_mode = os.path.exists(
            socket_path("queue", ckpt_queue_name(self.job_name)))
        self._queue: Optional[SharedQueue] = None
        self._lock: Optional[SharedLock] = None
        self._stat_client: Optional[SharedDict] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        if self.agent_mode:
            self._queue = SharedQueue(ckpt_queue_name(self.job_name))
            self._lock = SharedLock(
                ckpt_lock_name(self.job_name, self.local_rank))
            logger.info("checkpoint engine in agent mode")
        else:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ckpt-persist")
        # What the last save, persist and load cost (see stats()).
        self.last_stall_ms = 0.0
        self.last_d2h_ms = 0.0
        self.last_arena_ms = 0.0
        self._last_staged_bytes = 0
        self.last_persist_ms = 0.0
        self.last_persist_mbps = 0.0
        self.last_shard_bytes = 0
        self.last_written_bytes = 0
        self.last_restore_ms = 0.0
        self.last_restore_copy_ms = 0.0  # of which into the target
        self.last_restore_source: Optional[str] = None

    # -- save ---------------------------------------------------------------
    def _to_host(self, tensors: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """CPU copies of the card tensors (page-locked, one synchronise per
        card); CPU tensors pass as they are: the arena copy is theirs."""
        on_card = {k: t for k, t in tensors.items() if t.device.type != "cpu"}
        if not on_card:
            return dict(tensors)
        views = self._host.views(on_card)
        for k, t in on_card.items():
            views[k].copy_(t, non_blocking=True)
        for dev in {t.device for t in on_card.values()}:
            torch.cuda.synchronize(dev)
        return {k: views.get(k, t) for k, t in tensors.items()}

    def _stage(self, step: int, state: Any, meta: Optional[dict]) -> None:
        t0 = time.perf_counter()
        tensors, info = tree_utils.flatten_to_shards(state,
                                                     self.num_processes)
        host = self._to_host(tensors)
        t1 = time.perf_counter()
        self._last_staged_bytes = sum(nbytes(t) for t in host.values())
        extra = {
            "step": step,
            "meta": meta or {},
            "tensors_info": info,
            "process_id": self.process_id,
            "num_processes": self.num_processes,
            "ckpt_dir": self.ckpt_dir,
            "time": time.time(),
            # Every rank's leaf paths: lets the coverage proof notice a
            # dead rank's exclusive tensors, not only torn slices.
            "tree_paths": sorted({m["path"] for m in info.values()}),
        }
        # A persist (the agent's saver under the fencing lock, or the
        # persist thread under the arena mutex) holds its lock for a whole
        # streamed write: waiting is right, failing the save is not.
        if self._lock is not None:
            self._acquire_patiently(self._lock.acquire, "shm fencing lock")
        try:
            self._acquire_patiently(self._arena_mu.acquire, "arena mutex")
            try:
                self.arena.write_state(host, extra=extra)
            finally:
                self._arena_mu.release()
        finally:
            if self._lock is not None:
                self._lock.release()
        self.last_d2h_ms = (t1 - t0) * 1e3
        self.last_arena_ms = (time.perf_counter() - t1) * 1e3

    @staticmethod
    def _acquire_patiently(acquire, what: str, budget: float = 600.0) -> None:
        """Wait for a lock a persist may hold for a whole streamed write,
        warning each minute; raise after ``budget`` seconds."""
        deadline = time.time() + budget
        while not acquire(timeout=60.0):
            if time.time() >= deadline:
                raise TimeoutError(f"could not acquire {what}")
            logger.warning("save: %s still held (persist in flight?); "
                           "waiting", what)

    def save_to_memory(self, step: int, state: Any,
                       meta: Optional[dict] = None) -> None:
        """Stage into shm only: the train stall; the state survives a
        worker crash on this host."""
        t0 = time.perf_counter()
        self._stage(step, state, meta)
        self._note_stall(step, time.perf_counter() - t0)

    def _note_stall(self, step: int, seconds: float) -> None:
        self.last_stall_ms = seconds * 1000.0
        mbps = self._last_staged_bytes / max(seconds, 1e-9) / (1 << 20)
        logger.info(
            "flash ckpt: staged step %d to shm in %.3fs (%.0f MB/s, train "
            "stalled %.1fms: device-to-host %.1fms, arena %.1fms)",
            step, seconds, mbps, self.last_stall_ms, self.last_d2h_ms,
            self.last_arena_ms)
        if self.agent_mode:
            try:
                # Short budget: a dead stat server (agent restarting) must
                # cost ~2 s once, not the save's whole retry budget.
                self._stat().update({
                    f"stall_ms_{self.local_rank}": round(
                        self.last_stall_ms, 3),
                    f"staged_mbps_{self.local_rank}": round(mbps, 1),
                }, timeout=2.0)
            except Exception as e:  # noqa: BLE001
                logger.debug("stall stat report failed: %s", e)

    def _stat(self) -> SharedDict:
        if self._stat_client is None:
            self._stat_client = SharedDict(ckpt_stat_name(self.job_name))
        return self._stat_client

    def save_to_storage(self, step: int, state: Any,
                        meta: Optional[dict] = None) -> None:
        """Stage into shm, then have it persisted: by the agent's saver in
        agent mode, else by the persist thread."""
        t0 = time.perf_counter()
        self._stage(step, state, meta)
        self._note_stall(step, time.perf_counter() - t0)
        self._last_storage_step = step
        if self.agent_mode:
            self._queue.put({
                "event": "save",
                "step": step,
                "local_rank": self.local_rank,
                "process_id": self.process_id,
                "num_processes": self.num_processes,
                "ckpt_dir": self.ckpt_dir,
                "max_to_keep": self.max_to_keep,
            })
        else:
            self._futures.append((step, self._pool.submit(self._persist,
                                                          step)))

    def _persist(self, step: int) -> None:
        """Stream this rank's part of the arena's staged state to storage;
        the leader then commits.  Holds the arena mutex for the whole
        stream (the views are the mapping's bytes); a later save waits."""
        with self._arena_mu:
            read = self.arena.read_state(copy=False)
            if read is None:
                raise RuntimeError(
                    f"NOT persisting step {step}: arena holds no state")
            tensors, extra = read
            staged = int(extra.get("step", -1))
            if staged != step:
                logger.info("persist: arena holds step %d (wanted %d) — "
                            "persisting the staged one", staged, step)
                step = staged
            reason = shard_file.validate_staged_state(
                tensors, extra, expect_process_id=self.process_id,
                expect_num_processes=self.num_processes)
            if reason is not None:
                raise RuntimeError(
                    f"NOT persisting step {step}: staged state invalid "
                    f"({reason})")
            self._stream_shard(step, tensors, extra)
            del tensors
        if self.process_id == 0 and not self._commit_when_ready(step):
            raise RuntimeError(f"step {step} not committed")

    def _stream_shard(self, step: int, tensors, extra) -> None:
        """Sliced and incremental streamed persist: this rank writes only
        its slice of the replicated tensors, and a ref where a tensor's
        bytes match what an earlier persisted step holds."""
        t0 = time.perf_counter()
        plan = slicer.plan_persist(
            tensors, extra, process_id=self.process_id,
            num_processes=self.num_processes, tracker=self._dirty,
            # A holder at this very step is the file being rewritten: a
            # ref to it would point at itself.
            holder_exists=lambda s: s != step and self.storage.exists(
                shard_file.shard_path(self.ckpt_dir, s, self.process_id)),
        )
        stats = shard_file.write_shard_from_views(
            self.storage, self.ckpt_dir, step, self.process_id,
            plan.tensors, plan.extra, meta_extra=plan.meta_extra)
        self._dirty.note_plan(plan, step, stats.get("crcs", {}))
        seconds = time.perf_counter() - t0
        self.last_persist_ms = seconds * 1e3
        self.last_shard_bytes = int(stats["total_bytes"])
        self.last_written_bytes = int(plan.written_bytes)
        self.last_persist_mbps = self.last_shard_bytes / max(seconds, 1e-9) \
            / (1 << 20)
        logger.info(
            "flash ckpt: persisted step %d (rank %d/%d), %d bytes in %.3fs "
            "(%.0f MB/s; %d of %d staged tensor bytes written); %d/%d "
            "tensors unchanged (refs)", step, self.process_id,
            self.num_processes, self.last_shard_bytes, seconds,
            self.last_persist_mbps, plan.written_bytes, plan.logical_bytes,
            plan.skipped, len(plan.tensors))

    def _commit_when_ready(self, step: int) -> bool:
        """Leader: wait for every process's done vote, prove that the
        slices cover every tensor, then advance the tracker.  ``False``
        when the votes do not come within ``commit_timeout`` or the proof
        fails (the previous committed step stays the restore point)."""
        deadline = time.time() + self.commit_timeout
        while time.time() < deadline:
            if shard_file.all_shards_done(self.storage, self.ckpt_dir, step,
                                          self.num_processes):
                if not slicer.commit_gate(self.storage, self.ckpt_dir, step):
                    return False
                shard_file.commit(self.storage, self.ckpt_dir, step,
                                  keep_last=shard_file.resolve_keep_last(
                                      self.max_to_keep))
                return True
            time.sleep(0.2)
        logger.warning("commit of step %d timed out after %.0fs: done votes "
                       "missing", step, self.commit_timeout)
        return False

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until the last storage save is committed (by this leader,
        another rank's leader, or the agent's saver); ``False`` when a
        persist failed or the commit did not come within ``timeout``."""
        ok = True
        for step, fut in self._futures:
            try:
                fut.result(timeout=timeout)
            except FutureTimeout:
                logger.error("persist of step %d still running after %.0fs",
                             step, timeout)
                ok = False
            except Exception:  # noqa: BLE001 - the persist's own failure
                logger.exception("persist of step %d failed", step)
                ok = False
        self._futures = []
        if not ok:
            return False
        if self._last_storage_step < 0:
            return True
        deadline = time.time() + timeout
        while True:
            committed = shard_file.latest_step(self.storage, self.ckpt_dir)
            if committed is not None and committed >= self._last_storage_step:
                return True
            if time.time() >= deadline:
                return False
            time.sleep(0.2)

    # -- agreement across ranks --------------------------------------------
    def _all_ranks_ok(self, ok: bool) -> bool:
        """Collective AND over the processes; ``ok`` alone without a
        group of this world."""
        if not dist_env.agreeing(self.num_processes):
            return ok
        return all(dist_env.allgather_ints(1 if ok else 0))

    def _agree_shm_step(self, got):
        """A warm restore is valid only when every process staged the same
        step (staging lag at a crash can leave ranks apart); on any
        disagreement all fall back to storage together.  A collective."""
        if not dist_env.agreeing(self.num_processes):
            return got
        own = -1 if got is None else int(got[1].get("step", -1))
        steps = dist_env.allgather_ints(own)
        if min(steps) >= 0 and len(set(steps)) == 1:
            return got
        if got is not None:
            logger.warning("shm restore steps disagree across ranks (%s); "
                           "falling back to storage", steps)
        return None

    def _agree_storage_step(self, found, chosen: int, target):
        """Every rank resumes from the same storage step (``found`` is this
        rank's candidate, not yet copied into the target): on disagreement
        the oldest (or a fresh start when a rank has none), re-read where
        needed; if a rank cannot restore the agreed step, all start fresh.
        A collective."""
        if not dist_env.agreeing(self.num_processes):
            return found
        steps = dist_env.allgather_ints(chosen)
        if len(set(steps)) == 1:
            return found
        agreed = -1 if min(steps) < 0 else min(steps)
        logger.warning("storage restore steps disagree across ranks (%s); "
                       "agreeing on %s", steps,
                       agreed if agreed >= 0 else "a fresh start")
        retry = None
        if agreed >= 0:
            if chosen == agreed:
                retry = found
            else:
                got = self._read_step(agreed)
                if got is not None:
                    try:
                        retry = self._assemble_candidate(*got, target,
                                                         agreed)
                    except (KeyError, ValueError) as e:
                        logger.warning("agreed step %d failed to assemble: "
                                       "%s", agreed, e)
        ok = dist_env.allgather_ints(
            1 if (retry is not None or agreed < 0) else 0)
        if not all(ok):
            logger.warning("agreed storage step %d unrestorable on some "
                           "rank; starting fresh", agreed)
            return None
        return retry if agreed >= 0 else None

    # -- load ---------------------------------------------------------------
    def load(self, target: Any = None, *, target_mesh=None
             ) -> Optional[Tuple[Any, dict]]:
        """Restore the newest state every rank can: the shm arena (warm,
        same world only) else storage (the committed step, then other
        steps newest first; a step whose shard is corrupt is skipped and
        quarantined).  With ``target``, copies into its live tensors and
        returns ``(target, meta)``; without, ``({path: tensor}, meta)``
        (each leaf whole).  With ``target_mesh`` (a
        :class:`~dlrover_tpu_torch.parallel.mesh.Mesh`), each target leaf
        first keeps its spec on that mesh (:meth:`_retarget`), and the
        returned tree is the re-homed one.  ``None`` when nothing is
        restorable.  Every rank must call it (the agreement is
        collective)."""
        if target is not None and target_mesh is not None:
            target = self._retarget(target, target_mesh)
        t0 = time.perf_counter()
        self._restore_boxes = (self._target_boxes(target)
                               if target is not None else None)
        self._man_cache = {}
        result, found, source = None, None, "shm"
        # Each candidate is assembled and checked against the target, and
        # copied into it only once every rank agreed on it: a restore that
        # the ranks then abandon leaves the live tensors as they were.
        # Without a target the tensors leave this call: copy them.  With
        # one, they are copied into it before the arena mutex is released.
        # In agent mode the saver may write the arena: copy too.
        with self._arena_mu:
            got = self._load_from_shm(copy=target is None or self.agent_mode)
            got = self._agree_shm_step(got)
            if got is not None:
                try:
                    found = self._finish_load(got[0], got[1], target)
                except (KeyError, ValueError) as e:
                    logger.warning("shm state does not fit the target (%s); "
                                   "falling back to storage", e)
                if self._all_ranks_ok(found is not None):
                    result = self._apply(found, target)
        if result is None:
            found, source, chosen = None, "storage", -1
            self._step_had_corruption = {}
            for src, extra, selective in self._storage_candidates():
                step = int(extra.get("step", -1))
                try:
                    found = self._assemble_candidate(src, extra, selective,
                                                     target, step)
                    chosen = max(step, 0)
                    break
                except (KeyError, ValueError) as e:
                    logger.warning("storage step %d not restorable (%s); "
                                   "trying older", step, e)
                if self._step_had_corruption.get(step):
                    self._quarantine(step)
            found = self._agree_storage_step(found, chosen, target)
            if found is not None:
                result = self._apply(found, target)
        if result is not None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.last_restore_ms = (time.perf_counter() - t0) * 1e3
            self.last_restore_source = source
            logger.info("flash ckpt: restored step %s from %s in %.1fms",
                        result[1].get("step"), source, self.last_restore_ms)
        return result

    def _apply(self, found, target):
        """``found`` (``({path: tensor}, meta)``) copied into ``target``."""
        if target is None:
            return found
        t0 = time.perf_counter()
        tree_utils.restore_to_target(found[0], target)
        self.last_restore_copy_ms = (time.perf_counter() - t0) * 1e3
        return target, found[1]

    def _assemble_candidate(self, source, extra, selective: bool, target,
                            step: int):
        """Assemble one storage candidate; when plan-selected reads left it
        uncovered (selection is bandwidth, never correctness), read every
        shard of the same step before the ladder falls to an older one."""
        try:
            return self._finish_load(source, extra, target)
        except KeyError:
            if not selective:
                raise
            logger.warning("storage step %d uncoverable from plan-selected "
                           "reads; retrying with a full read", step)
            full = self._read_step(step, selective=False)
            if full is None:
                raise
            return self._finish_load(full[0], full[1], target)

    def _finish_load(self, source: tree_utils.ShardSource, extra, target):
        """``({path: tensor}, meta)`` of one candidate, checked against
        ``target`` (nothing is copied yet)."""
        meta = dict(extra.get("meta") or {})
        meta.setdefault("step", extra.get("step", 0))
        if target is None:
            return source.whole(), meta
        tensors = {}
        leaves = tree_utils.state_leaves(target)
        extra_paths = sorted(set(source.paths())
                             - {leaf.path for leaf in leaves})
        if extra_paths:
            raise KeyError(f"checkpoint does not match the target: "
                           f"{len(extra_paths)} extra {extra_paths[:3]}")
        for leaf in leaves:
            if leaf.path not in source.shapes:
                continue  # check_target names the missing paths
            box = self._leaf_box(leaf)
            if tuple(source.shapes[leaf.path]) != self._global_shape(leaf):
                raise ValueError(
                    f"{leaf.path}: checkpoint has global shape "
                    f"{tuple(source.shapes[leaf.path])}, target "
                    f"{self._global_shape(leaf)}")
            piece = source.assemble(leaf.path, box, dtype=leaf.tensor.dtype)
            if piece is None:
                raise KeyError(f"checkpoint missing data for {leaf.path} "
                               f"box {box}")
            tensors[leaf.path] = piece
        tree_utils.check_target(tensors, target)
        return tensors, meta

    @staticmethod
    def _leaf_box(leaf) -> tuple:
        pl = leaf.placement
        if pl is not None and pl.sharded:
            return pl.box()
        return tuple((0, int(d)) for d in leaf.tensor.shape)

    @staticmethod
    def _global_shape(leaf) -> tuple:
        pl = leaf.placement
        if pl is not None and pl.sharded:
            return tuple(pl.global_shape)
        return tuple(int(d) for d in leaf.tensor.shape)

    def _load_from_shm(self, copy: bool):
        try:
            self.arena.reopen()
        except (FileNotFoundError, OSError):
            return None  # no arena: first run on this host
        read = self.arena.read_state(copy=copy)
        if read is None:
            return None
        tensors, extra = read
        info = extra.get("tensors_info") or {}
        if not info:
            return None
        # A warm restore is valid for the same world only: a changed
        # world's ranks hold other parts; storage has every rank's.
        if (extra.get("num_processes") != self.num_processes
                or extra.get("process_id") != self.process_id):
            logger.info("shm state belongs to another world layout "
                        "(proc %s/%s vs %s/%s); falling back to storage",
                        extra.get("process_id"), extra.get("num_processes"),
                        self.process_id, self.num_processes)
            return None
        source = tree_utils.ShardSource()
        source.add(tensors, info)
        logger.info("flash ckpt: warm restore from shm (step %s)",
                    extra.get("step"))
        return source, extra

    @classmethod
    def _target_boxes(cls, target: Any) -> Dict[str, list]:
        """``{path: [boxes]}`` of a target: this rank's box of each
        sharded leaf, the whole tensor of each other leaf."""
        return {leaf.path: [cls._leaf_box(leaf)]
                for leaf in tree_utils.state_leaves(target)}

    @staticmethod
    def _retarget(target: Any, target_mesh) -> Any:
        """``target`` with each leaf's spec on ``target_mesh`` (a whole
        leaf stays whole): a leaf whose box there has its tensor's shape is
        retagged and restored in place; another gets a new tensor of its
        new box in a new container (the returned tree holds it), which an
        optimizer of the target must not hold (build the state on the new
        mesh instead)."""
        from dlrover_tpu_torch.parallel.sharding import placement_of, tag

        replaced = set()

        def rehome(node):
            # A container none of whose leaves changes is kept itself, so
            # a restore into it (its int leaves too) reaches the caller's.
            if isinstance(node, dict):
                new = {k: rehome(v) for k, v in node.items()}
                return node if all(new[k] is v for k, v in node.items()) \
                    else new
            if isinstance(node, (list, tuple)):
                new = [rehome(v) for v in node]
                return node if all(a is b for a, b in zip(new, node)) \
                    else type(node)(new)
            pl = placement_of(node) if torch.is_tensor(node) else None
            if pl is None:
                return node
            new = pl.on(target_mesh)
            shape = tuple(e - s for s, e in new.box())
            if shape == tuple(node.shape):
                return tag(node, new)
            replaced.add(id(node))
            return tag(torch.empty(shape, dtype=node.dtype,
                                   device=node.device), new)

        out = rehome(target)
        for opt in _optimizers(out):
            if any(id(p) in replaced for g in opt.param_groups
                   for p in g["params"]):
                raise ValueError(
                    "load(target_mesh=...): an optimizer of the target "
                    "holds a leaf whose box changes on the new mesh; build "
                    "the state on that mesh (accelerate(...).create_state) "
                    "and restore into it")
        return out

    def _manifest(self, step: int, pid: int):
        """One verified meta read per shard per load, shared by the shard
        selection and the data read.  Raises ``ShardCorruptionError``;
        ``None`` when absent."""
        man = self._man_cache.get((step, pid))
        if man is None:
            man = shard_file.read_shard_manifest(self.storage, self.ckpt_dir,
                                                 step, pid)
            if man is not None:
                self._man_cache[(step, pid)] = man
        return man

    @staticmethod
    def _box_overlap(a, b) -> bool:
        if len(a) != len(b):
            return False
        return all(max(s1, s2) < min(e1, e2)
                   for (s1, e1), (s2, e2) in zip(a, b))

    def _needed_keys(self, man):
        """The keys of one shard whose box overlaps a target box; ``None``
        means read everything (no target, or an odd manifest)."""
        boxes = self._restore_boxes
        if boxes is None:
            return None
        try:
            info = man.extra.get("tensors_info") or {}
            need = set()
            for key, m in info.items():
                tb = boxes.get(m["path"])
                if not tb:
                    continue
                box = tuple(tuple(int(v) for v in p) for p in m["index"])
                if any(self._box_overlap(box, b) for b in tb):
                    need.add(key)
            return need
        except (KeyError, TypeError, ValueError) as e:
            logger.debug("needed-key derivation failed: %s", e)
            return None

    def _select_pids(self, step: int, pids: list) -> list:
        """Of a step's shards, those this process's target needs: every
        rank holding an overlapping slice of a sliced step, else the
        fewest ranks that cover the target (the reshard planner's
        ``ranks_needed``; this rank's own shard first).  Any failure reads
        everything: selection is bandwidth, never correctness."""
        boxes = self._restore_boxes
        if boxes is None or len(pids) <= 1:
            return pids
        try:
            manifests = {}
            for pid in pids:
                man = self._manifest(step, pid)
                if man is None:
                    continue
                if not (man.extra.get("tensors_info") or {}):
                    return pids
                manifests[pid] = man
            if not manifests:
                return pids
            if any(m.extra.get("sliced") for m in manifests.values()):
                chosen = []
                for p in pids:
                    if p not in manifests:
                        continue
                    need = self._needed_keys(manifests[p])
                    if need is None:
                        return pids
                    if need:
                        chosen.append(p)
            else:
                from dlrover_tpu_torch.reshard.plan import ranks_needed

                need = ranks_needed(
                    {pid: m.extra["tensors_info"]
                     for pid, m in manifests.items()},
                    boxes, dst_rank=self.process_id)
                chosen = [p for p in pids if p in set(need)]
            if not chosen:
                return pids
            if len(chosen) < len(pids):
                logger.info("flash ckpt: the plan needs %d/%d shards of "
                            "step %d", len(chosen), len(pids), step)
            return chosen
        except Exception as e:  # noqa: BLE001 - see docstring
            logger.debug("shard selection for step %d fell back to a full "
                         "read: %s", step, e)
            return pids

    def _read_step(self, step: int, selective: bool = True):
        """One step's shards (plan-selected ranks, needed pieces, read
        concurrently) as ``(ShardSource, extra, was_selective)``; ``None``
        when nothing was readable.  A shard that fails verification is
        skipped like an absent one: other ranks may still cover it."""
        source = tree_utils.ShardSource()
        extra_out = None
        corrupt = read_failed = False
        pids = shard_file.list_shard_ids(self.storage, self.ckpt_dir, step)
        chosen = self._select_pids(step, pids) if selective else list(pids)
        was_selective = selective and (
            len(chosen) < len(pids) or self._restore_boxes is not None)

        def read_one(pid: int, restrict: bool):
            try:
                man = self._manifest(step, pid)
                if man is None:
                    return pid, "absent", None
                keys = self._needed_keys(man) if restrict else None
                got = shard_file.read_shard_pieces(
                    self.storage, self.ckpt_dir, step, pid, manifest=man,
                    keys=keys)
                if got is None:
                    return pid, "absent", None
                return pid, "ok", got
            except shard_file.ShardCorruptionError as e:
                return pid, "corrupt", e
            except OSError as e:  # an I/O hiccup: absent, not damaged
                return pid, "error", e

        def merge(results) -> None:
            nonlocal extra_out, corrupt, read_failed
            for pid, status, payload in results:
                if status == "ok":
                    tensors, slices, extra = payload
                    source.add(tensors, extra.get("tensors_info", {}),
                               slices)
                    if pid == self.process_id or extra_out is None:
                        extra_out = extra
                elif status == "corrupt":
                    corrupt = read_failed = True
                    logger.warning("corrupt checkpoint shard (step %d, proc "
                                   "%d): %s", step, pid, payload)
                else:
                    read_failed = True
                    if status == "error":
                        logger.warning("shard (step %d, proc %d) unreadable "
                                       "(%s); skipping", step, pid, payload)

        merge(self._read_many(chosen, selective, read_one))
        if read_failed and len(chosen) < len(pids):
            # A selected shard was damaged or absent; the skipped ranks
            # may still cover the target (replicated layouts).
            rest = [p for p in pids if p not in set(chosen)]
            merge(self._read_many(rest, False, read_one))
        self._step_had_corruption[step] = corrupt
        if extra_out is None:
            if corrupt:
                self._quarantine(step)
            return None
        return source, extra_out, was_selective

    @staticmethod
    def _read_many(pids: list, restrict: bool, read_one):
        """Concurrent shard reads, results in ``pids`` order (so the extra
        taken is deterministic)."""
        if len(pids) <= 1:
            return [read_one(pid, restrict) for pid in pids]
        with ThreadPoolExecutor(max_workers=min(len(pids), SHARD_IO_WORKERS),
                                thread_name_prefix="ckpt-read") as pool:
            return list(pool.map(lambda p: read_one(p, restrict), pids))

    def _storage_candidates(self):
        """``(source, extra, selective)`` per readable storage step: the
        committed step first, then the other live steps newest first (an
        uncommitted step serves when its shards cover the target)."""
        committed = shard_file.latest_step(self.storage, self.ckpt_dir)
        steps = shard_file.list_steps(self.storage, self.ckpt_dir)
        candidates = [committed] if committed in steps else []
        candidates += [s for s in sorted(steps, reverse=True)
                       if s != committed]
        for step in candidates:
            got = self._read_step(step)
            if got is None:
                continue
            logger.info("flash ckpt: restore from storage step %d%s", step,
                        "" if step == committed else " (uncommitted)")
            yield got

    def _quarantine(self, step: int) -> None:
        shard_file.quarantine_step(self.storage, self.ckpt_dir, step)

    def stats(self) -> dict:
        """What the last save, persist and restore cost."""
        return {
            "stall_ms": self.last_stall_ms,
            "d2h_ms": self.last_d2h_ms,
            "arena_ms": self.last_arena_ms,
            "staged_bytes": self._last_staged_bytes,
            "arena_bytes": self.arena.size,
            "arena_backend": self.arena.backend,
            "persist_ms": self.last_persist_ms,
            "persist_mbps": self.last_persist_mbps,
            "shard_bytes": self.last_shard_bytes,
            "written_bytes": self.last_written_bytes,
            "restore_ms": self.last_restore_ms,
            "restore_copy_ms": self.last_restore_copy_ms,
            "restore_source": self.last_restore_source,
            "agent_mode": self.agent_mode,
            "process_id": self.process_id,
            "num_processes": self.num_processes,
        }

    def close(self) -> None:
        """Finish the persist in flight and unmap the arena (the segment
        stays for a warm restart)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
        with self._arena_mu:
            self.arena.close()
        self._host.release()
