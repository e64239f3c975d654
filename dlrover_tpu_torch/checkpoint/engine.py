"""Worker-side checkpoint engine: training state -> shm arena -> (async)
storage, and back — the port's own counterpart of
``dlrover_tpu/checkpoint/engine.py`` ``CheckpointEngine`` in standalone
mode (``:62-131``): ``_stage``, ``save_to_memory``, ``save_to_storage`` with
a one-thread persist pool, ``_persist`` / ``_stream_shard`` from the arena
(``:133-396``), ``_commit_when_ready`` for one process, ``wait``, ``load``
through the shm-then-storage ladder with quarantine of a corrupt step
(``:464-545``, ``:992-1054``) and ``close``.

``_stage`` is the train stall.  It copies every card tensor to page-locked
host memory (``non_blocking``, then one synchronise per card) and then into
the arena, all before ``save_*`` returns: ``opt.step()`` updates
parameters in place, so the persist thread streams only from the arena's
staged copy, never from a live tensor (a shard streamed from a tensor that
changes under it would be torn and still carry a CRC that validates).  The
stall, its device-to-host and arena parts, the staged bytes and the
persist's time and MB/s stay as attributes (:meth:`stats`) and in the log.

Not ported yet, each raising ``NotImplementedError`` where it would be
entered: agent mode (the per-node ``AsyncCheckpointSaver`` hosting the
queue, entered when its socket exists), more than one process
(``_all_ranks_ok``, ``_agree_*``, sliced persist; Queue A item 3) and
``load(target_mesh=)``.  The reference's ``perf_stats``, ``journal``,
master reports and ``chaos.inject`` hooks have no counterpart.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Dict, Optional, Tuple

import torch

from dlrover_tpu_torch.checkpoint import shard_file, slicer, tree_utils
from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.shm import SharedMemoryArena, arena_name
from dlrover_tpu_torch.common.storage import CheckpointStorage, storage_for
from dlrover_tpu_torch.common.tensor_bytes import nbytes

MULTIPROCESS_SLICE = "Queue A item 3 of the port (see ROADMAP.md)"
_SOCK_DIR = os.environ.get("DLROVER_TPU_SOCK_DIR", "/tmp/dlrover_tpu_sock")
# Page-locked staging comes in chunks of this size: the host allocator
# rounds a request up to a power of two, which one buffer of the whole
# state (9.3 GB at Llama-800M with AdamW) would nearly double.
_PINNED_CHUNK = 1 << 30
_ALIGN = 128


def agent_queue_socket(job_name: str) -> str:
    """Where the agent-side saver's queue socket lives (the reference's
    ``socket_path("queue", ckpt_queue_name(job_name))``)."""
    name = env_utils.run_scoped(f"{job_name}-ckptq")
    path = os.path.join(_SOCK_DIR, f"queue_{name}.sock")
    if len(path) >= 100:  # AF_UNIX sun_path limit
        digest = hashlib.md5(name.encode()).hexdigest()[:16]
        path = os.path.join(_SOCK_DIR, f"queue_{digest}.sock")
    return path


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
    ):
        self.ckpt_dir = ckpt_dir
        self.job_name = job_name or env_utils.get_job_name()
        self.storage = storage or storage_for(ckpt_dir)
        self.max_to_keep = max_to_keep
        self.process_id = env_utils.get_process_id()
        self.num_processes = env_utils.get_num_processes()
        self.local_rank = int(os.environ.get("DLROVER_TPU_LOCAL_RANK", 0))
        if self.num_processes != 1:
            raise NotImplementedError(
                f"checkpointing {self.num_processes} processes (the "
                f"cross-rank commit and agreement) comes with "
                f"{MULTIPROCESS_SLICE}")
        sock = agent_queue_socket(self.job_name)
        if os.path.exists(sock):
            raise NotImplementedError(
                f"agent mode (the saver's queue at {sock}): the agent-side "
                f"ckpt_saver comes with {MULTIPROCESS_SLICE}")
        self.arena = SharedMemoryArena(
            arena_name(self.job_name, self.local_rank))
        # Fences the arena between the trainer's staging and the persist
        # thread's stream from its mapping.
        self._arena_mu = threading.Lock()
        self._host = _HostStage()
        self._dirty = slicer.DirtyTracker()
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt-persist")
        self._futures: list = []
        self._last_persist_step = -1
        self._step_had_corruption: Dict[int, bool] = {}
        # What the last save, persist and load cost (see stats()).
        self.last_stall_ms = 0.0
        self.last_d2h_ms = 0.0
        self.last_arena_ms = 0.0
        self._last_staged_bytes = 0
        self.last_persist_ms = 0.0
        self.last_persist_mbps = 0.0
        self.last_shard_bytes = 0
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
        tensors, info = tree_utils.flatten_to_shards(state)
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
            "tree_paths": sorted({m["path"] for m in info.values()}),
        }
        self._acquire_patiently(self._arena_mu.acquire, "arena mutex")
        try:
            self.arena.write_state(host, extra=extra)
        finally:
            self._arena_mu.release()
        self.last_d2h_ms = (t1 - t0) * 1e3
        self.last_arena_ms = (time.perf_counter() - t1) * 1e3

    @staticmethod
    def _acquire_patiently(acquire, what: str, budget: float = 600.0) -> None:
        """Wait for a lock the persist thread may hold for a whole streamed
        write, warning each minute; raise after ``budget`` seconds."""
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

    def save_to_storage(self, step: int, state: Any,
                        meta: Optional[dict] = None) -> None:
        """Stage into shm, then persist to storage on the persist thread."""
        t0 = time.perf_counter()
        self._stage(step, state, meta)
        self._note_stall(step, time.perf_counter() - t0)
        self._futures.append((step, self._pool.submit(self._persist, step)))

    def _persist(self, step: int) -> None:
        """Stream the arena's staged state to storage and commit it.  Holds
        the arena mutex for the whole stream (the views are the mapping's
        bytes); a later save waits for it."""
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
        self._last_persist_step = step
        self._commit_when_ready(step)

    def _stream_shard(self, step: int, tensors, extra) -> None:
        """Incremental streamed persist: a tensor whose bytes match what an
        earlier persisted step holds is written as a ref to it."""
        t0 = time.perf_counter()
        plan = slicer.plan_persist(
            tensors, extra, process_id=self.process_id,
            num_processes=self.num_processes, tracker=self._dirty,
            holder_exists=lambda s: self.storage.exists(
                shard_file.shard_path(self.ckpt_dir, s, self.process_id)),
        )
        stats = shard_file.write_shard_from_views(
            self.storage, self.ckpt_dir, step, self.process_id,
            plan.tensors, plan.extra, meta_extra=plan.meta_extra)
        self._dirty.note_plan(plan, step, stats.get("crcs", {}))
        seconds = time.perf_counter() - t0
        self.last_persist_ms = seconds * 1e3
        self.last_shard_bytes = int(stats["total_bytes"])
        self.last_persist_mbps = self.last_shard_bytes / max(seconds, 1e-9) \
            / (1 << 20)
        logger.info(
            "flash ckpt: persisted step %d, %d bytes in %.3fs (%.0f MB/s); "
            "%d/%d tensors unchanged (refs)", step, self.last_shard_bytes,
            seconds, self.last_persist_mbps, plan.skipped,
            len(plan.tensors))

    def _commit_when_ready(self, step: int) -> None:
        """Advance the tracker once every process's done vote is there (on
        one process: this one's, written by the persist)."""
        if not shard_file.all_shards_done(self.storage, self.ckpt_dir, step,
                                          self.num_processes):
            raise RuntimeError(f"step {step}: done votes missing; not "
                               f"committed")
        shard_file.commit(self.storage, self.ckpt_dir, step,
                          keep_last=shard_file.resolve_keep_last(
                              self.max_to_keep))

    def wait(self, timeout: float = 600.0) -> bool:
        """Block until every requested persist has ended; ``True`` when
        the last one is committed.  A failed persist is logged and gives
        ``False``."""
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
        if self._last_persist_step < 0:
            return True
        committed = shard_file.latest_step(self.storage, self.ckpt_dir)
        return committed is not None and committed >= self._last_persist_step

    # -- load ---------------------------------------------------------------
    def load(self, target: Any = None, *, target_mesh=None
             ) -> Optional[Tuple[Any, dict]]:
        """Restore the newest state: the shm arena (warm) else storage
        (the committed step, then other steps newest first; a step whose
        shard is corrupt is skipped and quarantined).  With ``target``,
        copies into its live tensors and returns ``(target, meta)``;
        without, returns ``({path: tensor}, meta)``.  ``None`` when
        nothing is restorable."""
        if target_mesh is not None:
            raise NotImplementedError(
                f"restore onto another mesh comes with {MULTIPROCESS_SLICE}")
        t0 = time.perf_counter()
        result = self._load_from_shm(target)
        source = "shm"
        if result is None:
            result, source = self._load_from_storage(target), "storage"
        if result is not None:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.last_restore_ms = (time.perf_counter() - t0) * 1e3
            self.last_restore_source = source
            logger.info("flash ckpt: restored step %s from %s in %.1fms",
                        result[1].get("step"), source, self.last_restore_ms)
        return result

    def _finish_load(self, tensors, extra, target):
        meta = dict(extra.get("meta") or {})
        meta.setdefault("step", extra.get("step", 0))
        source = tree_utils.source_from_shards(
            tensors, extra.get("tensors_info") or {})
        if target is None:
            return source, meta
        t0 = time.perf_counter()
        restored = tree_utils.restore_to_target(source, target)
        self.last_restore_copy_ms = (time.perf_counter() - t0) * 1e3
        return restored, meta

    def _load_from_shm(self, target):
        # Without a target the tensors leave this call: copy them.  With
        # one, they are copied into it before the arena mutex is released.
        with self._arena_mu:
            try:
                self.arena.reopen()
            except FileNotFoundError:
                return None  # no arena: first run on this host
            read = self.arena.read_state(copy=target is None)
            if read is None:
                return None
            tensors, extra = read
            if (extra.get("num_processes") != self.num_processes
                    or extra.get("process_id") != self.process_id):
                logger.info("shm state belongs to another world layout "
                            "(proc %s/%s); falling back to storage",
                            extra.get("process_id"),
                            extra.get("num_processes"))
                return None
            try:
                return self._finish_load(tensors, extra, target)
            except (KeyError, ValueError) as e:
                logger.warning("shm state does not fit the target (%s); "
                               "falling back to storage", e)
                return None

    def _load_from_storage(self, target):
        committed = shard_file.latest_step(self.storage, self.ckpt_dir)
        steps = shard_file.list_steps(self.storage, self.ckpt_dir)
        candidates = [committed] if committed in steps else []
        candidates += [s for s in sorted(steps, reverse=True)
                       if s != committed]
        self._step_had_corruption = {}
        for step in candidates:
            got = self._read_step(step)
            if got is not None:
                logger.info("flash ckpt: restore from storage step %d%s",
                            step, "" if step == committed
                            else " (uncommitted)")
                try:
                    return self._finish_load(got[0], got[1], target)
                except (KeyError, ValueError) as e:
                    logger.warning("storage step %d not restorable (%s); "
                                   "trying older", step, e)
            if self._step_had_corruption.get(step):
                shard_file.quarantine_step(self.storage, self.ckpt_dir, step)
        return None

    def _read_step(self, step: int):
        """This process's shard of ``step`` as ``(tensors, extra)``, or
        ``None`` when absent, unreadable or corrupt."""
        try:
            got = shard_file.read_shard_pieces(
                self.storage, self.ckpt_dir, step, self.process_id)
        except shard_file.ShardCorruptionError as e:
            self._step_had_corruption[step] = True
            logger.warning("corrupt checkpoint shard (step %d, proc %d): %s",
                           step, self.process_id, e)
            return None
        except OSError as e:
            logger.warning("shard (step %d, proc %d) unreadable (%s); "
                           "skipping", step, self.process_id, e)
            return None
        if got is None:
            return None
        tensors, slices, extra = got
        if slices:
            logger.warning("step %d holds cross-replica slices; restoring "
                           "them comes with %s", step, MULTIPROCESS_SLICE)
            return None
        return tensors, extra

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
            "restore_ms": self.last_restore_ms,
            "restore_copy_ms": self.last_restore_copy_ms,
            "restore_source": self.last_restore_source,
        }

    def close(self) -> None:
        """Finish the persist in flight and unmap the arena (the segment
        stays for a warm restart)."""
        self._pool.shutdown(wait=True)
        with self._arena_mu:
            self.arena.close()
        self._host.release()
