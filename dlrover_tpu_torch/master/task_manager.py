"""Dynamic data sharding — the port's own copy of
``dlrover_tpu/master/task_manager.py`` (``DoingTask``, ``DatasetManager``
``:47``, ``TaskManager`` ``:192`` with its timeout reassign loop ``:369``).

Workers pull index shards from the master as tasks instead of owning a
static partition: the shards a dead worker held go back to the front of
the queue (``recover_worker_tasks``), a task held past ``task_timeout`` is
re-queued by the loop (every 30 s), and the cursor (todo and doing) is a
JSON string a worker can checkpoint and restore.  ``checkpoint_dataset``
returns the reference's string byte for byte.

With the HA journal bound (``master/state.py``) every mutation is
journaled before the RPC is acked: a dataset's registration, a grant (with
the task id it gave), a result, a dead worker's recovery, a timeout
requeue (by task id, so that replay does not depend on the primary's
clock) and a cursor restore.  ``dump_state``/``load_state`` are the
snapshot's part; the snapshot carries the retried-fetch cache as plain
data (:func:`grants_as_data`: ``[task_id, shard fields, epoch]``), where
the reference's msgpack refuses the ``Shard`` of a tokened grant, and
``load_state`` takes either form.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.token_cache import BoundedTokenCache
from dlrover_tpu_torch.master.dataset_splitter import (
    DatasetSplitter,
    Shard,
    new_dataset_splitter,
)
from dlrover_tpu_torch.master.state import JournalBound

#: Seconds between two passes of the timeout reassign loop.
REASSIGN_INTERVAL_S = 30.0


@dataclasses.dataclass
class DoingTask:
    task_id: int
    worker_id: int
    start_time: float
    shard: Shard
    task_type: str = "training"


class DatasetManager:
    """One dataset's task queues."""

    def __init__(self, splitter: DatasetSplitter, task_timeout: float = 1800.0,
                 params: Optional[dict] = None):
        self.splitter = splitter
        self.params = dict(params) if params else {}
        self._task_timeout = task_timeout
        self._todo: List[tuple] = []  # (task_id, Shard)
        self._doing: Dict[int, DoingTask] = {}
        self._task_id_seq = 0
        self._completed_ids: set = set()
        self._dispatched = 0

    def _refill_if_empty(self) -> None:
        if not self._todo and not self.splitter.epoch_finished():
            for shard in self.splitter.create_shards():
                self._todo.append((self._task_id_seq, shard))
                self._task_id_seq += 1

    def get_task(self, worker_id: int, task_type: str = "training"):
        self._refill_if_empty()
        if not self._todo:
            return None
        task_id, shard = self._todo.pop(0)
        self._doing[task_id] = DoingTask(task_id, worker_id,
                                         time.monotonic(), shard, task_type)
        self._dispatched += 1
        return task_id, shard, self.splitter.epoch

    def report_task_result(self, task_id: int, success: bool) -> None:
        doing = self._doing.pop(task_id, None)
        if doing is None:
            return
        if success:
            self._completed_ids.add(task_id)
        else:
            self._todo.insert(0, (task_id, doing.shard))

    def _requeue(self, task_ids) -> List[int]:
        moved = []
        for task_id in task_ids:
            doing = self._doing.pop(task_id, None)
            if doing is not None:
                self._todo.insert(0, (task_id, doing.shard))
                moved.append(task_id)
        return moved

    def recover_worker_tasks(self, worker_id: int) -> int:
        """Re-queue the shards a dead worker held."""
        return len(self._requeue([t for t, d in self._doing.items()
                                  if d.worker_id == worker_id]))

    def reassign_timeout_tasks(self) -> List[int]:
        """Re-queue the tasks held past the timeout; their ids."""
        now = time.monotonic()
        return self._requeue([t for t, d in self._doing.items()
                              if now - d.start_time > self._task_timeout])

    def requeue_tasks(self, task_ids: List[int]) -> int:
        """Move these doing tasks to the todo front; an id no longer doing
        is skipped, so applying it twice moves nothing more."""
        return len(self._requeue(task_ids))

    def rearm_doing(self) -> None:
        """Restart every doing task's timeout on this process's clock."""
        now = time.monotonic()
        for doing in self._doing.values():
            doing.start_time = now

    def completed(self) -> bool:
        self._refill_if_empty()
        return (not self._todo and not self._doing
                and self.splitter.epoch_finished())

    def checkpoint(self) -> str:
        todo = [(tid, dataclasses.asdict(s)) for tid, s in self._todo]
        doing = [(t.task_id, dataclasses.asdict(t.shard), t.worker_id)
                 for t in self._doing.values()]
        return json.dumps({
            "dataset_name": self.splitter.dataset_name,
            "todo": todo,
            "doing": doing,
            "epoch": self.splitter.epoch,
            "task_id_seq": self._task_id_seq,
        })

    def restore(self, content: str, keep_doing: bool = False) -> None:
        """Restore the cursor.  A worker's restore after a full restart
        (``keep_doing=False``) folds the doing tasks into the todo front:
        their grants died with the old workers.  A snapshot of a live job
        (``keep_doing=True``) keeps them doing, on a timeout clock started
        now."""
        data = json.loads(content)
        self._todo = [(tid, Shard(**shard))
                      for tid, shard in data.get("todo", [])]
        self._doing.clear()
        now = time.monotonic()
        for entry in data.get("doing", []):
            tid, shard = entry[0], entry[1]
            worker_id = entry[2] if len(entry) > 2 else -1
            if keep_doing:
                self._doing[tid] = DoingTask(tid, worker_id, now,
                                             Shard(**shard))
            else:
                self._todo.insert(0, (tid, Shard(**shard)))
        self.splitter.epoch = data.get("epoch", 0)
        self._task_id_seq = data.get("task_id_seq", len(self._todo))


def grants_as_data(state: dict) -> dict:
    """``dump_state`` with each cached grant ``(task_id, Shard, epoch)``
    as ``[task_id, shard fields, epoch]``, which msgpack can carry."""
    return dict(state, fetch_tokens=[
        [token, [got[0], dataclasses.asdict(got[1]), got[2]]]
        for token, got in state.get("fetch_tokens", [])])


def _grant_of_data(got):
    if isinstance(got, list) and len(got) == 3 and isinstance(got[1], dict):
        return got[0], Shard(**got[1]), got[2]
    return got


class TaskManager(JournalBound):
    """Every dataset of one job and the timeout reassign loop."""

    def __init__(self, task_timeout: float = 1800.0):
        self._lock = threading.Lock()
        self._datasets: Dict[str, DatasetManager] = {}
        self._task_timeout = task_timeout
        self._worker_last_task: Dict[int, float] = {}
        self._fetch_tokens = BoundedTokenCache()  # retried fetches
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def new_dataset(self, splitter: DatasetSplitter,
                    params: Optional[dict] = None) -> None:
        with self._lock:
            if splitter.dataset_name not in self._datasets:
                self._datasets[splitter.dataset_name] = DatasetManager(
                    splitter, self._task_timeout, params=params)
                self._jrec("task.dataset", params=dict(params or {}))
                logger.info("task manager: registered dataset %s",
                            splitter.dataset_name)

    def has_dataset(self, name: str) -> bool:
        with self._lock:
            return name in self._datasets

    def queue_depths(self) -> Tuple[int, int]:
        """(doing, todo) task counts over every dataset."""
        with self._lock:
            return (sum(len(ds._doing) for ds in self._datasets.values()),
                    sum(len(ds._todo) for ds in self._datasets.values()))

    def get_task(self, dataset_name: str, worker_id: int, token: str = ""):
        """The next task; a retried fetch with the same ``token`` gets the
        same task instead of stranding a second shard."""
        with self._lock:
            cached = self._fetch_tokens.get(token)
            if cached is not None:
                return cached
            ds = self._datasets.get(dataset_name)
            if ds is None:
                return None
            self._worker_last_task[worker_id] = time.monotonic()
            got = ds.get_task(worker_id)
            if got is not None:
                self._fetch_tokens.put(token, got)
                self._jrec("task.grant", dataset=dataset_name,
                           worker=worker_id, token=token, task_id=got[0])
            return got

    def report_task_result(self, dataset_name: str, task_id: int,
                           success: bool) -> None:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is not None:
                ds.report_task_result(task_id, success)
                self._jrec("task.report", dataset=dataset_name,
                           task_id=task_id, success=success)

    def recover_worker_tasks(self, worker_id: int) -> int:
        with self._lock:
            n = sum(ds.recover_worker_tasks(worker_id)
                    for ds in self._datasets.values())
            if n:
                self._jrec("task.recover", worker=worker_id)
            return n

    def requeue_tasks(self, dataset_name: str, task_ids: List[int]) -> int:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.requeue_tasks(task_ids) if ds is not None else 0

    def rearm_doing(self) -> None:
        with self._lock:
            for ds in self._datasets.values():
                ds.rearm_doing()

    def dataset_completed(self, dataset_name: str) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.completed() if ds is not None else True

    def all_completed(self) -> bool:
        with self._lock:
            return bool(self._datasets) and all(
                ds.completed() for ds in self._datasets.values())

    def checkpoint_dataset(self, dataset_name: str) -> str:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            return ds.checkpoint() if ds is not None else ""

    def restore_dataset(self, dataset_name: str, content: str) -> bool:
        with self._lock:
            ds = self._datasets.get(dataset_name)
            if ds is None or not content:
                return False
            ds.restore(content)
            self._jrec("task.restore", dataset=dataset_name,
                       content=content)
            return True

    def dump_state(self) -> dict:
        with self._lock:
            datasets = {
                name: {"params": dict(ds.params),
                       "cursor": ds.checkpoint(),
                       "completed": sorted(ds._completed_ids),
                       "dispatched": ds._dispatched,
                       "splitter_offset": getattr(ds.splitter, "_offset",
                                                  None)}
                for name, ds in self._datasets.items()}
            return {"datasets": datasets,
                    "fetch_tokens": self._fetch_tokens.dump_state()}

    def load_state(self, state: dict) -> None:
        """Rebuild every dataset from its splitter params; the granted
        tasks stay doing, on a timeout clock started now."""
        with self._lock:
            self._datasets.clear()
            for name, sub in state.get("datasets", {}).items():
                params = dict(sub.get("params") or {})
                if not params:
                    logger.warning("task manager: dataset %s snapshot has "
                                   "no splitter params; skipping", name)
                    continue
                ds = DatasetManager(new_dataset_splitter(**params),
                                    self._task_timeout, params=params)
                if sub.get("cursor", ""):
                    ds.restore(sub["cursor"], keep_doing=True)
                ds._completed_ids = set(sub.get("completed", []))
                ds._dispatched = int(sub.get("dispatched", 0))
                offset = sub.get("splitter_offset")
                if offset is not None and hasattr(ds.splitter, "_offset"):
                    ds.splitter._offset = offset
                self._datasets[name] = ds
            self._fetch_tokens.load_state(
                [[t, _grant_of_data(got)]
                 for t, got in state.get("fetch_tokens", [])])

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._reassign_loop,
                                            name="task-reassign", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def reassign_once(self) -> Dict[str, List[int]]:
        """One pass of the loop: the re-queued task ids by dataset."""
        moved = {}
        with self._lock:
            for name, ds in self._datasets.items():
                ids = ds.reassign_timeout_tasks()
                if ids:
                    moved[name] = ids
                    self._jrec("task.requeue", dataset=name, task_ids=ids)
                    logger.warning("task manager: re-queued %d timed-out "
                                   "tasks of %s", len(ids), name)
        return moved

    def _reassign_loop(self) -> None:
        while not self._stop.wait(REASSIGN_INTERVAL_S):
            self.reassign_once()
