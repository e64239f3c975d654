"""The worker's dynamic sharding client — the port's own copy of
``dlrover_tpu/data/sharding.py`` (``ShardingClient`` ``:19``,
``IndexShardingClient`` ``:73``) over the port's ``MasterClient``.

A worker pulls index shards from the master's task manager instead of
owning a static partition and acknowledges each one it finished; the
shards of a worker that dies before its acknowledgement go back to the
queue (at-least-once delivery).  The dataset's position is a checkpoint
string the master keeps (``checkpoint``/``restore``).
"""

from __future__ import annotations

import threading
from typing import Iterator, List

from dlrover_tpu_torch.agent.master_client import MasterClient


class ShardingClient:
    """One task is one index shard ``[start, end)``."""

    def __init__(self, client: MasterClient, dataset_name: str, *,
                 dataset_size: int, shard_size: int, num_epochs: int = 1,
                 shuffle: bool = False, storage_type: str = "table",
                 batch_size: int = 0):
        self._client = client
        self.dataset_name = dataset_name
        self._lock = threading.Lock()
        self._current_task = None
        client.report_dataset_shard_params(
            dataset_name=dataset_name, dataset_size=dataset_size,
            shard_size=shard_size, num_epochs=num_epochs, shuffle=shuffle,
            storage_type=storage_type, batch_size=batch_size)

    def fetch_task(self):
        task = self._client.get_task(self.dataset_name)
        if task.task_id < 0:
            return None
        with self._lock:
            self._current_task = task
        return task

    def report_task_done(self, task_id: int, success: bool = True) -> None:
        self._client.report_task_result(self.dataset_name, task_id,
                                        success=success)
        with self._lock:
            if self._current_task is not None \
                    and self._current_task.task_id == task_id:
                self._current_task = None

    def checkpoint(self) -> str:
        return self._client.get_shard_checkpoint(self.dataset_name)

    def restore(self, content: str) -> bool:
        return self._client.restore_shard_checkpoint(self.dataset_name,
                                                     content)


class IndexShardingClient(ShardingClient):
    """Record indices over the fetched shards: each shard is acknowledged
    once its last index was handed out."""

    def iter_indices(self) -> Iterator[int]:
        while True:
            task = self.fetch_task()
            if task is None:
                return
            yield from range(task.start, task.end)
            self.report_task_done(task.task_id)

    def iter_batches(self, batch_size: int) -> Iterator[List[int]]:
        """Fixed-size batches across shard boundaries; the partial batch
        last."""
        batch: List[int] = []
        for idx in self.iter_indices():
            batch.append(idx)
            if len(batch) == batch_size:
                yield batch
                batch = []
        if batch:
            yield batch
