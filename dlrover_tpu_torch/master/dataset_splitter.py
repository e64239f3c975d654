"""Dataset splitters — the port's own copy of
``dlrover_tpu/master/dataset_splitter.py`` (``Shard``, ``DatasetSplitter``
``:26``, ``TableDatasetSplitter`` ``:42``, ``TextDatasetSplitter`` ``:55``,
``StreamingDatasetSplitter`` ``:86``, ``new_dataset_splitter`` ``:114``).

A shard is an index range ``[start, end)``, with its record indices when
the text splitter shuffles them; the task manager hands shards out as
tasks and re-queues those of failed workers.  The text splitter shuffles
with ``random.Random(seed + epoch)``, the same calls in the same order as
the reference, so both packages carve the same shards.
"""

from __future__ import annotations

import abc
import dataclasses
import random
from typing import List, Optional


@dataclasses.dataclass
class Shard:
    name: str
    start: int
    end: int
    record_indices: Optional[List[int]] = None


class DatasetSplitter(abc.ABC):
    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1):
        self.dataset_name = dataset_name
        self.dataset_size = dataset_size
        self.shard_size = shard_size
        self.num_epochs = num_epochs
        self.epoch = 0

    @abc.abstractmethod
    def create_shards(self) -> List[Shard]: ...

    def epoch_finished(self) -> bool:
        return self.epoch >= self.num_epochs


class TableDatasetSplitter(DatasetSplitter):
    """Contiguous range shards, one epoch a call."""

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        return [Shard(f"{self.dataset_name}-e{self.epoch}-{i}", start,
                      min(start + self.shard_size, self.dataset_size))
                for i, start in enumerate(
                    range(0, self.dataset_size, self.shard_size))]


class TextDatasetSplitter(DatasetSplitter):
    """Shards carrying their record indices, shuffled per epoch with
    ``seed + epoch`` (a restarted master carves the same shards)."""

    def __init__(self, dataset_name: str, dataset_size: int, shard_size: int,
                 num_epochs: int = 1, shuffle: bool = False, seed: int = 0):
        super().__init__(dataset_name, dataset_size, shard_size, num_epochs)
        self.shuffle = shuffle
        self._seed = seed

    def create_shards(self) -> List[Shard]:
        self.epoch += 1
        indices = list(range(self.dataset_size))
        if self.shuffle:
            random.Random(self._seed + self.epoch).shuffle(indices)
        shards = []
        for i, start in enumerate(range(0, self.dataset_size,
                                        self.shard_size)):
            end = min(start + self.shard_size, self.dataset_size)
            shards.append(Shard(f"{self.dataset_name}-e{self.epoch}-{i}",
                                start, end,
                                record_indices=indices[start:end]))
        return shards


class StreamingDatasetSplitter(DatasetSplitter):
    """An unbounded stream: ``fetch_batch`` shards a call from a moving
    offset; it never finishes an epoch."""

    def __init__(self, dataset_name: str, shard_size: int,
                 start_offset: int = 0, fetch_batch: int = 8):
        super().__init__(dataset_name, dataset_size=-1,
                         shard_size=shard_size, num_epochs=1)
        self._offset = start_offset
        self._fetch_batch = fetch_batch

    def create_shards(self) -> List[Shard]:
        shards = []
        for _ in range(self._fetch_batch):
            shards.append(Shard(f"{self.dataset_name}-s{self._offset}",
                                self._offset,
                                self._offset + self.shard_size))
            self._offset += self.shard_size
        return shards

    def epoch_finished(self) -> bool:
        return False


def new_dataset_splitter(*, dataset_name: str, dataset_size: int,
                         shard_size: int, num_epochs: int = 1,
                         shuffle: bool = False,
                         storage_type: str = "table") -> DatasetSplitter:
    if storage_type == "text":
        return TextDatasetSplitter(dataset_name, dataset_size, shard_size,
                                   num_epochs, shuffle)
    if storage_type == "stream":
        return StreamingDatasetSplitter(dataset_name, shard_size)
    return TableDatasetSplitter(dataset_name, dataset_size, shard_size,
                                num_epochs)
