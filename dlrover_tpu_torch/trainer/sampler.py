"""Elastic sampler — the port's own copy of ``dlrover_tpu/trainer/
sampler.py`` ``ElasticSampler`` (numpy only; it yields the reference's
indices).

A deterministic index partition over the *current* world that
re-partitions when the world is re-formed and checkpoints its position, so
a restore continues exactly where training stopped.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class ElasticSampler:
    """Deterministic, shardable, checkpointable index sampler.

    Each epoch shuffles ``dataset_size`` indices with ``seed + epoch`` (the
    same on every process), pads to a multiple of the *global* batch, then
    yields this process's slice of each global batch: process ``p`` of
    ``P`` with per-process batch ``b`` owns columns ``[p*b, (p+1)*b)``.
    """

    def __init__(self, dataset_size: int, *, batch_size_per_process: int,
                 num_processes: int = 1, process_id: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.dataset_size = dataset_size
        self.batch_size_per_process = batch_size_per_process
        self.num_processes = num_processes
        self.process_id = process_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.completed_steps = 0

    @property
    def global_batch_size(self) -> int:
        return self.batch_size_per_process * self.num_processes

    def steps_per_epoch(self) -> int:
        if self.drop_last:
            return self.dataset_size // self.global_batch_size
        return -(-self.dataset_size // self.global_batch_size)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        order = np.arange(self.dataset_size, dtype=np.int64)
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        if not self.drop_last:
            pad = (-len(order)) % self.global_batch_size
            if pad:
                order = np.concatenate([order, order[:pad]])
        return order

    def __iter__(self) -> Iterator[np.ndarray]:
        """This process's index slice of each remaining global batch of
        the current epoch."""
        order = self._epoch_order(self.epoch)
        gb = self.global_batch_size
        b = self.batch_size_per_process
        for step in range(self.completed_steps, self.steps_per_epoch()):
            gbatch = order[step * gb: (step + 1) * gb]
            if len(gbatch) < gb and self.drop_last:
                break
            lo = self.process_id * b
            # The position advances when the batch is handed out, so a
            # state_dict() taken after the step includes it.
            self.completed_steps = step + 1
            yield gbatch[lo: lo + b]
        self.epoch += 1
        self.completed_steps = 0

    def state_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "completed_steps": self.completed_steps,
            "seed": self.seed,
            "dataset_size": self.dataset_size,
        }

    def load_state_dict(self, state: dict) -> None:
        self.epoch = int(state.get("epoch", 0))
        self.completed_steps = int(state.get("completed_steps", 0))
        self.seed = int(state.get("seed", self.seed))

    def reshard(self, num_processes: int,
                process_id: int) -> "ElasticSampler":
        """A sampler over the re-formed world at the same position (exact
        while the global batch size is kept)."""
        s = ElasticSampler(
            self.dataset_size,
            batch_size_per_process=self.global_batch_size // num_processes,
            num_processes=num_processes,
            process_id=process_id,
            shuffle=self.shuffle,
            seed=self.seed,
            drop_last=self.drop_last,
        )
        s.epoch = self.epoch
        s.completed_steps = self.completed_steps
        return s
