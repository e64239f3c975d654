"""Fixed-global-batch elastic training — the port's own copy of
``dlrover_tpu/trainer/elastic.py`` (``resolve_grad_accum`` ``:28``,
``TrainerConfig``, ``ElasticTrainer`` ``:54`` with ``build``,
``_build_job``, ``_finish_world``, ``train_on_indices``, ``epoch`` and
``state_dict``, ``ElasticDataLoader`` ``:299``).

The user fixes the global batch once; when the world is formed with
another number of processes, the trainer keeps it by changing the
gradient accumulation, so the trajectory (effective batch, LR schedule)
does not depend on the world.  The step is the port's
``parallel.accelerate`` train step over the strategy's mesh (one device a
process; a mesh holding ``-1`` is normalized to each world), with
``param_specs=`` passed through (``"planner"``, a tree or a callable).
The data position is an ``ElasticSampler`` over the *batch group*: a
rank's share of each global batch is its index over the mesh's batch axes
(``dp``, ``fsdp``), not its global rank, so the ranks of one ``tp`` group
read the same rows.  A rebuild for a new world carries the state over:
each leaf is gathered on the old mesh and this rank's box of the new
placement is kept (the reference's ``device_put`` onto the new sharding,
``trainer/elastic.py:111-131``).

``strategy=None`` is ``"auto"``, as at the reference's ``:166-168``: the
step is then chosen by ``accelerate``'s search (``"auto"``, ``"bo"`` or a
sequence of candidates), with ``strategy_cache=`` as its cache.  The
search's sample batch is the reference's (``per-process rows x
processes``, the accumulation resolved over the processes); once the
winner is built, this rank's batch share is its index over the winner's
batch axes and each share's rows are ``global batch / shares``.  The
fingerprint holds the device count, so a rebuild at a new world size
misses the cache, searches again and caches under the new key.  A
strategy whose ``rules`` map ``"seq"`` to ``"tp"`` trains
sequence-parallel (see ``parallel/accelerate.py``).

Each process trains on its own card (``common/device.process_device``);
``devices=[...]`` may name that one device (``"cpu"`` runs the plain
versions, as the tests ask).  Refused by name: more than one device a
process (5d), ``frozen=`` (item 6), and ``reshard_live`` (the live
reshard coordinator, a host layer).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import (
    HOST_LAYERS,
    MODEL_ITEM,
    TP_COMPUTE_ITEM,
)
from dlrover_tpu_torch.common.device import process_device
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.parallel.accelerate import (
    Strategy,
    accelerate,
    resolve_mesh,
)
from dlrover_tpu_torch.parallel.mesh import batch_share
from dlrover_tpu_torch.trainer.sampler import ElasticSampler


def resolve_grad_accum(global_batch_size: int, num_processes: int,
                       max_micro_per_proc: int) -> tuple[int, int]:
    """``(micro_batch_per_proc, grad_accum)`` with ``micro * accum *
    num_processes == global_batch_size``, the accumulation growing as the
    world shrinks; raises when the global batch cannot be kept."""
    if global_batch_size % num_processes:
        raise ValueError(f"global batch {global_batch_size} not divisible "
                         f"by {num_processes} processes")
    per_proc = global_batch_size // num_processes
    accum = -(-per_proc // max_micro_per_proc)  # ceil
    while per_proc % accum:
        accum += 1
    return per_proc // accum, accum


@dataclasses.dataclass
class TrainerConfig:
    global_batch_size: int
    max_micro_batch_per_proc: int  # a process's memory ceiling
    seq_len: int = 0


def trainer_device(devices) -> torch.device:
    """The process's device: its card, or the one device ``devices``
    names."""
    if devices is None:
        return process_device(None)
    devices = list(devices)
    if len(devices) != 1:
        raise NotImplementedError(
            f"devices={devices!r}: more than one device a process comes "
            f"with {TP_COMPUTE_ITEM}")
    return process_device(devices[0])


class ElasticTrainer:
    """Owns the train step and the sampler; survives re-formed worlds."""

    def __init__(self, cfg: TrainerConfig, *, loss_fn: Callable,
                 init_fn: Callable, optimizer,
                 fetch_batch: Callable[[np.ndarray], Any],
                 dataset_size: int, strategy: Any = None,
                 sampler_seed: int = 0, devices=None,
                 strategy_cache: Any = None, param_specs: Any = None,
                 frozen: Any = None):
        if frozen is not None:
            raise NotImplementedError(
                f"frozen= (LoRA's frozen base) comes with {MODEL_ITEM}")
        if strategy is None:
            strategy = "auto"
        self.cfg = cfg
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.optimizer = optimizer
        self.fetch_batch = fetch_batch
        self.dataset_size = dataset_size
        self.base_strategy = strategy
        self.strategy_cache = strategy_cache
        self.param_specs = param_specs
        self.sampler_seed = sampler_seed
        self.device = trainer_device(devices)
        self.job = None  # AcceleratedJob
        self.state = None
        self.sampler: Optional[ElasticSampler] = None
        self.num_processes = 0
        self.process_id = 0
        self.grad_accum = 1
        self.micro_batch = 0
        self.share, self.shares = 0, 1  # this rank's share of a batch
        self._rng_seed = 0

    # -- world (re)formation --------------------------------------------------
    def build(self, num_processes: int, process_id: int) -> None:
        """Build the step for the current world; the state (on this
        process's device, placed on the new mesh) and the sampler's
        position carry over."""
        old_state, old_job = self.state, self.job
        self._build_job(num_processes, process_id)
        gen = torch.Generator(device=self.device).manual_seed(
            self._rng_seed)
        if old_state is None:
            self.state = self.job.create_state(gen)
        else:
            whole = old_job.gather_state(old_state)
            del old_state
            self.state = self.job.create_state(gen)
            self.job.load_state(self.state, whole)
        self._finish_world(num_processes, process_id)

    def _build_job(self, num_processes: int, process_id: int) -> None:
        searched = not isinstance(self.base_strategy, Strategy)
        if searched:
            # The search's candidates shard the batch differently: the
            # sample and the accumulation are the reference's, over the
            # processes; the shares follow the winner.
            self.share, self.shares = process_id, num_processes
            where = f"a mesh chosen by strategy={self.base_strategy!r}"
        else:
            spec = resolve_mesh(self.base_strategy.mesh, num_processes)
            self.share, self.shares = batch_share(spec, process_id)
            where = f"mesh {spec.describe()}"
        self.micro_batch, self.grad_accum = resolve_grad_accum(
            self.cfg.global_batch_size, self.shares,
            self.cfg.max_micro_batch_per_proc)
        per_proc = self.micro_batch * self.grad_accum
        sample_local = self.fetch_batch(np.arange(per_proc, dtype=np.int64))
        # accelerate() takes the batch with the global leading dim.
        sample_global = {
            k: np.repeat(np.asarray(v), self.shares,
                         axis=0)[: per_proc * self.shares]
            for k, v in sample_local.items()}
        self.job = accelerate(
            loss_fn=self.loss_fn, init_fn=self.init_fn,
            optimizer=self.optimizer, sample_batch=sample_global,
            strategy=self.base_strategy, grad_accum=self.grad_accum,
            param_specs=self.param_specs,
            cache=self.strategy_cache if searched else None,
            device=self.device)
        if searched:
            self.share, self.shares = self.job.batch_rank
            if self.cfg.global_batch_size % (self.shares * self.grad_accum):
                raise ValueError(
                    f"global batch {self.cfg.global_batch_size} is not a "
                    f"multiple of {self.shares} share(s) x accum "
                    f"{self.grad_accum} on the chosen mesh "
                    f"{self.job.mesh.describe()}")
            self.micro_batch = self.cfg.global_batch_size // (
                self.shares * self.grad_accum)
            where = f"mesh {self.job.mesh.describe()} (searched)"
        logger.info("elastic trainer build: %d procs on %s (batch share %d "
                    "of %d), micro=%d accum=%d (global batch %d preserved)",
                    num_processes, where, self.share, self.shares,
                    self.micro_batch, self.grad_accum,
                    self.cfg.global_batch_size)

    def _finish_world(self, num_processes: int, process_id: int) -> None:
        if self.sampler is None:
            self.sampler = ElasticSampler(
                self.dataset_size,
                batch_size_per_process=self.micro_batch * self.grad_accum,
                num_processes=self.shares, process_id=self.share,
                seed=self.sampler_seed)
        else:
            self.sampler = self.sampler.reshard(self.shares, self.share)
        self.num_processes = num_processes
        self.process_id = process_id

    def reshard_live(self, num_processes: int, process_id: int):
        raise NotImplementedError(
            "reshard_live (a resize moved through the reshard planner and "
            f"mover, reshard/coordinator.py) comes with {HOST_LAYERS}; a "
            "re-formed world restarts the workers and restores from the "
            "flash checkpoint")

    # -- stepping -------------------------------------------------------------
    @property
    def step(self) -> int:
        return 0 if self.state is None else int(self.state["step"])

    def train_on_indices(self, indices: np.ndarray):
        self.state, metrics = self.job.train_step(self.state,
                                                  self.fetch_batch(indices))
        return metrics

    def epoch(self) -> Iterator[dict]:
        """The rest of the current epoch, a step's metrics at a time."""
        for indices in self.sampler:
            yield self.train_on_indices(indices)

    # -- checkpointable trainer state -----------------------------------------
    def state_dict(self) -> dict:
        return {"sampler": self.sampler.state_dict() if self.sampler else {},
                "global_batch_size": self.cfg.global_batch_size}

    def load_state_dict(self, sd: dict) -> None:
        if self.sampler is not None and sd.get("sampler"):
            self.sampler.load_state_dict(sd["sampler"])


class ElasticDataLoader:
    """An index-stream loader whose batch size the master may tune: a
    newer ``ParallelConfig`` version's ``dataloader["batch_size"]`` is
    applied when an epoch starts (mid-epoch it would reinterpret the
    checkpointed position)."""

    def __init__(self, sampler: ElasticSampler,
                 fetch_batch: Callable[[np.ndarray], Any], *,
                 master_client=None):
        self.sampler = sampler
        self.fetch_batch = fetch_batch
        self.client = master_client
        self._config_version = -1

    def _maybe_apply_config(self) -> None:
        if self.client is None:
            return
        try:
            cfg = self.client.get_parallel_config()
        except Exception as e:  # noqa: BLE001
            logger.debug("parallel-config poll failed: %s", e)
            return
        if cfg.version <= self._config_version:
            return
        if self.sampler.completed_steps != 0:
            return
        self._config_version = cfg.version
        bs = cfg.dataloader.get("batch_size")
        if bs and int(bs) != self.sampler.batch_size_per_process:
            logger.info("dataloader: master tuned batch size %d -> %d",
                        self.sampler.batch_size_per_process, int(bs))
            self.sampler.batch_size_per_process = int(bs)

    def __iter__(self):
        """One epoch."""
        self._maybe_apply_config()
        for indices in self.sampler:
            yield self.fetch_batch(indices)
