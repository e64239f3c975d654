"""The training-loop SDK — the port's own copy of
``dlrover_tpu/trainer/trainer.py`` (``TrainingArgs`` ``:35``,
``TrainerState`` ``:76``, ``TrainerControl``, the callbacks ``:115-163``,
``build_lr_schedule`` ``:165``, ``build_optimizer`` ``:191`` and
``Trainer`` ``:209`` with ``_restore`` ``:337``, ``save`` ``:366``,
``evaluate`` ``:420`` and ``train`` ``:479``).

The step is :class:`~dlrover_tpu_torch.trainer.elastic.ElasticTrainer`'s
(the global batch kept under elasticity); eval runs the loss on the same
parameters without gradients; a kill and restore goes through the flash
checkpoint (the state from shm or storage, the sampler's position and the
loop's counters from the checkpoint's meta).

The schedule is the reference's optax schedule as a plain function of the
step.  optax reads its count before the update, so update ``k`` (1-based)
runs at ``schedule(k - 1)``: with warmup the first update runs at LR 0.
The optimizer (:class:`ScheduledAdamW`) sets that LR from its own step
count, which the checkpoint carries, so a restore resumes the schedule
exactly.  ``max_grad_norm > 0`` clips as ``optax.clip_by_global_norm``
does: gradients whose global norm is below the bound are left alone,
others become ``g / norm * max_norm``; the ``grad_norm`` reported is the
norm before clipping.  Over a sharded state the norm is the global one
(``accelerate`` hands it to the optimizer's ``grad_norm_fn``).

``TrainingArgs(layout_planner=True)`` places the parameters with the
layout planner (``param_specs="planner"``), as the reference does; the
strategy's mesh may hold one ``-1``, filled at each world's build.  Eval
runs each rank's share of the eval batch by its place in the batch group
(the ranks of one ``tp`` group read the same rows) on the gathered
parameters.

``strategy=None`` is the search (``"auto"``); with a ``master_client``
the trainer keeps its winners in the master's KV store
(:class:`~dlrover_tpu_torch.parallel.strategy_search.MasterStrategyCache`,
as the reference's ``:275-297``), so a worker relaunched on a fresh host
skips the search.

Refused by name: ``op_metrics_every > 0`` (``utils/op_metrics``, a host
layer), ``frozen=`` (item 6), and what :class:`ElasticTrainer` refuses.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common.constants import HOST_LAYERS, MODEL_ITEM
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.parallel.mesh import stepping
from dlrover_tpu_torch.trainer.elastic import ElasticTrainer, TrainerConfig


# -- arguments, state, control ------------------------------------------------

@dataclasses.dataclass
class TrainingArgs:
    """The loop's settings (the reference's, field for field)."""

    global_batch_size: int = 32
    max_micro_batch_per_proc: int = 32
    max_steps: int = 0  # wins when > 0, else num_epochs
    num_epochs: int = 1
    learning_rate: float = 3e-4
    lr_schedule: str = "cosine"  # cosine | linear | constant
    warmup_steps: int = 0
    min_lr_ratio: float = 0.1
    weight_decay: float = 0.0
    max_grad_norm: float = 0.0  # 0: no clipping
    logging_steps: int = 10
    eval_steps: int = 0
    save_steps: int = 0
    ckpt_dir: str = ""
    job_name: str = ""  # the shm arena's namespace; from ckpt_dir if ""
    persist_every_n_saves: int = 1  # 1: every save goes to storage
    eval_batch_per_proc: int = 0  # 0: the train micro batch x accum
    seed: int = 0
    early_stopping_patience: int = 0  # evals without improvement; 0: off
    greater_is_better: bool = False
    layout_planner: bool = False
    op_metrics_every: int = 0


@dataclasses.dataclass
class TrainerState:
    """The loop's counters and history; the counters ride the checkpoint's
    meta, so a restore resumes the cadences."""

    step: int = 0
    epoch: int = 0
    samples_seen: int = 0
    best_metric: Optional[float] = None
    evals_since_best: int = 0
    saves: int = 0
    log_history: List[dict] = dataclasses.field(default_factory=list)

    def to_meta(self) -> dict:
        return {"step": self.step, "epoch": self.epoch,
                "samples_seen": self.samples_seen,
                "best_metric": self.best_metric,
                "evals_since_best": self.evals_since_best,
                "saves": self.saves}

    def load_meta(self, meta: dict) -> None:
        self.step = int(meta.get("step", 0))
        self.epoch = int(meta.get("epoch", 0))
        self.samples_seen = int(meta.get("samples_seen", 0))
        bm = meta.get("best_metric")
        self.best_metric = None if bm is None else float(bm)
        self.evals_since_best = int(meta.get("evals_since_best", 0))
        self.saves = int(meta.get("saves", 0))


@dataclasses.dataclass
class TrainerControl:
    should_stop: bool = False
    should_save: bool = False
    should_evaluate: bool = False


class TrainerCallback:
    """Hooks; each may change ``control``."""

    def on_train_begin(self, args, state, control) -> None: ...

    def on_step_end(self, args, state, control, metrics: dict) -> None: ...

    def on_log(self, args, state, control, logs: dict) -> None: ...

    def on_evaluate(self, args, state, control, metrics: dict) -> None: ...

    def on_save(self, args, state, control) -> None: ...

    def on_epoch_end(self, args, state, control) -> None: ...

    def on_train_end(self, args, state, control) -> None: ...


class LoggingCallback(TrainerCallback):
    def on_log(self, args, state, control, logs) -> None:
        logger.info("step %d | %s", state.step, " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in logs.items()))


class EarlyStoppingCallback(TrainerCallback):
    """Stops after ``args.early_stopping_patience`` evals without
    improvement."""

    def on_evaluate(self, args, state, control, metrics) -> None:
        if args.early_stopping_patience <= 0:
            return
        if state.evals_since_best >= args.early_stopping_patience:
            logger.info("early stop: no improvement in %d evals",
                        state.evals_since_best)
            control.should_stop = True


# -- schedule and optimizer ---------------------------------------------------

def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule(init, end, steps)``."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def build_lr_schedule(args: TrainingArgs,
                      total_steps: int) -> Callable[[int], float]:
    """Warmup then decay, as the reference's optax schedule: ``step ->
    LR``.  The decay after a warmup sees ``step - warmup_steps``
    (``optax.join_schedules``); the cosine floors at ``min_lr_ratio`` x
    the peak."""
    peak = args.learning_rate
    floor = peak * args.min_lr_ratio
    decay_steps = max(1, total_steps - args.warmup_steps)
    alpha = args.min_lr_ratio
    if args.lr_schedule == "constant":
        def decay(count):
            return peak
    elif args.lr_schedule == "linear":
        decay = _linear(peak, floor, decay_steps)
    elif args.lr_schedule == "cosine":
        def decay(count):
            c = min(float(count), float(decay_steps))
            cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return peak * ((1 - alpha) * cosine + alpha)
    else:
        raise ValueError(f"unknown lr_schedule {args.lr_schedule!r}")
    if args.warmup_steps > 0:
        warmup = _linear(0.0, peak, args.warmup_steps)
        w = args.warmup_steps
        return lambda step: warmup(step) if step < w else decay(step - w)
    return decay


class ScheduledAdamW(torch.optim.AdamW):
    """``optax.chain(clip_by_global_norm(max_grad_norm), adamw(schedule,
    weight_decay))``: each ``step()`` clips the gradients and sets the LR
    to ``schedule(count)``, ``count`` being the updates made so far (the
    AdamW step count, which the checkpoint carries).  ``grad_norm_fn(grads)``
    (set by ``accelerate`` over a sharded state) gives the global norm the
    clipping uses; without it the norm is taken over ``grads``."""

    def __init__(self, params, schedule: Callable[[int], float], *,
                 weight_decay: float = 0.0, max_grad_norm: float = 0.0):
        super().__init__(params, lr=schedule(0), betas=(0.9, 0.999),
                         eps=1e-8, weight_decay=weight_decay)
        self.schedule = schedule
        self.max_grad_norm = max_grad_norm
        self.grad_norm_fn: Optional[Callable] = None

    def count(self) -> int:
        p = self.param_groups[0]["params"][0]
        st = self.state.get(p, {})
        return int(st["step"]) if "step" in st else 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if self.max_grad_norm > 0 and grads:
            norm = (self.grad_norm_fn(grads) if self.grad_norm_fn
                    else torch.sqrt(sum(torch.sum(g.float() * g.float())
                                        for g in grads)))
            keep = norm < self.max_grad_norm
            for g in grads:
                g.copy_(torch.where(
                    keep, g, g / norm.to(g.dtype) * self.max_grad_norm))
        lr = self.schedule(self.count())
        for group in self.param_groups:
            group["lr"] = lr
        return super().step(closure)


def build_optimizer(args: TrainingArgs, total_steps: int):
    """``(optimizer factory, schedule)``: AdamW at the scheduled LR with
    ``args.weight_decay`` and, when ``args.max_grad_norm > 0``, global-norm
    clipping."""
    schedule = build_lr_schedule(args, total_steps)

    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return ScheduledAdamW(params, schedule,
                              weight_decay=args.weight_decay,
                              max_grad_norm=args.max_grad_norm)

    return make, schedule


# -- the trainer --------------------------------------------------------------

class Trainer:
    """The full loop over the elastic core.  ``fetch_batch(indices) ->
    batch`` feeds training, ``eval_fetch`` (the same contract) feeds
    :meth:`evaluate`.  ``optimizer_fn(schedule) -> optimizer factory``
    replaces the default AdamW while the schedule still resumes."""

    def __init__(self, *, loss_fn: Callable, init_fn: Callable,
                 args: TrainingArgs,
                 fetch_batch: Callable[[np.ndarray], Any],
                 dataset_size: int,
                 eval_fetch: Optional[Callable[[np.ndarray], Any]] = None,
                 eval_dataset_size: int = 0,
                 optimizer_fn: Optional[Callable[[Any], Any]] = None,
                 strategy: Any = None,
                 callbacks: Sequence[TrainerCallback] = (),
                 master_client=None,
                 step_reporter: Optional[Callable[[int], None]] = None,
                 devices=None, num_processes: int = 1, process_id: int = 0,
                 frozen: Any = None):
        refused = [
            (args.op_metrics_every > 0, "TrainingArgs(op_metrics_every>0) "
             "(per-op metrics, utils/op_metrics)", HOST_LAYERS),
            (frozen is not None, "frozen= (LoRA's frozen base)",
             MODEL_ITEM),
        ]
        for on, what, where in refused:
            if on:
                raise NotImplementedError(f"{what} comes with {where}")
        self.args = args
        self.loss_fn = loss_fn
        self.init_fn = init_fn
        self.eval_fetch = eval_fetch
        self.eval_dataset_size = eval_dataset_size
        self.client = master_client
        self.step_reporter = step_reporter
        self.state = TrainerState()
        self.control = TrainerControl()
        self.callbacks: List[TrainerCallback] = [LoggingCallback()]
        self.callbacks += list(callbacks)
        if args.early_stopping_patience > 0:
            self.callbacks.append(EarlyStoppingCallback())
        total = self.total_steps(dataset_size)
        if optimizer_fn is not None:
            self.schedule = build_lr_schedule(args, total)
            tx = optimizer_fn(self.schedule)
        else:
            tx, self.schedule = build_optimizer(args, total)
        self.optimizer = tx
        strategy_cache = None
        if master_client is not None:
            # Winners live with the master: a worker relaunched on a fresh
            # host skips the search mid-recovery.
            from dlrover_tpu_torch.parallel.strategy_search import \
                MasterStrategyCache

            strategy_cache = MasterStrategyCache(master_client)
        self.core = ElasticTrainer(
            TrainerConfig(
                global_batch_size=args.global_batch_size,
                max_micro_batch_per_proc=args.max_micro_batch_per_proc),
            loss_fn=loss_fn, init_fn=init_fn, optimizer=tx,
            fetch_batch=fetch_batch, dataset_size=dataset_size,
            strategy=strategy, sampler_seed=args.seed, devices=devices,
            strategy_cache=strategy_cache,
            param_specs="planner" if args.layout_planner else None)
        self._num_processes = num_processes
        self._process_id = process_id
        self._ckpt = None
        self._sampler_restored = False
        if args.ckpt_dir:
            from dlrover_tpu_torch.checkpoint.checkpointer import \
                FlashCheckpointer

            # The shm arena is namespaced by the checkpoint directory, so
            # two jobs on one host never share one.
            job = args.job_name or "t" + hashlib.sha1(
                args.ckpt_dir.encode()).hexdigest()[:10]
            self._ckpt = FlashCheckpointer(args.ckpt_dir, job_name=job)

    # -- sizing ---------------------------------------------------------------
    def total_steps(self, dataset_size: int) -> int:
        if self.args.max_steps > 0:
            return self.args.max_steps
        per_epoch = max(1, dataset_size // self.args.global_batch_size)
        return per_epoch * max(1, self.args.num_epochs)

    @property
    def steps_per_epoch(self) -> int:
        return max(1, self.core.dataset_size // self.args.global_batch_size)

    # -- checkpoint -----------------------------------------------------------
    def _restore(self) -> bool:
        self._sampler_restored = False
        if self._ckpt is None:
            return False
        restored = self._ckpt.load(target=self.core.state)
        if restored is None:
            return False
        self.core.state, meta = restored
        self.state.load_meta(meta.get("trainer", {}))
        if meta.get("sampler") and self.core.sampler is not None:
            self.core.sampler.load_state_dict(meta["sampler"])
            self._sampler_restored = True
        logger.info("trainer: restored step %d (epoch %d)", self.state.step,
                    self.state.epoch)
        return True

    def save(self, storage: Optional[bool] = None) -> None:
        if self._ckpt is None:
            return
        self.state.saves += 1
        if storage is None:
            storage = (self.args.persist_every_n_saves <= 1
                       or self.state.saves
                       % self.args.persist_every_n_saves == 0)
        meta = {"step": self.state.step, "trainer": self.state.to_meta(),
                "sampler": (self.core.sampler.state_dict()
                            if self.core.sampler else {})}
        self._ckpt.save(self.core.state, meta=meta, storage=storage)
        for cb in self.callbacks:
            cb.on_save(self.args, self.state, self.control)

    # -- eval -----------------------------------------------------------------
    def _global_mean(self, value: float) -> float:
        """The mean of ``value`` over the world (ranks that share their rows
        report equal values, so this is the batch group's mean)."""
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        dist.all_reduce(t, group=dist_env.host_group())
        return float(t.item()) / dist.get_world_size()

    def evaluate(self) -> Dict[str, float]:
        """The mean loss over the eval dataset."""
        if self.eval_fetch is None or self.eval_dataset_size <= 0:
            return {}
        per_proc = (self.args.eval_batch_per_proc
                    or self.core.micro_batch * self.core.grad_accum)
        share, shares = self.core.share, self.core.shares
        global_bs = per_proc * shares
        n_batches = max(1, self.eval_dataset_size // global_bs)
        params = self.core.job.params_view(self.core.state["params"])
        dev = self.core.device
        losses = []
        # A sequence-parallel loss cuts its block only on the job's mesh.
        with torch.no_grad(), stepping(self.core.job.mesh):
            for b in range(n_batches):
                lo = b * global_bs + share * per_proc
                indices = np.arange(lo, lo + per_proc, dtype=np.int64)
                indices %= self.eval_dataset_size
                batch = {k: torch.as_tensor(np.asarray(v)).to(dev)
                         for k, v in self.eval_fetch(indices).items()}
                losses.append(self._global_mean(
                    float(self.loss_fn(params, batch))))
        metrics = {"eval_loss": float(np.mean(losses))}
        metric = metrics["eval_loss"]
        better = (self.state.best_metric is None
                  or (metric > self.state.best_metric
                      if self.args.greater_is_better
                      else metric < self.state.best_metric))
        if better:
            self.state.best_metric = metric
            self.state.evals_since_best = 0
        else:
            self.state.evals_since_best += 1
        for cb in self.callbacks:
            cb.on_evaluate(self.args, self.state, self.control, metrics)
        self._log(metrics)
        return metrics

    # -- logging --------------------------------------------------------------
    def current_lr(self) -> float:
        return float(self.schedule(self.state.step))

    def _log(self, logs: dict) -> None:
        logs = dict(logs)
        logs.setdefault("lr", self.current_lr())
        logs.setdefault("epoch", self.state.epoch)
        self.state.log_history.append({"step": self.state.step, **logs})
        for cb in self.callbacks:
            cb.on_log(self.args, self.state, self.control, logs)

    # -- the loop -------------------------------------------------------------
    def train(self, resume: bool = True) -> TrainerState:
        args = self.args
        t0 = time.perf_counter()
        self.core.build(self._num_processes, self._process_id)
        logger.info("trainer: built the step and state in %.3fs",
                    time.perf_counter() - t0)
        total = self.total_steps(self.core.dataset_size)
        restored = self._restore() if resume else False
        # A checkpoint without the sampler's position (written outside
        # this trainer) fast-forwards it; a restored position stands.
        if restored and not self._sampler_restored \
                and self.core.sampler is not None:
            self.core.sampler.completed_steps = (
                self.state.step % self.steps_per_epoch)
        for cb in self.callbacks:
            cb.on_train_begin(args, self.state, self.control)

        window: List[Any] = []
        t_last = time.perf_counter()
        empty_passes = 0
        while self.state.step < total and not self.control.should_stop:
            made_progress = False
            for metrics in self.core.epoch():
                made_progress = True
                self.state.step += 1
                self.state.samples_seen += args.global_batch_size
                # The losses stay on the device until the logging
                # boundary: a float() a step would wait for every step.
                if args.logging_steps > 0:
                    window.append(metrics["loss"])
                if self.step_reporter is not None:
                    try:
                        self.step_reporter(self.state.step)
                    except Exception as e:  # noqa: BLE001
                        logger.debug("step reporter failed: %s", e)
                for cb in self.callbacks:
                    cb.on_step_end(args, self.state, self.control, metrics)
                if args.logging_steps > 0 \
                        and self.state.step % args.logging_steps == 0:
                    dt = time.perf_counter() - t_last
                    self._log({"loss": float(np.mean(
                        [float(x) for x in window])),
                        "steps_per_s": len(window) / max(dt, 1e-9)})
                    window.clear()
                    t_last = time.perf_counter()
                if (args.eval_steps > 0
                        and self.state.step % args.eval_steps == 0) \
                        or self.control.should_evaluate:
                    self.control.should_evaluate = False
                    self.evaluate()
                if (args.save_steps > 0
                        and self.state.step % args.save_steps == 0) \
                        or self.control.should_save:
                    self.control.should_save = False
                    self.save()
                if self.state.step >= total or self.control.should_stop:
                    break
            self.state.epoch += 1
            for cb in self.callbacks:
                cb.on_epoch_end(args, self.state, self.control)
            # One empty pass is normal after a restore at an epoch
            # boundary (the exhausted epoch rolls over); two mean an empty
            # partition.
            empty_passes = 0 if made_progress else empty_passes + 1
            if empty_passes >= 2:
                break
        if self._ckpt is not None:
            self.save(storage=True)
            self._ckpt.wait()
        for cb in self.callbacks:
            cb.on_train_end(args, self.state, self.control)
        return self.state
