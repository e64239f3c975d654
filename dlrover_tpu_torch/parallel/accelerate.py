"""``accelerate()`` for one card — the port's counterpart of
``dlrover_tpu/parallel/accelerate.py`` (``Strategy``, ``AcceleratedJob``,
``accelerate``, ``_build_train_step``).

Given a loss function, a parameter initialiser, an optimizer factory and a
sample batch, it returns ``train_step(state, batch) -> (state, {"loss",
"grad_norm"})`` and ``create_state(generator)``.  The step follows the
reference's ``_build_train_step``: with ``grad_accum > 1`` the batch is
split along its first dim into equal microbatches whose losses and
gradients are averaged; ``grad_norm`` is ``optax.global_norm`` of the
(averaged) gradients, taken before the update.  ``remat="block"`` is the
model's per-block remat, set by ``loss_fn_builder`` (e.g.
``cfg.remat_block=True``), so the step adds no outer checkpoint.

The state is ``{"params", "opt_state", "step"}`` as in the reference.
PyTorch updates in place: ``params`` is the dict of fp32 master tensors,
``opt_state`` the ``torch.optim.Optimizer`` that owns their moments, and
``train_step`` returns the same dict with ``step`` advanced.

**Data parallelism across processes.**  Each process drives one device,
so the reference's ``MeshSpec(dp=len(jax.devices()))`` is
``Strategy(mesh={"dp": N})`` over the N processes of the
``torch.distributed`` group (``trainer/bootstrap.init``); an empty mesh
means the same.  Each process runs its local batch; its gradients (after
the ``grad_accum`` mean) and its loss go into one flat buffer, which one
``all_reduce`` sums and which is divided by N: the gradients are the
global batch's mean and the reported loss is the global mean.  When the
group runs ``gloo`` and the tensors lie on the card (processes that share
one card), the buffer is one page-locked host buffer: the gradients go to
it, are reduced there and come back.  ``grad_norm`` is taken after the
reduction.  A sequence of ``Strategy`` candidates is swept as the
reference sweeps them (``accelerate.py:555-580``): a candidate stands only
when it builds on every process (``_all_ok``).  With no cost model to
score them (item 5), the first candidate that stands wins, so the
reference's ``_leader_score`` has nothing to agree on yet.

``dp`` above the number of processes (several cards a process) and every
other mesh axis, the other remat policies, optimizer offload, fp8,
quantised gradients, frozen (LoRA) parameters and the strategy search
raise ``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common.constants import MODEL_ITEM, MULTICARD_ITEM
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.log import logger

MESH_AXES = ("pp", "dp", "fsdp", "ep", "tp")


@dataclasses.dataclass
class Strategy:
    """One point of the reference's strategy space.  ``mesh`` maps axis
    names (``pp``, ``dp``, ``fsdp``, ``ep``, ``tp``) to sizes; ``dp`` is
    the number of processes (absent: all of them), every other axis 1."""

    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    remat: str = "none"
    grad_accum: int = 1
    offload_opt: bool = False
    fp8: bool = False
    quant_grads: bool = False

    def describe(self) -> str:
        mesh = "x".join(f"{a}{s}" for a, s in self.mesh.items() if s > 1)
        return f"mesh={mesh or 'single'} remat={self.remat} " \
               f"accum={self.grad_accum}"


def check_strategy(strategy: Strategy, world: int = 1) -> None:
    """Raise for what a world of ``world`` processes, one device each,
    does not run."""
    for axis, size in strategy.mesh.items():
        if axis not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if axis == "dp" and size > world:
            raise NotImplementedError(
                f"mesh dp={size} over {world} process(es): more than one "
                f"device a process comes with {MULTICARD_ITEM}")
        if axis == "dp" and size != world:
            raise ValueError(
                f"mesh dp={size} does not cover the {world} processes of "
                f"the group")
        if axis != "dp" and size != 1:
            raise NotImplementedError(
                f"mesh {axis}={size}: data, FSDP, tensor, pipeline and "
                f"expert parallelism come with {MULTICARD_ITEM}"
            )
    if strategy.remat not in ("none", "block"):
        raise NotImplementedError(
            f"remat={strategy.remat!r}: only 'none' and the model's "
            f"per-block remat ('block') are ported; the other policies come "
            f"with {MULTICARD_ITEM}"
        )
    for flag, what, where in (
            ("offload_opt", "optimizer-state offload", MULTICARD_ITEM),
            ("fp8", "fp8 projections", MODEL_ITEM),
            ("quant_grads", "int8 gradient reduction", MULTICARD_ITEM)):
        if getattr(strategy, flag):
            raise NotImplementedError(
                f"Strategy({flag}=True): {what} comes with {where}"
            )
    if strategy.grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {strategy.grad_accum}")


@dataclasses.dataclass
class AcceleratedJob:
    """What :func:`accelerate` returns."""

    strategy: Strategy
    train_step: Callable  # (state, batch) -> (state, metrics)
    create_state: Callable  # (generator) -> state
    device: torch.device
    dp: int = 1  # processes the gradients are averaged over


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nested dict/list tree in the reference's order
    (dict keys sorted, as ``jax.tree_util`` flattens them)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def _to_device(batch: Dict, device: torch.device) -> Dict:
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


class _GradReducer:
    """Sum the gradients and the loss over the group with one
    ``all_reduce`` of a flat buffer, then divide by the world size.  Under
    ``gloo`` with card tensors the buffer is page-locked host memory: the
    copies to it are ordered on the card's stream, and one synchronise
    before the reduction waits for them."""

    def __init__(self, device: torch.device):
        self.device = device
        self.via_host = device.type == "cuda" \
            and dist.get_backend() == "gloo"
        self.buf: Optional[torch.Tensor] = None
        self.last_ms: Optional[float] = None  # host clock, via_host only

    def __call__(self, grads: List[torch.Tensor],
                 loss: torch.Tensor) -> torch.Tensor:
        n = sum(g.numel() for g in grads) + 1
        dtype = grads[0].dtype if grads else torch.float32
        if self.buf is None or self.buf.numel() != n \
                or self.buf.dtype != dtype:
            self.buf = (torch.empty(n, dtype=dtype, pin_memory=True)
                        if self.via_host else
                        torch.empty(n, dtype=dtype, device=self.device))
        buf, off = self.buf, 0
        if self.via_host:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
        for g in grads:
            k = g.numel()
            buf[off:off + k].copy_(g.reshape(-1), non_blocking=True)
            off += k
        buf[off:off + 1].copy_(loss.reshape(1), non_blocking=True)
        if self.via_host:
            torch.cuda.synchronize(self.device)
        dist.all_reduce(buf)
        buf.div_(dist.get_world_size())
        if self.via_host:
            self.last_ms = (time.perf_counter() - t0) * 1e3
        off = 0
        for g in grads:
            k = g.numel()
            g.copy_(buf[off:off + k].view_as(g), non_blocking=True)
            off += k
        return buf[off].to(self.device)


def _build_train_step(loss_fn: Callable, strategy: Strategy,
                      device: torch.device) -> Callable:
    A = strategy.grad_accum
    reducer = _GradReducer(device) if dist.is_initialized() else None

    def train_step(state: Dict, batch: Dict):
        params = state["params"]
        leaves = tree_leaves(params)
        batch = _to_device(batch, device)
        if A > 1:
            micro = [{k: v.reshape((A, -1) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()} for i in range(A)]
        else:
            micro = [batch]
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for mb in micro:
            loss = loss_fn(params, mb)
            loss.backward()
            loss_sum = loss_sum + loss.detach().float()
        for p in leaves:
            # A parameter the loss does not reach has a zero gradient, as
            # in JAX, so the optimizer still updates it (torch's AdamW
            # skips a None grad; it would not decay the parameter).
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in leaves]
        if A > 1:
            for g in grads:
                g.div_(A)
        loss = loss_sum / A
        metrics = {}
        if reducer is not None:
            loss = reducer(grads, loss)
            if reducer.last_ms is not None:
                metrics["reduce_ms"] = reducer.last_ms
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                               for g in grads))
        opt = state["opt_state"]
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return state, {"loss": loss, "grad_norm": gnorm, **metrics}

    return train_step


def _all_ok(ok: bool) -> bool:
    """True on every process when ``ok`` holds on every process (the
    reference's ``_all_ok``: a candidate that failed anywhere is skipped
    everywhere, or the next collective would deadlock)."""
    if dist_env.world_size() <= 1:
        return ok
    return all(dist_env.allgather_ints(1 if ok else 0))


def accelerate(*, loss_fn: Callable, init_fn: Callable, optimizer: Callable,
               sample_batch: Any,
               strategy: Union[str, Strategy, Sequence[Strategy]] = "auto",
               param_specs: Any = None,
               batch_axes: Any = None,
               devices: Any = None,
               profile_steps: int = 0,
               grad_accum: Optional[int] = None,
               search_evals: int = 10,
               cache: Any = None,
               fp8_init: Optional[Callable] = None,
               loss_fn_builder: Optional[Callable] = None,
               frozen: Any = None,
               device: DeviceLike = None) -> AcceleratedJob:
    """Build the train step of one device a process.

    ``loss_fn(params, batch) -> scalar``; ``init_fn(generator) -> params``
    (fp32 masters); ``optimizer`` a factory from ``dlrover_tpu_torch.optim``
    (``adamw(lr)``, ``adam8bit(lr)``); ``sample_batch`` a dict of arrays with the global batch
    dim (each process's batch is its ``1 / dp`` share).  ``strategy`` is a
    ``Strategy`` or a sequence of them (the candidates).  ``param_specs``
    may be ``None`` or ``"planner"``: in data parallelism every parameter
    lies whole on each device either way.  ``grad_accum``
    forces ``Strategy.grad_accum``, as in the reference.  The reference's
    ``batch_axes``, ``devices``, ``profile_steps``, ``search_evals`` and
    ``cache`` (sharding and the strategy search) and ``fp8_init`` raise
    at any value but their defaults."""
    for name, asked in (("batch_axes", batch_axes is not None),
                        ("devices", devices is not None),
                        ("profile_steps", profile_steps != 0),
                        ("search_evals", search_evals != 10),
                        ("cache", cache is not None)):
        if asked:
            raise NotImplementedError(
                f"accelerate({name}=...): sharded batches, device lists and "
                f"the strategy search come with {MULTICARD_ITEM}"
            )
    if fp8_init is not None:
        raise NotImplementedError(
            f"accelerate(fp8_init=...): fp8 comes with {MODEL_ITEM}"
        )
    if isinstance(strategy, str):
        raise NotImplementedError(
            f"strategy={strategy!r}: the strategy search comes with "
            f"{MULTICARD_ITEM}; pass a Strategy"
        )
    if param_specs not in (None, "planner"):
        raise NotImplementedError(
            f"explicit param_specs (sharded layouts) come with "
            f"{MULTICARD_ITEM}"
        )
    if frozen is not None:
        raise NotImplementedError(
            f"frozen parameters (LoRA) come with {MODEL_ITEM}"
        )
    if isinstance(strategy, Strategy):
        return _build_job(strategy, loss_fn, init_fn, optimizer,
                          sample_batch, grad_accum, loss_fn_builder, device)
    rejections: List[str] = []
    for cand in strategy:
        try:
            job = _build_job(cand, loss_fn, init_fn, optimizer, sample_batch,
                             grad_accum, loss_fn_builder, device)
        except (NotImplementedError, ValueError) as e:
            logger.info("strategy %s rejected: %s", cand.describe(), e)
            rejections.append(f"{cand.describe()}: {type(e).__name__}: {e}")
            job = None
        if not _all_ok(job is not None):
            if job is not None:
                rejections.append(f"{cand.describe()}: rejected on another "
                                  "process (see its logs)")
            continue
        logger.info("accelerate: selected %s", job.strategy.describe())
        return job
    raise RuntimeError(
        f"no viable strategy found — {len(strategy)} candidate(s) "
        f"rejected: {'; '.join(rejections) or 'none given'}")


def _build_job(strategy: Strategy, loss_fn, init_fn, optimizer,
               sample_batch, grad_accum, loss_fn_builder,
               device) -> AcceleratedJob:
    world = dist_env.world_size()
    if grad_accum is not None:
        strategy = dataclasses.replace(strategy, grad_accum=grad_accum)
    check_strategy(strategy, world)
    if strategy.remat == "block" and loss_fn_builder is None:
        raise ValueError(
            "Strategy.remat='block' requires accelerate(loss_fn_builder=...)"
            " to set the model's per-block remat (e.g. cfg.remat_block=True)"
        )
    for name, arr in sample_batch.items():
        if np.shape(arr)[0] % (strategy.grad_accum * world):
            raise ValueError(
                f"batch[{name!r}] dim 0 ({np.shape(arr)[0]}) is not a "
                f"multiple of grad_accum={strategy.grad_accum} x dp={world}"
            )
    dev = resolve_device(device)
    lfn = loss_fn_builder(strategy) if loss_fn_builder else loss_fn

    def create_state(generator: torch.Generator) -> Dict:
        params = init_fn(generator)
        leaves = tree_leaves(params)
        for p in leaves:
            if p.dtype != torch.float32 or p.device.type != dev.type:
                raise ValueError(
                    f"init_fn must give fp32 masters on {dev}, got "
                    f"{p.dtype} on {p.device}"
                )
            p.requires_grad_(True)
        return {"params": params, "opt_state": optimizer(leaves), "step": 0}

    return AcceleratedJob(
        strategy=strategy,
        train_step=_build_train_step(lfn, strategy, dev),
        create_state=create_state,
        device=dev,
        dp=world,
    )
