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

This slice runs on one card (a mesh of ``dp=1``).  Every other mesh axis,
the other remat policies, optimizer offload, fp8, quantised gradients,
frozen (LoRA) parameters and the strategy search raise
``NotImplementedError`` naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device

MULTICARD_SLICE = "the multi-card training slice of the port (see ROADMAP.md)"
LATER_SLICE = "a later training slice of the port (see ROADMAP.md)"
MESH_AXES = ("pp", "dp", "fsdp", "ep", "tp")


@dataclasses.dataclass
class Strategy:
    """One point of the reference's strategy space.  ``mesh`` maps axis
    names (``pp``, ``dp``, ``fsdp``, ``ep``, ``tp``) to sizes; every
    axis is 1 on one card."""

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


def check_strategy(strategy: Strategy) -> None:
    """Raise for what one card in this slice does not run."""
    for axis, size in strategy.mesh.items():
        if axis not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        if size != 1:
            raise NotImplementedError(
                f"mesh {axis}={size}: data, FSDP, tensor, pipeline and "
                f"expert parallelism come with {MULTICARD_SLICE}"
            )
    if strategy.remat not in ("none", "block"):
        raise NotImplementedError(
            f"remat={strategy.remat!r}: only 'none' and the model's "
            f"per-block remat ('block') are ported; the other policies come "
            f"with {LATER_SLICE}"
        )
    for flag, what in (("offload_opt", "optimizer-state offload"),
                       ("fp8", "fp8 projections"),
                       ("quant_grads", "int8 gradient reduction")):
        if getattr(strategy, flag):
            raise NotImplementedError(
                f"Strategy({flag}=True): {what} comes with {LATER_SLICE}"
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


def _build_train_step(loss_fn: Callable, strategy: Strategy,
                      device: torch.device) -> Callable:
    A = strategy.grad_accum

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
        gnorm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                               for g in grads))
        opt = state["opt_state"]
        opt.step()
        opt.zero_grad(set_to_none=True)
        state["step"] += 1
        return state, {"loss": loss_sum / A, "grad_norm": gnorm}

    return train_step


def accelerate(*, loss_fn: Callable, init_fn: Callable, optimizer: Callable,
               sample_batch: Any,
               strategy: Union[str, Strategy] = "auto",
               param_specs: Any = None,
               loss_fn_builder: Optional[Callable] = None,
               frozen: Any = None,
               device: DeviceLike = None) -> AcceleratedJob:
    """Build the one-card train step.

    ``loss_fn(params, batch) -> scalar``; ``init_fn(generator) -> params``
    (fp32 masters); ``optimizer`` a factory from ``dlrover_tpu_torch.optim``
    (``adamw(lr)``, ``adam8bit(lr)``); ``sample_batch`` a dict of arrays with the global batch
    dim.  ``param_specs`` may be ``None`` or ``"planner"``: on one card
    every parameter lies whole on the card either way."""
    if isinstance(strategy, str):
        raise NotImplementedError(
            f"strategy={strategy!r}: the strategy search comes with "
            f"{MULTICARD_SLICE}; pass a Strategy"
        )
    check_strategy(strategy)
    if param_specs not in (None, "planner"):
        raise NotImplementedError(
            f"explicit param_specs (sharded layouts) come with "
            f"{MULTICARD_SLICE}"
        )
    if frozen is not None:
        raise NotImplementedError(
            f"frozen parameters (LoRA) come with {LATER_SLICE}"
        )
    if strategy.remat == "block" and loss_fn_builder is None:
        raise ValueError(
            "Strategy.remat='block' requires accelerate(loss_fn_builder=...)"
            " to set the model's per-block remat (e.g. cfg.remat_block=True)"
        )
    for name, arr in sample_batch.items():
        if np.shape(arr)[0] % strategy.grad_accum:
            raise ValueError(
                f"batch[{name!r}] dim 0 ({np.shape(arr)[0]}) is not a "
                f"multiple of grad_accum={strategy.grad_accum}"
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
    )
