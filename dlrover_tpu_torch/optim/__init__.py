"""Optimizers — the port's counterparts of the optax transformations the
JAX package trains with.

An optimizer here is a factory ``params -> torch.optim.Optimizer`` over the
list of fp32 master tensors, which ``parallel.accelerate`` calls when it
creates the train state.  ``adam8bit`` (Adam with 8-bit moments) lives in
``ops/quant.py``, as the reference's does, and is exported here as the
reference's ``dlrover_tpu/optim/__init__.py`` exports it.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from dlrover_tpu_torch.ops.quant import adam8bit

OptimizerFactory = Callable[[List[torch.Tensor]], torch.optim.Optimizer]

__all__ = ["OptimizerFactory", "adam8bit", "adamw"]


def adamw(lr: float) -> OptimizerFactory:
    """``optax.adamw(lr)`` with its defaults: b1 0.9, b2 0.999, eps 1e-8,
    eps_root 0, ``weight_decay`` 1e-4 (torch's default is 1e-2) and no
    mask, so the decay applies to every parameter, norm gains and the
    embedding included.  The update runs on the fp32 masters."""

    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    return make
