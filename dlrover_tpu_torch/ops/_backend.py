"""The reference's ``backend=`` and ``interpret=`` keywords on the port's ops.

The reference's ``rmsnorm``, ``softmax_cross_entropy`` and
``flash_attention`` (``dlrover_tpu/ops/``) name three values: ``None``
picks the Pallas kernel on a TPU and the plain version elsewhere,
``"pallas"`` the kernel, ``"reference"`` the plain version.
``interpret=True`` runs the Pallas kernel in JAX's interpreter.

Here ``"pallas"`` launches the CUDA kernel and raises for a tensor that is
not on a CUDA device; ``"reference"`` runs the plain version on either
device; ``None`` is each op's own device choice (the kernel for a CUDA
tensor, the plain version for a CPU tensor), taken before this module is
asked.  Nothing falls back from one to the other.  ``interpret=True`` has
no CUDA meaning and raises.  ``quant.py`` keeps its own names.
"""

from __future__ import annotations

from typing import Optional

import torch

KERNEL = "pallas"
PLAIN = "reference"


def check_interpret(interpret: bool, name: str) -> None:
    if interpret:
        raise ValueError(
            f"{name}(interpret=True) runs a Pallas kernel in JAX's "
            "interpreter, which has no CUDA meaning; pass "
            "backend='reference' for the plain version"
        )


def use_kernel(backend: Optional[str], interpret: bool, t: torch.Tensor,
               name: str) -> bool:
    """Whether ``name`` launches its CUDA kernel on ``t`` for an explicit
    ``backend`` (else it runs its plain version); raises ``ValueError`` for
    ``interpret=True``, a ``backend`` other than ``"pallas"`` and
    ``"reference"``, and ``"pallas"`` on a tensor off the card."""
    check_interpret(interpret, name)
    if backend == PLAIN:
        return False
    if backend != KERNEL:
        raise ValueError(
            f"{name}: backend must be None, 'pallas' or 'reference', got "
            f"{backend!r}"
        )
    if t.device.type != "cuda":
        raise ValueError(
            f"{name}(backend='pallas') launches the CUDA kernel; the "
            f"tensor lies on {t.device}"
        )
    return True
