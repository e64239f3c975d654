"""Device resolution — the port's counterpart of ``dlrover_tpu/common/
jax_env.py`` ``ensure_platform``: the reference pins its JAX platform, the
port pins the torch device every entry point runs on.

The port is written for the CUDA card.  ``resolve_device()`` with no
argument means ``cuda`` and raises on a host without one; it never drops to
the CPU on its own.  The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do: there every kernel wrapper runs its
plain PyTorch version.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None``/``"cuda"``/``"cuda:N"`` -> the CUDA device (raises when
    CUDA is unavailable); ``"cpu"`` -> the CPU; anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dlrover_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(
        f"unsupported device {device!r}: expected 'cuda' or 'cpu'"
    )

