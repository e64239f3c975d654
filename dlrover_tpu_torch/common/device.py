"""Device resolution — the port's counterpart of ``dlrover_tpu/common/
jax_env.py`` ``ensure_platform``: the reference pins its JAX platform, the
port pins the torch device every entry point runs on.

The port is written for the CUDA card.  ``resolve_device()`` with no
argument means ``cuda`` and raises on a host without one; it never drops to
the CPU on its own.  The CPU is used only when the caller asks for it
(``device="cpu"``), as the tests do: there every kernel wrapper runs its
plain PyTorch version.

With several processes on one host (the agent's env contract), each
process drives ``cuda:<local_rank>`` (:func:`process_device`).  When the
host shows fewer cards than it runs local processes, they all share card
0, and the log says so: two ranks then time-slice one card's SMs.
"""

from __future__ import annotations

from typing import Union

import torch

from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.log import logger

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



def local_processes() -> int:
    """Processes this host runs: the world spread evenly over the nodes."""
    nodes = max(1, env_utils.get_node_num())
    return max(1, -(-env_utils.get_num_processes() // nodes))


def shares_one_card() -> bool:
    """True when this host's local processes outnumber its cards, so they
    all drive card 0."""
    return torch.cuda.device_count() < local_processes()


def process_device(device: DeviceLike = None) -> torch.device:
    """:func:`resolve_device`, with a bare ``cuda`` made this process's
    card: ``cuda:<local_rank>``, or ``cuda:0`` when the host's processes
    share one card.  The chosen card becomes the current device."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    lr = env_utils.get_local_rank()
    if shares_one_card():
        logger.info(
            "%d local processes share card 0 (%d card(s) on this host): "
            "local rank %d runs on cuda:0", local_processes(),
            torch.cuda.device_count(), lr)
        dev = torch.device("cuda", 0)
    else:
        dev = torch.device("cuda", lr)
    torch.cuda.set_device(dev)
    return dev
