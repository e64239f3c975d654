"""``torch.distributed`` from the agent's env contract — the port's
counterpart of ``dlrover_tpu/common/jax_env.py:75``
``initialize_distributed_from_env``.

The reference brings up ``jax.distributed`` from ``DLROVER_TPU_COORDINATOR``,
``DLROVER_TPU_NUM_PROCESSES`` and ``DLROVER_TPU_PROCESS_ID``.  The port calls
``torch.distributed.init_process_group`` from the same three variables
(``tcp://<coordinator>``, world size, rank).  With a coordinator the group
comes up even at world size 1, so that one process under the agent runs
the same collectives as many (the reference's ``jax.distributed`` skips
that case).  A world of several processes without a coordinator raises: it
would train N unrelated models.

The backend is a fixed rule, logged, and never a fallback:

- ``nccl`` when every local process has a card of its own;
- ``gloo`` on the CPU, and when the host's processes share one card (NCCL
  refuses two ranks on one device).

The checkpoint's cross-rank agreement always runs on a ``gloo`` group of
host integers (:func:`host_group`): the default group when it is ``gloo``,
else a second group over the same ranks.  A loopback coordinator
(``127.x.x.x``, ``localhost``) means a world on one host: unless the caller
set them, ``GLOO_SOCKET_IFNAME`` and ``NCCL_SOCKET_IFNAME`` are then
``lo``, so that neither backend looks for another interface.

A mesh's process groups (``parallel/mesh.py``) are made when
``accelerate`` first builds that mesh over the group, by every rank in
one order, and kept for the group's life: :func:`generation` names the
group they belong to.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.device import (
    DeviceLike,
    process_device,
    shares_one_card,
)
from dlrover_tpu_torch.common.log import logger

#: Seconds a collective (and the rendezvous) may wait for a peer before it
#: raises; a dead peer must not hang its survivors for ever.
TIMEOUT_ENV = "DLROVER_TPU_DIST_TIMEOUT_S"
DEFAULT_TIMEOUT_S = 600.0

_host_group = None
_generation = 0


def timeout() -> datetime.timedelta:
    try:
        secs = float(os.environ.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    except ValueError:
        secs = DEFAULT_TIMEOUT_S
    return datetime.timedelta(seconds=secs)


def choose_backend(device: torch.device) -> str:
    """``nccl`` when every local process has a card of its own, else
    ``gloo`` (the CPU, or processes sharing one card)."""
    if device.type != "cuda" or shares_one_card():
        return "gloo"
    return "nccl"


def initialize_distributed_from_env(device: DeviceLike = None) -> bool:
    """Bring up the process group from the env contract; ``True`` when one
    is up (this call's or an earlier one's).  ``device`` is what the
    process trains on (``None``: its card)."""
    if dist.is_initialized():
        return True
    coordinator = env_utils.get_coordinator()
    nproc = env_utils.get_num_processes()
    if not coordinator:
        if nproc > 1:
            raise ValueError(
                f"{env_utils.NodeEnv.NUM_PROCESSES}={nproc} but "
                f"{env_utils.NodeEnv.COORDINATOR_ADDR} is not set: the "
                "processes could not find each other")
        return False
    host = coordinator.rsplit(":", 1)[0]
    if host == "localhost" or host.startswith("127."):
        for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
            os.environ.setdefault(var, "lo")
    dev = process_device(device)
    backend = choose_backend(dev)
    rank = env_utils.get_process_id()
    logger.info(
        "torch.distributed: rank %d/%d on %s over %s (tcp://%s; %s)", rank,
        nproc, dev, backend, coordinator,
        "one card per local process" if backend == "nccl" else
        "CPU tensors" if dev.type == "cpu" else
        "the host's processes share one card")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=nproc, rank=rank, timeout=timeout())
    global _host_group, _generation
    _host_group = (dist.group.WORLD if backend == "gloo"
                   else dist.new_group(backend="gloo", timeout=timeout()))
    _generation += 1
    return True


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def generation() -> int:
    """Which process group this is: it grows by one at each bring-up."""
    return _generation


def host_group():
    """The ``gloo`` group for host integers, or ``None`` without a group."""
    return _host_group if dist.is_initialized() else None


def agreeing(num_processes: int) -> bool:
    """True when cross-rank agreement applies: a group is up and it is
    the world of ``num_processes`` the caller was configured for."""
    return num_processes > 1 and dist.is_initialized() \
        and dist.get_world_size() == num_processes


def allgather_ints(value: int) -> List[int]:
    """Every rank's ``value`` (a collective over :func:`host_group`)."""
    t = torch.tensor([int(value)], dtype=torch.int64)
    out = [torch.zeros_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=host_group())
    return [int(x.item()) for x in out]


def shutdown() -> None:
    """Destroy the process group (and the host group with it)."""
    global _host_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
_generation = 0


def group_backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None
