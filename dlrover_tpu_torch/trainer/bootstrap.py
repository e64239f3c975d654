"""Worker-process bootstrap for one card — the port's counterpart of
``dlrover_tpu/trainer/bootstrap.py`` (``ElasticContext``, ``init``).

The reference brings up ``jax.distributed`` from the agent's environment
and connects the master client.  This slice runs one process on one card:
:func:`init` builds the :class:`ElasticContext` from the same environment
contract and refuses a multi-process world or a master address, which come
with the launcher slice (``torch.distributed`` and the master client).
:meth:`ElasticContext.report_step` with no client is a no-op, exactly as in
the reference.
"""

from __future__ import annotations

import os

from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.log import set_role

LAUNCHER_SLICE = "the launcher slice of the port (see ROADMAP.md)"


class ElasticContext:
    """What a worker knows about its place in the elastic job."""

    def __init__(self):
        self.node_id = env_utils.get_node_id()
        self.node_rank = env_utils.get_node_rank()
        self.node_num = env_utils.get_node_num()
        self.process_id = env_utils.get_process_id()
        self.num_processes = env_utils.get_num_processes()
        self.local_rank = int(os.environ.get("DLROVER_TPU_LOCAL_RANK", 0))
        self.restart_count = int(
            os.environ.get("DLROVER_TPU_RESTART_COUNT", 0)
        )
        self.rdzv_round = int(os.environ.get("DLROVER_TPU_RDZV_ROUND", 0))
        self.node_role = os.environ.get("DLROVER_TPU_NODE_ROLE", "worker")
        self.job_name = env_utils.get_job_name()
        self.master_addr = env_utils.get_master_addr()

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    def report_step(self, step: int) -> None:
        """Feed the master's speed monitor.  This slice has no master
        client (:func:`init` refuses a master address), so, as the
        reference's with no client, it does nothing."""


def init(connect_master: bool = True) -> ElasticContext:
    """Bootstrap this worker process for one card; raises for what a
    later slice brings."""
    ctx = ElasticContext()
    if ctx.num_processes > 1:
        raise NotImplementedError(
            f"{ctx.num_processes} processes: a multi-process world "
            f"(torch.distributed) comes with {LAUNCHER_SLICE}"
        )
    if connect_master and ctx.master_addr:
        raise NotImplementedError(
            f"master address {ctx.master_addr!r} is set: the master client "
            f"comes with {LAUNCHER_SLICE}"
        )
    if os.environ.get("DLROVER_TPU_FAULTS"):
        raise NotImplementedError(
            f"fault injection (DLROVER_TPU_FAULTS) comes with "
            f"{LAUNCHER_SLICE}"
        )
    set_role(f"worker-{ctx.process_id}")
    return ctx
