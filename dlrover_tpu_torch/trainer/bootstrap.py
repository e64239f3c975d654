"""Worker-process bootstrap — the port's counterpart of
``dlrover_tpu/trainer/bootstrap.py`` (``ElasticContext``, ``init``,
``get_elastic_context``, ``_shutdown``).

The agent hands each worker its ``process_id``, ``num_processes`` and
coordinator through the environment; :func:`init` brings up
``torch.distributed`` from them (``common/dist_env.py``, the counterpart of
``jax_env.initialize_distributed_from_env``) and returns the
:class:`ElasticContext`.  It is idempotent: the first context is kept in
the module's ``_ctx``, as in the reference.

Under an agent (``DLROVER_TPU_MASTER_ADDR`` set) :func:`init` builds the
master client (``agent/master_client.build_master_client``), as the
reference does, and :meth:`ElasticContext.report_step` reports the global
step from the leader and, every 30 s, the node's step metrics.  Live
resharding (``reshard/``, ``constants.HOST_LAYERS``) is not ported:
:meth:`~ElasticContext.poll_reshard` and
:meth:`~ElasticContext.report_reshard` return ``None`` and do nothing, as
the reference's do with no client.  The chaos layer comes later:
``DLROVER_TPU_FAULTS`` is refused by name (the reference's
``worker.kill`` site in ``report_step`` has no counterpart).
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from typing import Optional

from dlrover_tpu_torch.common import dist_env
from dlrover_tpu_torch.common import env as env_utils
from dlrover_tpu_torch.common.constants import CHAOS_LAYER
from dlrover_tpu_torch.common.device import DeviceLike
from dlrover_tpu_torch.common.log import logger, set_role

#: Seconds the exit barrier waits for the other ranks.
EXIT_BARRIER_S = 60.0


class ElasticContext:
    """What a worker knows about its place in the elastic job."""

    def __init__(self):
        self.node_id = env_utils.get_node_id()
        self.node_rank = env_utils.get_node_rank()
        self.node_num = env_utils.get_node_num()
        self.process_id = env_utils.get_process_id()
        self.num_processes = env_utils.get_num_processes()
        self.local_rank = env_utils.get_local_rank()
        self.restart_count = int(
            os.environ.get("DLROVER_TPU_RESTART_COUNT", 0)
        )
        self.rdzv_round = int(os.environ.get("DLROVER_TPU_RDZV_ROUND", 0))
        self.node_role = os.environ.get("DLROVER_TPU_NODE_ROLE", "worker")
        self.job_name = env_utils.get_job_name()
        self.master_addr = env_utils.get_master_addr()
        self.client = None
        self.distributed = False
        self._last_metrics_report = 0.0

    @property
    def is_leader(self) -> bool:
        return self.process_id == 0

    def report_step(self, step: int) -> None:
        """Feed the master's speed monitor (the leader's global step) and,
        every 30 s, this node's step metrics; with no master client,
        nothing.  A failed report is logged, never raised."""
        if self.client is None:
            return
        if self.is_leader:
            try:
                self.client.report_global_step(step)
            except Exception as e:  # noqa: BLE001
                logger.warning("report_step failed: %s", e)
        if self.local_rank == 0:
            now = time.monotonic()
            if now - self._last_metrics_report > 30.0:
                self._last_metrics_report = now
                try:
                    self.client.report_diagnosis_data(
                        "step_metrics",
                        json.dumps({"step": step, "ts": time.time()}))
                except Exception as e:  # noqa: BLE001
                    logger.debug("step-metrics report failed: %s", e)

    def poll_reshard(self):
        """A pending live-reshard epoch: ``None`` until live resharding
        (``reshard/``, ``constants.HOST_LAYERS``) is ported."""
        return None

    def report_reshard(self, epoch: int, outcome=None, error: str = ""
                       ) -> None:
        """Report a live-reshard verdict: nothing until live resharding
        (``reshard/``, ``constants.HOST_LAYERS``) is ported."""


_ctx: Optional[ElasticContext] = None


def _refuse_later() -> None:
    if os.environ.get("DLROVER_TPU_FAULTS"):
        raise NotImplementedError(
            f"fault injection (DLROVER_TPU_FAULTS) comes with {CHAOS_LAYER}")


def init(connect_master: bool = True, device: DeviceLike = None
         ) -> ElasticContext:
    """Bootstrap this worker process (idempotent).  ``device`` is what the
    process trains on (``None``: its card); it picks the backend."""
    global _ctx
    _refuse_later()
    if _ctx is not None:
        return _ctx
    ctx = ElasticContext()
    set_role(f"worker-{ctx.process_id}")
    ctx.distributed = dist_env.initialize_distributed_from_env(device)
    if ctx.distributed:
        logger.info("torch.distributed up: process %d/%d (%s)",
                    ctx.process_id, ctx.num_processes,
                    dist_env.group_backend())
        atexit.register(_shutdown)
    if connect_master and ctx.master_addr:
        from dlrover_tpu_torch.agent.master_client import \
            build_master_client

        ctx.client = build_master_client(ctx.master_addr, ctx.node_id)
    _ctx = ctx
    return ctx


def get_elastic_context() -> Optional[ElasticContext]:
    return _ctx


def _shutdown() -> None:
    """A bounded exit barrier, then ``destroy_process_group``.  The barrier
    runs in a daemon thread: a worker exiting alone (a peer crashed) must
    not wait on peers that will never arrive; after the wait it skips the
    teardown and lets process exit close the sockets."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return
    done = threading.Event()

    def _sync():
        try:
            dist.barrier(group=dist_env.host_group())
            done.set()
        except Exception as e:  # noqa: BLE001 - a dead peer: skip teardown
            logger.warning("exit barrier failed: %s", e)

    threading.Thread(target=_sync, daemon=True).start()
    if done.wait(timeout=EXIT_BARRIER_S):
        try:
            dist_env.shutdown()
        except Exception as e:  # noqa: BLE001 - never mask the exit status
            logger.warning("process group teardown failed: %s", e)
