"""The job master and its run loop — the port's own copy of
``dlrover_tpu/master/master.py`` (``JobMaster``, ``LocalJobMaster``,
``run_master_forever``).

``LocalJobMaster`` serves a one-host job: the RPC server
(``common/rpc.py``) in front of the task manager, the job manager, the
speed monitor, the KV store, the named barriers, the two rendezvous
managers and the diagnosis manager (its hang timeout from the context,
its alive nodes the training rendezvous'); a node whose heartbeats stop
is handed to ``AllReduceNodeHandlingCallback``, which tells its survivors
to rebuild the world.  The launcher starts it as ``python -m
dlrover_tpu_torch.master.main``; tests build it in process (``port=0``
binds a free port).

``state_dir=`` gives it durable control state (reference ``:140-170``,
``:238-244``; ``master/state.py``): what an earlier master journaled in
the dir is recovered at construction, every mutation is journaled before
its ack, ``prepare`` publishes the address in the dir and starts the
lease keeper, and ``stop`` journals a clean ``ha.shutdown``, so that a
tailing standby stands down instead of taking a finished job over.  The
reference's strategy generator, reshard and cell managers come with the
items that ``constants`` names; the keywords that would reach them raise
``NotImplementedError`` by name.
"""

from __future__ import annotations

import abc
import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import (
    HOST_LAYERS,
    JobExitReason,
    JobStage,
    RendezvousName,
)
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.rpc import RpcServer
from dlrover_tpu_torch.diagnosis.manager import DiagnosisManager
from dlrover_tpu_torch.master.event_callback import (
    AllReduceNodeHandlingCallback,
)
from dlrover_tpu_torch.master.kv_store import KVStoreService
from dlrover_tpu_torch.master.node_manager import LocalJobManager
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import MasterServicer
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.sync_service import SyncService
from dlrover_tpu_torch.master.task_manager import TaskManager


class JobMaster(abc.ABC):
    @abc.abstractmethod
    def prepare(self) -> None: ...

    @abc.abstractmethod
    def run(self) -> int: ...

    @abc.abstractmethod
    def stop(self) -> None: ...

    @abc.abstractmethod
    def request_stop(self, success: bool, reason: str) -> None: ...


class LocalJobMaster(JobMaster):
    def __init__(self, port: int = 0, *, job_name: str = "local-job",
                 min_nodes: int = 1, max_nodes: int = 1, node_unit: int = 1,
                 network_check: bool = False,
                 run_config: Optional[dict] = None,
                 resource_optimizer=None, state_dir: str = "",
                 cell_id: str = ""):
        refused = [(resource_optimizer is not None,
                    "resource_optimizer= (the Brain service)", HOST_LAYERS),
                   (cell_id, "cell_id= (the multi-cell control plane)",
                    HOST_LAYERS)]
        for on, what, where in refused:
            if on:
                raise NotImplementedError(f"{what} comes with {where}")
        self.job_name = job_name
        self.network_check = network_check
        self._ctx = get_context()
        self.run_config = run_config or {}
        self.stage = JobStage.INIT
        self._exit_code = 0
        self._exit_reason = ""
        self._stop_event = threading.Event()
        self.task_manager = TaskManager()
        self.job_manager = LocalJobManager(job_name)
        self.speed_monitor = SpeedMonitor()
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.rdzv_managers = {
            RendezvousName.TRAINING: ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        for mgr in self.rdzv_managers.values():
            mgr.update_rdzv_params(min_nodes, max_nodes, node_unit=node_unit)
        self.diagnosis_manager = DiagnosisManager(
            self.speed_monitor, hang_timeout_s=self._ctx.hang_timeout_s,
            alive_nodes_fn=self.rdzv_managers[
                RendezvousName.TRAINING].alive_nodes)
        self.job_manager.on_node_dead = AllReduceNodeHandlingCallback(
            self.rdzv_managers, self.speed_monitor,
            diagnosis_manager=self.diagnosis_manager).on_node_failed
        self.servicer = MasterServicer(
            task_manager=self.task_manager, job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers, kv_store=self.kv_store,
            sync_service=self.sync_service,
            speed_monitor=self.speed_monitor,
            diagnosis_manager=self.diagnosis_manager, job_context=self)
        self._server = RpcServer(port, self.servicer)
        self.state_dir = state_dir
        self._ha_journal = None
        self._ha_state = None
        self._ha_keeper = None
        if state_dir:
            from dlrover_tpu_torch.master.state import attach_state

            attach_state(self, state_dir)

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    @property
    def rpc_calls(self) -> int:
        """Requests the master's RPC server has answered."""
        return self._server.calls

    def prepare(self) -> None:
        self.task_manager.start()
        self.job_manager.start()
        self.diagnosis_manager.start()
        self._server.start()
        if self._ha_journal is not None:
            from dlrover_tpu_torch.master.state import write_addr

            write_addr(self.state_dir, self.addr)
            self._ha_journal.write_lease()
            self._ha_keeper.start()
        self.stage = JobStage.RUNNING
        logger.info("local master for %s ready on :%d", self.job_name,
                    self.port)

    def run(self) -> int:
        """Block until the job ends: a job-exit request, or every worker
        node in a terminal state."""
        try:
            while not self._stop_event.wait(2.0):
                if self.job_manager.all_workers_exited():
                    success = self.job_manager.all_workers_succeeded()
                    self.request_stop(
                        success, JobExitReason.SUCCEEDED if success
                        else JobExitReason.NODE_ERROR)
        finally:
            self.stop()
        return self._exit_code

    def request_stop(self, success: bool, reason: str) -> None:
        if self.stage == JobStage.STOPPING:
            return
        self.stage = JobStage.STOPPING
        self._exit_code = 0 if success else 1
        self._exit_reason = reason
        logger.info("master stopping: success=%s reason=%s goodput=%.3f "
                    "ckpt_agg_persist_mbps=%.0f ckpt_tensors_skipped=%d",
                    success, reason, self.speed_monitor.goodput(),
                    self.speed_monitor.ckpt_agg_persist_mbps,
                    self.speed_monitor.ckpt_tensors_skipped)
        self._stop_event.set()

    def stop(self) -> None:
        self.stage = JobStage.STOPPED
        self.task_manager.stop()
        self.job_manager.stop()
        self.diagnosis_manager.stop()
        self._server.stop()
        if self._ha_keeper is not None:
            self._ha_keeper.stop()
        if self._ha_journal is not None:
            # A clean end: a tailing standby stands down on this record.
            self._ha_journal.append("ha.shutdown",
                                    {"reason": self._exit_reason})
            self._ha_journal.close()
            logger.info("control journal: %s", self._ha_journal.stats())
        logger.info("master stopped: rpc_calls=%d", self.rpc_calls)


def run_master_forever(master: JobMaster) -> int:
    master.prepare()
    return master.run()
