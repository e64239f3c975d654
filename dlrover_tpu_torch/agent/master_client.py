"""The agent's and the worker's client of the master — the port's own copy
of ``dlrover_tpu/agent/master_client.py`` (``MasterClient``,
``build_master_client``, ``invalidate_master_client``,
``reset_master_client``): one typed wrapper a call, the retry in
``common/rpc.py``.

Reads and tokened writes are sent ``idempotent`` (a timed-out attempt is
retried), as the reference sends them; a heartbeat is not (it pops the
master's pending actions).  The client follows a failed-over master
(reference ``:27-56``): when the transport rebuilds its connections it
asks :meth:`MasterClient._resolve_addr`, which reads the ``addr`` file of
the HA state dir (``state_dir=``, default ``DLROVER_TPU_MASTER_STATE_DIR``;
every leader rewrites it), or else moves to ``standby_addr=`` (default
``DLROVER_TPU_MASTER_STANDBY_ADDR``) once the primary no longer takes a
TCP connection and the standby does.  ``journal_fetch`` streams a
primary's journal to a standby.  Not here yet, each raising
``NotImplementedError`` by name: the live reshard calls
(``get_reshard_epoch``, ``announce_reshard``, ``report_reshard``;
``constants.HOST_LAYERS``).  The data-sharding calls reach the master's
task manager and the node-check calls its network-check rendezvous.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import HOST_LAYERS
from dlrover_tpu_torch.common.env import (
    get_master_addr,
    get_master_standby_addr,
    get_master_state_dir,
    get_node_id,
)
from dlrover_tpu_torch.common.rpc import RpcClient, addr_connectable
from dlrover_tpu_torch.master.state import read_addr


class MasterClient:
    def __init__(self, master_addr: str, node_id: int = 0,
                 state_dir: str = "", standby_addr: str = ""):
        self._state_dir = state_dir or get_master_state_dir()
        self._standby_addr = standby_addr or get_master_standby_addr()
        self._client = RpcClient(master_addr,
                                 addr_provider=self._resolve_addr)
        self.node_id = node_id
        self.master_addr = master_addr

    def _resolve_addr(self) -> str:
        """The freshest master address: the state dir's ``addr`` file,
        else the standby once the primary stops taking connections, else
        the address in use."""
        if self._state_dir:
            published = read_addr(self._state_dir)
            if published:
                self.master_addr = published
                return published
        if self._standby_addr and self._standby_addr != self.master_addr \
                and not addr_connectable(self.master_addr, timeout=0.5) \
                and addr_connectable(self._standby_addr, timeout=0.5):
            self.master_addr = self._standby_addr
        return self.master_addr

    @property
    def addr(self) -> str:
        return self._client.addr

    # -- registration and lifecycle -------------------------------------------
    def register_node(self, *, node_type: str = "worker",
                      node_rank: int = -1, host: str = "",
                      agent_port: int = 0, slice_id: str = "",
                      host_id: str = "", tpu_chips: int = 0,
                      local_world_size: int = 1) -> None:
        self._client.call(m.NodeMeta(
            node_type=node_type, node_id=self.node_id, node_rank=node_rank,
            host=host, agent_port=agent_port, slice_id=slice_id,
            host_id=host_id, tpu_chips=tpu_chips,
            local_world_size=local_world_size))

    def report_node_status(self, status: str, node_type: str = "worker",
                           exit_reason: str = "",
                           restart_count: int = 0) -> None:
        self._client.call(m.ReportNodeStatus(
            node_id=self.node_id, node_type=node_type, status=status,
            exit_reason=exit_reason, restart_count=restart_count))

    def report_failure(self, error_data: str, level: str = "error",
                       restart_count: int = 0, node_rank: int = -1) -> None:
        self._client.call(m.NodeFailure(
            node_id=self.node_id, node_rank=node_rank,
            error_data=error_data, level=level,
            restart_count=restart_count))

    def report_heartbeat(self) -> List[m.DiagnosisAction]:
        resp = self._client.call(
            m.Heartbeat(node_id=self.node_id, timestamp=time.time()))
        if isinstance(resp, m.HeartbeatResponse):
            return resp.actions
        return []

    def report_job_exit(self, success: bool, reason: str = "") -> None:
        self._client.call(m.JobExitRequest(
            node_id=self.node_id, success=success, reason=reason))

    # -- rendezvous
    def join_rendezvous(self, node_rank: int, local_world_size: int,
                        rdzv_name: str = "elastic-training",
                        slice_id: str = "", attempt_id: str = "") -> int:
        resp = self._client.call(m.JoinRendezvous(
            node_id=self.node_id, node_rank=node_rank,
            local_world_size=local_world_size, rdzv_name=rdzv_name,
            slice_id=slice_id, attempt_id=attempt_id or uuid.uuid4().hex),
            idempotent=True)
        return resp.round if isinstance(resp, m.RendezvousRound) else -1

    def get_comm_world(self, rdzv_name: str = "elastic-training"
                       ) -> Tuple[int, int, Dict[int, dict], str]:
        resp = self._client.call(
            m.CommWorldRequest(node_id=self.node_id, rdzv_name=rdzv_name),
            idempotent=True)
        if isinstance(resp, m.CommWorld):
            return resp.round, resp.group, resp.world, resp.coordinator
        return -1, 0, {}, ""

    def num_nodes_waiting(self, rdzv_name: str = "elastic-training") -> int:
        resp = self._client.call(
            m.WaitingNodeNumRequest(rdzv_name=rdzv_name), idempotent=True)
        return resp.waiting_num if isinstance(resp, m.WaitingNodeNum) else 0

    # -- kv store -------------------------------------------------------------
    def kv_store_set(self, key: str, value: bytes) -> None:
        self._client.call(m.KVStoreSet(key=key, value=value),
                          idempotent=True)

    def kv_store_get(self, key: str) -> Optional[bytes]:
        resp = self._client.call(m.KVStoreGet(key=key), idempotent=True)
        if isinstance(resp, m.KVStoreValue) and resp.found:
            return resp.value
        return None

    def kv_store_wait_get(self, key: str, timeout: float = 60.0,
                          poll: float = 0.2) -> Optional[bytes]:
        deadline = time.monotonic() + timeout
        while True:
            val = self.kv_store_get(key)
            if val is not None:
                return val
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(poll, remaining))

    def kv_store_multi_set(self, kvs: Dict[str, bytes]) -> None:
        self._client.call(m.KVStoreMultiSet(kvs=kvs), idempotent=True)

    def kv_store_multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        resp = self._client.call(m.KVStoreMultiGet(keys=keys),
                                 idempotent=True)
        return resp.kvs if isinstance(resp, m.KVStoreMultiValue) else {}

    def kv_store_scan(self, prefix: str) -> Dict[str, bytes]:
        resp = self._client.call(m.KVStoreScan(prefix=prefix),
                                 idempotent=True)
        return resp.kvs if isinstance(resp, m.KVStoreScanResult) else {}

    def kv_store_delete(self, key: str) -> bool:
        resp = self._client.call(
            m.KVStoreDelete(key=key, token=uuid.uuid4().hex),
            idempotent=True)
        return bool(getattr(resp, "success", False))

    def kv_store_add(self, key: str, delta: int = 1) -> int:
        resp = self._client.call(
            m.KVStoreAdd(key=key, delta=delta, token=uuid.uuid4().hex),
            idempotent=True)
        return resp.value if isinstance(resp, m.KVStoreCount) else 0

    # -- data sharding (the master's task manager)
    def report_dataset_shard_params(self, *, dataset_name: str,
                                    dataset_size: int, shard_size: int,
                                    num_epochs: int = 1,
                                    shuffle: bool = False,
                                    storage_type: str = "table",
                                    batch_size: int = 0) -> None:
        self._client.call(m.DatasetShardParams(
            dataset_name=dataset_name, dataset_size=dataset_size,
            shard_size=shard_size, num_epochs=num_epochs, shuffle=shuffle,
            storage_type=storage_type, batch_size=batch_size))

    def get_task(self, dataset_name: str) -> m.Task:
        resp = self._client.call(m.TaskRequest(
            dataset_name=dataset_name, worker_id=self.node_id,
            token=uuid.uuid4().hex), idempotent=True)
        return resp if isinstance(resp, m.Task) else m.Task(task_id=-1)

    def report_task_result(self, dataset_name: str, task_id: int,
                           success: bool = True,
                           err_message: str = "") -> None:
        self._client.call(m.TaskResult(
            dataset_name=dataset_name, task_id=task_id,
            worker_id=self.node_id, success=success,
            err_message=err_message))

    def get_shard_checkpoint(self, dataset_name: str) -> str:
        resp = self._client.call(
            m.ShardCheckpointRequest(dataset_name=dataset_name),
            idempotent=True)
        return resp.content if isinstance(resp, m.ShardCheckpoint) else ""

    def restore_shard_checkpoint(self, dataset_name: str,
                                 content: str) -> bool:
        resp = self._client.call(
            m.ShardCheckpoint(dataset_name=dataset_name, content=content))
        return isinstance(resp, m.BaseResponse) and resp.success

    # -- the pre-flight node check (the network-check rendezvous)
    def report_network_check(self, succeeded: bool, elapsed: float,
                             round_: int = -1) -> None:
        self._client.call(m.NetworkCheckResult(
            node_id=self.node_id, succeeded=succeeded, elapsed=elapsed,
            round=round_))

    def network_ready(self) -> bool:
        resp = self._client.call(m.NetworkReadyRequest(), idempotent=True)
        return isinstance(resp, m.BaseResponse) and resp.success

    def get_fault_nodes(self) -> Tuple[List[int], str]:
        resp = self._client.call(m.FaultNodeRequest(), idempotent=True)
        if isinstance(resp, m.FaultNodes):
            return resp.nodes, resp.reason
        return [], ""

    def get_stragglers(self) -> Tuple[List[int], dict]:
        nodes, times, _ = self.get_stragglers_full()
        return nodes, times

    def get_stragglers_full(self) -> Tuple[List[int], dict, bool]:
        resp = self._client.call(m.StragglerRequest(), idempotent=True)
        if isinstance(resp, m.Stragglers):
            return resp.nodes, resp.times, resp.complete
        return [], {}, False

    # -- metrics --------------------------------------------------------------
    def report_global_step(self, step: int, timestamp: float = 0.0) -> None:
        self._client.call(m.GlobalStep(
            node_id=self.node_id, step=step,
            timestamp=timestamp or time.time()))

    def report_ckpt_perf(self, step: int, stall_ms: float,
                         staged_mbps: float = 0.0, persist_mbps: float = 0.0,
                         agg_persist_mbps: float = 0.0,
                         tensors_skipped: int = -1) -> None:
        """One attempt within a second: this sits on the save path, and a
        lost sample of a gauge costs nothing."""
        self._client.call(m.CkptPerf(
            node_id=self.node_id, step=step, stall_ms=stall_ms,
            staged_mbps=staged_mbps, persist_mbps=persist_mbps,
            agg_persist_mbps=agg_persist_mbps,
            tensors_skipped=int(tensors_skipped)),
            timeout=1.0, retries=1, deadline=1.0)

    def report_used_resource(self, cpu_percent: float, memory_mb: float,
                             tpu_duty_cycle: float = 0.0,
                             hbm_used_mb: float = 0.0) -> None:
        self._client.call(m.UsedResource(
            node_id=self.node_id, cpu_percent=cpu_percent,
            memory_mb=memory_mb, tpu_duty_cycle=tpu_duty_cycle,
            hbm_used_mb=hbm_used_mb))

    def report_model_info(self, num_params: int, flops_per_step: float = 0.0,
                          batch_size_per_step: int = 0, **extra) -> None:
        self._client.call(m.ModelInfo(
            num_params=num_params, flops_per_step=flops_per_step,
            batch_size_per_step=batch_size_per_step, extra=extra))

    def report_diagnosis_data(self, data_type: str, content: str) -> None:
        self._client.call(m.DiagnosisReport(
            node_id=self.node_id, data_type=data_type, content=content,
            timestamp=time.time()))

    # -- sync and checkpoint
    def join_sync(self, sync_name: str, node_rank: int = -1) -> None:
        self._client.call(m.SyncJoin(sync_name=sync_name,
                                     node_id=self.node_id,
                                     node_rank=node_rank))

    def sync_finished(self, sync_name: str) -> bool:
        resp = self._client.call(m.SyncQuery(sync_name=sync_name),
                                 idempotent=True)
        return isinstance(resp, m.BaseResponse) and resp.success

    def barrier(self, sync_name: str, timeout: float = 120.0) -> bool:
        """Join a named barrier and poll until it opens."""
        self.join_sync(sync_name)
        deadline = time.monotonic() + timeout
        while True:
            if self.sync_finished(sync_name):
                return True
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(0.2, remaining))

    def sync_checkpoint(self, step: int) -> bool:
        resp = self._client.call(m.CheckpointSync(node_id=self.node_id,
                                                  step=step))
        return isinstance(resp, m.BaseResponse) and resp.success

    # -- config ---------------------------------------------------------------
    def get_elastic_run_config(self) -> dict:
        resp = self._client.call(m.ElasticRunConfigRequest(),
                                 idempotent=True)
        return resp.configs if isinstance(resp, m.ElasticRunConfig) else {}

    def get_parallel_config(self) -> m.ParallelConfig:
        resp = self._client.call(
            m.ParallelConfigRequest(node_id=self.node_id), idempotent=True)
        return (resp if isinstance(resp, m.ParallelConfig)
                else m.ParallelConfig())

    # -- master HA ------------------------------------------------------------
    def journal_fetch(self, offset: int,
                      max_bytes: int = 1 << 20) -> m.JournalChunk:
        """Raw journal bytes from ``offset`` (``-1``: the snapshot)."""
        resp = self._client.call(
            m.JournalFetch(offset=offset, max_bytes=max_bytes),
            idempotent=True)
        return (resp if isinstance(resp, m.JournalChunk)
                else m.JournalChunk(found=False))

    # -- not here yet
    def get_reshard_epoch(self):
        raise NotImplementedError(
            f"the live-reshard epoch poll comes with {HOST_LAYERS}")

    def announce_reshard(self, target_num_processes: int,
                         target_spec: Optional[dict] = None,
                         expected_reports: int = 0,
                         deadline_s: float = 0.0):
        raise NotImplementedError(
            f"announcing a live reshard comes with {HOST_LAYERS}")

    def report_reshard(self, epoch: int, ok: bool, reason: str = "",
                       downtime_ms: float = 0.0,
                       moved_mb: float = 0.0) -> bool:
        raise NotImplementedError(
            f"reporting a live reshard comes with {HOST_LAYERS}")

    def reconnect(self) -> None:
        self._client.reconnect(force=True)

    def close(self) -> None:
        self._client.close()


_client_lock = threading.Lock()
_client: Optional[MasterClient] = None
#: The env address an env-built singleton was built from ("" when it was
#: built from an explicit address).
_client_env_addr: str = ""


def build_master_client(master_addr: str = "",
                        node_id: Optional[int] = None) -> MasterClient:
    """The process-wide client, from the agent's env contract by default.
    An env-built one is rebuilt when ``DLROVER_TPU_MASTER_ADDR`` changed
    since it was built."""
    global _client, _client_env_addr
    with _client_lock:
        if _client is not None and not master_addr and _client_env_addr:
            env_addr = get_master_addr()
            if env_addr and env_addr != _client_env_addr:
                _client.close()
                _client = None
        if _client is None:
            addr = master_addr or get_master_addr()
            nid = node_id if node_id is not None else get_node_id()
            if not addr:
                raise RuntimeError("no master address: set "
                                   "DLROVER_TPU_MASTER_ADDR or pass "
                                   "master_addr")
            _client = MasterClient(addr, nid)
            _client_env_addr = "" if master_addr else addr
        return _client


def invalidate_master_client() -> None:
    """Drop the singleton so that the next build re-reads the env; never
    raises."""
    global _client, _client_env_addr
    with _client_lock:
        if _client is not None:
            try:
                _client.close()
            except Exception:  # noqa: BLE001 - a speculative path
                pass
        _client = None
        _client_env_addr = ""


def reset_master_client() -> None:
    global _client, _client_env_addr
    with _client_lock:
        if _client is not None:
            _client.close()
        _client = None
        _client_env_addr = ""
