"""The master's RPC servicer — the port's own copy of the training part of
``dlrover_tpu/master/servicer.py`` ``MasterServicer``: one handler a
message type, so the dispatch table is the master's API.

It answers node registration, status and failure, heartbeats, the
rendezvous, the KV store, dynamic data sharding (the task manager), the
pre-flight node check (the network-check rendezvous), global steps,
checkpoint perf and the checkpoint barrier, diagnosis reports, named
barriers, the run and parallel configs and the job's exit, as the
reference does.  A node failure goes to the diagnosis manager and
re-queues the node's data shards; a heartbeat carries back the actions
the diagnosis manager queued for the node.  With master HA on, the
managers journal each mutation inside its handler, so before the reply
(``master/state.py``), and ``JournalFetch`` (reference ``:400-430``) serves
the WAL's or the snapshot's bytes to a standby that mirrors them.  The
serving, fleet, cell and reshard messages are not part of the port's wire
yet (a type it does not know does not decode, and is answered as a failed
``BaseResponse`` by the transport).
"""

from __future__ import annotations

import os
import time
from typing import Optional

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.master.dataset_splitter import new_dataset_splitter


class MasterServicer:
    def __init__(self, *, task_manager=None, job_manager=None,
                 rdzv_managers=None, kv_store=None, sync_service=None,
                 speed_monitor=None, diagnosis_manager=None,
                 job_context=None):
        self.task_manager = task_manager
        self.job_manager = job_manager
        self.rdzv_managers = rdzv_managers or {}
        self.kv_store = kv_store
        self.sync_service = sync_service
        self.speed_monitor = speed_monitor
        self.diagnosis_manager = diagnosis_manager
        self.job_context = job_context
        self._dispatch = {
            m.NodeMeta: self._on_node_meta,
            m.ReportNodeStatus: self._on_node_status,
            m.NodeFailure: self._on_node_failure,
            m.Heartbeat: self._on_heartbeat,
            m.JoinRendezvous: self._on_join_rdzv,
            m.CommWorldRequest: self._on_comm_world,
            m.WaitingNodeNumRequest: self._on_waiting_num,
            m.KVStoreSet: self._on_kv_set,
            m.KVStoreGet: self._on_kv_get,
            m.KVStoreMultiSet: self._on_kv_multi_set,
            m.KVStoreMultiGet: self._on_kv_multi_get,
            m.KVStoreAdd: self._on_kv_add,
            m.KVStoreScan: self._on_kv_scan,
            m.KVStoreDelete: self._on_kv_delete,
            m.DatasetShardParams: self._on_dataset_params,
            m.TaskRequest: self._on_task_request,
            m.TaskResult: self._on_task_result,
            m.ShardCheckpointRequest: self._on_shard_ckpt_get,
            m.ShardCheckpoint: self._on_shard_ckpt_restore,
            m.NetworkCheckResult: self._on_network_check_result,
            m.NetworkReadyRequest: self._on_network_ready,
            m.FaultNodeRequest: self._on_fault_nodes,
            m.StragglerRequest: self._on_stragglers,
            m.GlobalStep: self._on_global_step,
            m.CkptPerf: self._on_ckpt_perf,
            m.UsedResource: self._on_used_resource,
            m.ModelInfo: self._on_model_info,
            m.DiagnosisReport: self._on_diagnosis_report,
            m.SyncJoin: self._on_sync_join,
            m.SyncFinish: self._on_sync_finish,
            m.SyncQuery: self._on_sync_query,
            m.CheckpointSync: self._on_ckpt_sync,
            m.ElasticRunConfigRequest: self._on_run_config,
            m.ParallelConfigRequest: self._on_paral_config,
            m.JobExitRequest: self._on_job_exit,
            m.JournalFetch: self._on_journal_fetch,
        }

    def __call__(self, msg: m.Message) -> Optional[m.Message]:
        handler = self._dispatch.get(type(msg))
        if handler is None:
            logger.warning("servicer: unhandled message %s",
                           type(msg).__name__)
            return m.BaseResponse(success=False,
                                  reason="unhandled message type")
        return handler(msg)

    # -- nodes ----------------------------------------------------------------
    def _on_node_meta(self, msg: m.NodeMeta):
        if self.job_manager is not None:
            self.job_manager.register_node_meta(msg)

    def _on_node_status(self, msg: m.ReportNodeStatus):
        if self.job_manager is not None:
            self.job_manager.update_node_status(
                msg.node_id, msg.node_type, msg.status, msg.exit_reason)

    def _on_node_failure(self, msg: m.NodeFailure):
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.report_failure(msg)
        if self.task_manager is not None:
            self.task_manager.recover_worker_tasks(msg.node_id)
        if self.speed_monitor is not None:
            self.speed_monitor.mark_down()

    def _on_heartbeat(self, msg: m.Heartbeat):
        actions = []
        if self.job_manager is not None:
            self.job_manager.collect_heartbeat(msg.node_id, msg.timestamp)
        if self.diagnosis_manager is not None:
            actions = self.diagnosis_manager.pop_actions(msg.node_id)
        return m.HeartbeatResponse(actions=actions)

    # -- rendezvous -----------------------------------------------------------
    def _rdzv(self, name: str):
        mgr = self.rdzv_managers.get(name)
        if mgr is None:
            raise KeyError(f"no rendezvous manager named {name}")
        return mgr

    def _on_join_rdzv(self, msg: m.JoinRendezvous):
        mgr = self._rdzv(msg.rdzv_name)
        meta = {}
        if self.job_manager is not None:
            meta = self.job_manager.get_node_meta(msg.node_id) or {}
        round_ = mgr.join(
            msg.node_id, msg.node_rank, msg.local_world_size,
            host=meta.get("host", msg.node_ip),
            coordinator_port=meta.get("coordinator_port", 0),
            slice_id=msg.slice_id or meta.get("slice_id", ""),
            host_id=meta.get("host_id", ""),
            attempt_id=msg.attempt_id)
        return m.RendezvousRound(round=round_)

    def _on_comm_world(self, msg: m.CommWorldRequest):
        mgr = self._rdzv(msg.rdzv_name)
        round_, group, world, coord = mgr.get_comm_world(msg.node_id)
        if world and self.sync_service is not None:
            self.sync_service.set_world(
                [w["node_id"] for w in world.values()])
        return m.CommWorld(rdzv_name=msg.rdzv_name, round=round_,
                           group=group, world=world, coordinator=coord)

    def _on_waiting_num(self, msg: m.WaitingNodeNumRequest):
        mgr = self._rdzv(msg.rdzv_name)
        return m.WaitingNodeNum(waiting_num=mgr.num_nodes_waiting())

    # -- kv -------------------------------------------------------------------
    def _on_kv_set(self, msg: m.KVStoreSet):
        self.kv_store.set(msg.key, msg.value)

    def _on_kv_get(self, msg: m.KVStoreGet):
        val = self.kv_store.get(msg.key)
        return m.KVStoreValue(key=msg.key, value=val or b"",
                              found=val is not None)

    def _on_kv_multi_set(self, msg: m.KVStoreMultiSet):
        self.kv_store.multi_set(msg.kvs)

    def _on_kv_multi_get(self, msg: m.KVStoreMultiGet):
        return m.KVStoreMultiValue(kvs=self.kv_store.multi_get(msg.keys))

    def _on_kv_add(self, msg: m.KVStoreAdd):
        return m.KVStoreCount(
            value=self.kv_store.add(msg.key, msg.delta, token=msg.token))

    def _on_kv_scan(self, msg: m.KVStoreScan):
        return m.KVStoreScanResult(kvs=self.kv_store.scan(msg.prefix))

    def _on_kv_delete(self, msg: m.KVStoreDelete):
        return m.BaseResponse(
            success=self.kv_store.delete(msg.key, token=msg.token))

    # -- data sharding ----------------------------------------------------------
    def _on_dataset_params(self, msg: m.DatasetShardParams):
        if not self.task_manager.has_dataset(msg.dataset_name):
            # The splitter's keywords double as the dataset's snapshot.
            params = dict(dataset_name=msg.dataset_name,
                          dataset_size=msg.dataset_size,
                          shard_size=msg.shard_size,
                          num_epochs=msg.num_epochs, shuffle=msg.shuffle,
                          storage_type=msg.storage_type)
            self.task_manager.new_dataset(new_dataset_splitter(**params),
                                          params=params)

    def _on_task_request(self, msg: m.TaskRequest):
        got = self.task_manager.get_task(msg.dataset_name, msg.worker_id,
                                         token=msg.token)
        if got is None:
            return m.Task(task_id=-1, dataset_name=msg.dataset_name)
        task_id, shard, epoch = got
        return m.Task(task_id=task_id, dataset_name=msg.dataset_name,
                      start=shard.start, end=shard.end, epoch=epoch)

    def _on_task_result(self, msg: m.TaskResult):
        self.task_manager.report_task_result(msg.dataset_name, msg.task_id,
                                             msg.success)

    def _on_shard_ckpt_get(self, msg: m.ShardCheckpointRequest):
        return m.ShardCheckpoint(
            dataset_name=msg.dataset_name,
            content=self.task_manager.checkpoint_dataset(msg.dataset_name))

    def _on_shard_ckpt_restore(self, msg: m.ShardCheckpoint):
        return m.BaseResponse(success=self.task_manager.restore_dataset(
            msg.dataset_name, msg.content))

    # -- the pre-flight node check --------------------------------------------
    def _on_network_check_result(self, msg: m.NetworkCheckResult):
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr is not None:
            mgr.report_result(msg.node_id, msg.succeeded, msg.elapsed,
                              msg.round)

    def _on_network_ready(self, msg: m.NetworkReadyRequest):
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        return m.BaseResponse(
            success=mgr.network_ready() if mgr is not None else True)

    def _on_fault_nodes(self, msg: m.FaultNodeRequest):
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr is None:
            return m.FaultNodes()
        nodes, reason = mgr.check_fault_node()
        return m.FaultNodes(nodes=nodes, reason=reason)

    def _on_stragglers(self, msg: m.StragglerRequest):
        mgr = self.rdzv_managers.get(RendezvousName.NETWORK_CHECK)
        if mgr is None:
            return m.Stragglers()
        times, stragglers = mgr.get_stragglers()
        return m.Stragglers(nodes=stragglers, times=times,
                            complete=mgr.results_complete())

    # -- metrics --------------------------------------------------------------
    def _on_global_step(self, msg: m.GlobalStep):
        if self.speed_monitor is not None:
            self.speed_monitor.collect_global_step(
                msg.step, msg.timestamp or time.time())

    def _on_ckpt_perf(self, msg: m.CkptPerf):
        if self.speed_monitor is not None:
            self.speed_monitor.record_ckpt_stall(
                msg.stall_ms / 1000.0, step=msg.step,
                persist_mbps=msg.persist_mbps, staged_mbps=msg.staged_mbps,
                agg_persist_mbps=msg.agg_persist_mbps,
                tensors_skipped=msg.tensors_skipped, node_id=msg.node_id)

    def _on_used_resource(self, msg: m.UsedResource):
        if self.job_manager is not None:
            self.job_manager.update_node_used_resource(msg)

    def _on_model_info(self, msg: m.ModelInfo):
        if self.job_manager is not None:
            self.job_manager.collect_model_info(msg)

    def _on_diagnosis_report(self, msg: m.DiagnosisReport):
        if self.diagnosis_manager is not None:
            self.diagnosis_manager.collect_data(msg)

    # -- sync -----------------------------------------------------------------
    def _on_sync_join(self, msg: m.SyncJoin):
        self.sync_service.join_sync(msg.sync_name, msg.node_id)

    def _on_sync_finish(self, msg: m.SyncFinish):
        self.sync_service.finish_sync(msg.sync_name)

    def _on_sync_query(self, msg: m.SyncQuery):
        return m.BaseResponse(
            success=self.sync_service.sync_finished(msg.sync_name))

    def _on_ckpt_sync(self, msg: m.CheckpointSync):
        mgr = self.rdzv_managers.get(RendezvousName.TRAINING)
        done = (mgr.sync_ckpt_nodes(msg.node_id, msg.step)
                if mgr is not None else True)
        return m.BaseResponse(success=done)

    # -- config and exit
    def _on_run_config(self, msg: m.ElasticRunConfigRequest):
        configs = {}
        if self.job_context is not None:
            configs = getattr(self.job_context, "run_config", {}) or {}
        return m.ElasticRunConfig(configs=configs)

    def _on_paral_config(self, msg: m.ParallelConfigRequest):
        if self.job_manager is not None:
            cfg = self.job_manager.get_parallel_config(msg.node_id)
            if cfg is not None:
                return cfg
        return m.ParallelConfig()

    def _on_job_exit(self, msg: m.JobExitRequest):
        logger.info("job exit requested by node %d: success=%s reason=%s",
                    msg.node_id, msg.success, msg.reason)
        if self.job_context is not None:
            self.job_context.request_stop(msg.success, msg.reason)

    # -- master HA ------------------------------------------------------------
    def _on_journal_fetch(self, msg: m.JournalFetch):
        """Raw WAL bytes from ``msg.offset`` (the snapshot file for -1)."""
        from dlrover_tpu_torch.master.state import SNAP_NAME, WAL_NAME

        journal = getattr(self.job_context, "_ha_journal", None)
        if journal is None:
            return m.JournalChunk(found=False)
        if msg.offset < 0:
            try:
                with open(os.path.join(journal.state_dir, SNAP_NAME),
                          "rb") as f:
                    data = f.read()
            except OSError:
                data = b""
            return m.JournalChunk(data=data, offset=-1, eof=True)
        try:
            with open(os.path.join(journal.state_dir, WAL_NAME), "rb") as f:
                # Size and inode from the fd the bytes come from: a
                # compaction's rename between two opens would mix files.
                st = os.fstat(f.fileno())
                f.seek(msg.offset)
                data = f.read(max(0, min(msg.max_bytes, 16 << 20)))
        except OSError:
            return m.JournalChunk(offset=msg.offset, eof=True)
        return m.JournalChunk(data=data, offset=msg.offset, eof=not data,
                              wal_size=st.st_size, wal_ino=st.st_ino)
