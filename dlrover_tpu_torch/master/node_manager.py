"""Node bookkeeping of a one-host job — the port's own copy of
``dlrover_tpu/master/node_manager.py`` ``LocalJobManager``
(``register_node_meta``, ``get_node_meta``, ``get_node``, ``all_nodes``,
``nodes_of``, ``update_node_status``, ``collect_heartbeat``,
``update_node_used_resource``, ``collect_model_info``,
``get_parallel_config``, ``set_parallel_config``, ``start``, ``stop``,
``_heartbeat_loop``, ``all_workers_exited``, ``all_workers_succeeded``).

Nodes register over RPC and heartbeat; a running node silent for
``node_heartbeat_timeout`` is marked FAILED and handed to
``on_node_dead`` (the master wires ``AllReduceNodeHandlingCallback``).
The reference mixes ``JournalBound`` into this manager
(``master/state.py:96``); its journal hooks and snapshot surface come with
``constants.HA_ITEM``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node


class LocalJobManager:
    def __init__(self, job_name: str = "local-job"):
        self.job_name = job_name
        self._lock = threading.Lock()
        self._ctx = get_context()
        self._nodes: Dict[int, Node] = {}
        self._node_meta: Dict[int, dict] = {}
        self._paral_configs: Dict[int, m.ParallelConfig] = {}
        self._model_info: Optional[m.ModelInfo] = None
        self._stop = threading.Event()
        self._heartbeat_thread: Optional[threading.Thread] = None
        self.on_node_dead = None

    # -- registration ---------------------------------------------------------
    def register_node_meta(self, meta: m.NodeMeta) -> None:
        with self._lock:
            node = self._nodes.get(meta.node_id)
            if node is None:
                node = Node(meta.node_type or NodeType.WORKER, meta.node_id,
                            rank_index=meta.node_rank
                            if meta.node_rank >= 0 else None)
                self._nodes[meta.node_id] = node
            node.host = meta.host
            node.agent_port = meta.agent_port
            node.slice_id = meta.slice_id
            node.host_id = meta.host_id
            node.update_heartbeat()
            node.update_status(NodeStatus.RUNNING)
            self._node_meta[meta.node_id] = {
                "host": meta.host,
                "agent_port": meta.agent_port,
                "coordinator_port": meta.agent_port,
                "slice_id": meta.slice_id,
                "host_id": meta.host_id,
                "local_world_size": meta.local_world_size,
                "tpu_chips": meta.tpu_chips,
            }
            logger.info("registered node %d (%s) at %s slice=%s",
                        meta.node_id, meta.node_type, meta.host,
                        meta.slice_id)

    def get_node_meta(self, node_id: int) -> Optional[dict]:
        with self._lock:
            return self._node_meta.get(node_id)

    def get_node(self, node_id: int) -> Optional[Node]:
        with self._lock:
            return self._nodes.get(node_id)

    def all_nodes(self) -> Dict[int, Node]:
        with self._lock:
            return dict(self._nodes)

    def nodes_of(self, node_type: str) -> list:
        with self._lock:
            return [n for n in self._nodes.values() if n.type == node_type]

    # -- status ---------------------------------------------------------------
    def update_node_status(self, node_id: int, node_type: str, status: str,
                           exit_reason: str = "") -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                node = Node(node_type or NodeType.WORKER, node_id)
                self._nodes[node_id] = node
            node.update_status(status)
            if exit_reason:
                node.exit_reason = exit_reason

    def collect_heartbeat(self, node_id: int, ts: float) -> None:
        with self._lock:
            node = self._nodes.get(node_id)
            if node is not None:
                node.update_heartbeat(ts or time.time())

    def update_node_used_resource(self, msg: m.UsedResource) -> None:
        with self._lock:
            node = self._nodes.get(msg.node_id)
            if node is not None:
                node.used_resource.cpu = msg.cpu_percent
                node.used_resource.memory_mb = int(msg.memory_mb)

    def collect_model_info(self, msg: m.ModelInfo) -> None:
        with self._lock:
            self._model_info = msg

    def get_parallel_config(self, node_id: int
                            ) -> Optional[m.ParallelConfig]:
        with self._lock:
            return self._paral_configs.get(node_id)

    def set_parallel_config(self, node_id: int,
                            cfg: m.ParallelConfig) -> None:
        with self._lock:
            self._paral_configs[node_id] = cfg

    # -- liveness -------------------------------------------------------------
    def start(self) -> None:
        if self._heartbeat_thread is None:
            self._heartbeat_thread = threading.Thread(
                target=self._heartbeat_loop, name="hb-monitor", daemon=True)
            self._heartbeat_thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._ctx.node_heartbeat_interval):
            self._check_heartbeats()

    def _check_heartbeats(self) -> None:
        """Mark every running node silent for longer than the timeout
        FAILED and hand it to ``on_node_dead``."""
        now = time.time()
        with self._lock:
            dead = [n for n in self._nodes.values()
                    if n.status == NodeStatus.RUNNING and n.heartbeat_time
                    and now - n.heartbeat_time
                    > self._ctx.node_heartbeat_timeout]
        for node in dead:
            logger.warning("node %d heartbeat timeout (%.0fs)", node.id,
                           now - node.heartbeat_time)
            self.update_node_status(node.id, node.type, NodeStatus.FAILED,
                                    "heartbeat_timeout")
            if self.on_node_dead is not None:
                self.on_node_dead(node)

    # -- job-level views (the worker role only) -------------------------------
    def all_workers_exited(self) -> bool:
        workers = self.nodes_of(NodeType.WORKER)
        return bool(workers) and all(n.status in NodeStatus.TERMINAL
                                     for n in workers)

    def all_workers_succeeded(self) -> bool:
        workers = self.nodes_of(NodeType.WORKER)
        return bool(workers) and all(n.status == NodeStatus.SUCCEEDED
                                     for n in workers)
