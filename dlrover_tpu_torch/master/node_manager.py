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
With the HA journal bound (``master/state.py``) a registration
(``node.meta``) and a status change (``node.status``) are journaled before
the ack (reference ``:42-63`` for ``dump_state``, ``load_state`` and
``rearm_heartbeats``); heartbeats, resource gauges and the model info are
not, as in the reference.  The reference's ``ReshardManager`` and
``CellManager`` journal too; they come with their host layers
(``constants.HOST_LAYERS``).
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
from dlrover_tpu_torch.master.state import JournalBound


class LocalJobManager(JournalBound):
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

    # -- the HA snapshot --------------------------------------------------------
    def dump_state(self) -> dict:
        with self._lock:
            return {
                "nodes": {nid: {"type": n.type, "rank": n.rank_index,
                                "status": n.status,
                                "exit_reason": n.exit_reason,
                                "host": n.host, "agent_port": n.agent_port,
                                "slice_id": n.slice_id,
                                "host_id": n.host_id}
                          for nid, n in self._nodes.items()},
                "meta": {nid: dict(meta)
                         for nid, meta in self._node_meta.items()},
            }

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._nodes.clear()
            for nid, d in state.get("nodes", {}).items():
                node = Node(d.get("type") or NodeType.WORKER, int(nid),
                            rank_index=d.get("rank"),
                            status=d.get("status", NodeStatus.INITIAL))
                node.exit_reason = d.get("exit_reason", "")
                node.host = d.get("host", "")
                node.agent_port = int(d.get("agent_port", 0))
                node.slice_id = d.get("slice_id", "")
                node.host_id = d.get("host_id", "")
                self._nodes[int(nid)] = node
            self._node_meta = {int(nid): dict(meta) for nid, meta
                               in state.get("meta", {}).items()}

    def rearm_heartbeats(self) -> None:
        """Give every running node a fresh heartbeat: the silence that
        happened under the dead primary is not the node's."""
        with self._lock:
            for node in self._nodes.values():
                if node.status == NodeStatus.RUNNING:
                    node.update_heartbeat()

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
            self._jrec("node.meta", node_type=meta.node_type,
                       node_id=meta.node_id, node_rank=meta.node_rank,
                       host=meta.host, agent_port=meta.agent_port,
                       slice_id=meta.slice_id, host_id=meta.host_id,
                       tpu_chips=meta.tpu_chips,
                       local_world_size=meta.local_world_size)
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
            prev = node.status
            node.update_status(status)
            if exit_reason:
                node.exit_reason = exit_reason
            if node.status != prev:
                self._jrec("node.status", node_id=node_id,
                           node_type=node.type, status=node.status,
                           exit_reason=exit_reason)

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
