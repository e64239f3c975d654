"""The master's view of one training node — the port's own copy of
``dlrover_tpu/common/node.py`` (``NodeResource``, ``Node``,
``NodeStatusFlow``): what the job manager reads of a node.  The relaunch
accounting (``is_unrecoverable_failure``, ``get_relaunch_node``) comes
with a distributed job master (``constants.HOST_LAYERS``).

A node is one host (one agent) owning ``tpu_chips`` accelerators — the
reference's field name, kept for the wire; on the port's machines they are
CUDA cards.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeStatus


@dataclasses.dataclass
class NodeResource:
    cpu: float = 0.0
    memory_mb: int = 0
    tpu_chips: int = 0
    tpu_type: str = ""
    tpu_topology: str = ""
    disk_mb: int = 0
    priority: str = ""


class Node:
    """One training node as the job manager tracks it: identity, status,
    heartbeat, addressing and resources."""

    def __init__(
        self,
        node_type: str,
        node_id: int,
        rank_index: Optional[int] = None,
        name: str = "",
        status: str = NodeStatus.INITIAL,
        config_resource: Optional[NodeResource] = None,
        max_relaunch_count: int = 3,
        critical: bool = False,
    ):
        self.type = node_type
        self.id = node_id
        self.rank_index = rank_index if rank_index is not None else node_id
        self.name = name or f"{node_type}-{node_id}"
        self.status = status
        self.config_resource = config_resource or NodeResource()
        self.used_resource = NodeResource()
        self.critical = critical
        self.max_relaunch_count = max_relaunch_count
        self.exit_reason = ""
        self.start_time: Optional[float] = None
        self.finish_time: Optional[float] = None
        self.heartbeat_time: float = 0.0
        self.host: str = ""
        self.agent_port: int = 0
        self.slice_id: str = ""
        self.host_id: str = ""

    def update_status(self, status: str) -> None:
        if NodeStatusFlow.is_allowed(self.status, status):
            self.status = status
            if status == NodeStatus.RUNNING and self.start_time is None:
                self.start_time = time.time()
            if status in NodeStatus.TERMINAL and self.finish_time is None:
                self.finish_time = time.time()

    def update_heartbeat(self, ts: Optional[float] = None) -> None:
        self.heartbeat_time = ts if ts is not None else time.time()

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Node({self.type}-{self.id} rank={self.rank_index} "
                f"{self.status})")


class NodeStatusFlow:
    """Legal node status transitions; any other is ignored, so the event
    handling is idempotent under out-of-order reports."""

    _ALLOWED = {
        NodeStatus.INITIAL: {NodeStatus.PENDING, NodeStatus.RUNNING,
                             NodeStatus.FAILED, NodeStatus.DELETED},
        NodeStatus.PENDING: {NodeStatus.RUNNING, NodeStatus.SUCCEEDED,
                             NodeStatus.FAILED, NodeStatus.DELETED},
        NodeStatus.RUNNING: {NodeStatus.SUCCEEDED, NodeStatus.FAILED,
                             NodeStatus.DELETED, NodeStatus.BREAKDOWN},
        NodeStatus.SUCCEEDED: {NodeStatus.DELETED},
        NodeStatus.FAILED: {NodeStatus.DELETED, NodeStatus.RUNNING},
        NodeStatus.BREAKDOWN: {NodeStatus.DELETED},
        NodeStatus.DELETED: set(),
        NodeStatus.UNKNOWN: set(NodeStatus.TERMINAL)
        | {NodeStatus.PENDING, NodeStatus.RUNNING},
    }

    @classmethod
    def is_allowed(cls, from_status: str, to_status: str) -> bool:
        if from_status == to_status:
            return False
        return to_status in cls._ALLOWED.get(from_status, set())
