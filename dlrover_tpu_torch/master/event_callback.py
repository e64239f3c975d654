"""Node-event callbacks — the port's own copy of
``dlrover_tpu/master/event_callback.py`` (``NodeEventCallback``,
``TaskRescheduleCallback`` ``:34``, ``AllReduceNodeHandlingCallback``).

A failed node leaves the rendezvous' alive set and pauses the speed clock;
with a diagnosis manager, the nodes still alive get a ``RESTART_WORKER``
action on their next heartbeat, so that they rebuild the world at once
instead of waiting out a collective's timeout.
"""

from __future__ import annotations

from dlrover_tpu_torch.common.constants import (
    DiagnosisActionType,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.node import Node


class NodeEventCallback:
    def on_node_started(self, node: Node) -> None: ...

    def on_node_succeeded(self, node: Node) -> None: ...

    def on_node_failed(self, node: Node) -> None: ...

    def on_node_deleted(self, node: Node) -> None: ...


class TaskRescheduleCallback(NodeEventCallback):
    """Re-queues the data shards a failed worker held."""

    def __init__(self, task_manager):
        self._task_manager = task_manager

    def on_node_failed(self, node: Node) -> None:
        if node.type == NodeType.WORKER:
            n = self._task_manager.recover_worker_tasks(node.id)
            if n:
                logger.info("rescheduled %d shards of failed worker %d", n,
                            node.id)

    def on_node_deleted(self, node: Node) -> None:
        self.on_node_failed(node)


class AllReduceNodeHandlingCallback(NodeEventCallback):
    """Keeps the rendezvous membership and the speed monitor in step with
    the nodes' lifecycle: a failed node leaves the alive set (the next
    round forms without it) and pauses the speed clock; the survivors are
    told to rebuild the world."""

    def __init__(self, rdzv_managers: dict, speed_monitor,
                 diagnosis_manager=None):
        self._rdzv_managers = rdzv_managers
        self._speed_monitor = speed_monitor
        self._diagnosis = diagnosis_manager

    def on_node_started(self, node: Node) -> None:
        for mgr in self._rdzv_managers.values():
            mgr.add_alive_node(node.id)

    def on_node_succeeded(self, node: Node) -> None:
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(node.id)

    def on_node_failed(self, node: Node) -> None:
        for mgr in self._rdzv_managers.values():
            mgr.remove_alive_node(node.id)
        self._speed_monitor.mark_down()
        if self._diagnosis is not None:
            mgr = self._rdzv_managers.get(RendezvousName.TRAINING)
            self._diagnosis.enqueue_broadcast(
                DiagnosisActionType.RESTART_WORKER,
                f"peer node {node.id} failed; rebuild the world",
                mgr.alive_nodes() if mgr else [])

    def on_node_deleted(self, node: Node) -> None:
        self.on_node_failed(node)
