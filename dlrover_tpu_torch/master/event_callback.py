"""Node-event callbacks — the port's own copy of
``dlrover_tpu/master/event_callback.py`` (``NodeEventCallback``,
``AllReduceNodeHandlingCallback``).  ``TaskRescheduleCallback`` comes with
the task manager (``constants.TASK_ITEM``); the broadcast of a
``RESTART_WORKER`` action to the survivors of a dead node comes with the
diagnosis manager (``constants.DIAGNOSIS_ITEM``): until then the survivors
learn of the new round from ``num_nodes_waiting``.
"""

from __future__ import annotations

from dlrover_tpu_torch.common.node import Node


class NodeEventCallback:
    def on_node_started(self, node: Node) -> None: ...

    def on_node_succeeded(self, node: Node) -> None: ...

    def on_node_failed(self, node: Node) -> None: ...

    def on_node_deleted(self, node: Node) -> None: ...


class AllReduceNodeHandlingCallback(NodeEventCallback):
    """Keeps the rendezvous membership and the speed monitor in step with
    the nodes' lifecycle: a failed node leaves the alive set (the next
    round forms without it) and pauses the speed clock."""

    def __init__(self, rdzv_managers: dict, speed_monitor):
        self._rdzv_managers = rdzv_managers
        self._speed_monitor = speed_monitor

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

    def on_node_deleted(self, node: Node) -> None:
        self.on_node_failed(node)
