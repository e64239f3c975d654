"""Named barriers across the nodes of a world — the port's own copy of
``dlrover_tpu/master/sync_service.py`` ``SyncService`` (``set_world``,
``join_sync``, ``sync_finished``, ``finish_sync``).  A
barrier opens once every node of the current world joined, or when its
owner finishes it.  The journal of joins comes with ``constants.HA_ITEM``.
"""

from __future__ import annotations

import threading
from typing import Dict, Set


class SyncService:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._world_nodes: Set[int] = set()

    def set_world(self, node_ids) -> None:
        with self._lock:
            self._world_nodes = set(node_ids)

    def join_sync(self, sync_name: str, node_id: int) -> bool:
        with self._lock:
            members = self._syncs.setdefault(sync_name, set())
            members.add(node_id)
            if self._world_nodes and self._world_nodes.issubset(members):
                self._finished.add(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def finish_sync(self, sync_name: str) -> bool:
        with self._lock:
            self._finished.add(sync_name)
            return True
