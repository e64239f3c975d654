"""Named barriers across the nodes of a world — the port's own copy of
``dlrover_tpu/master/sync_service.py`` ``SyncService`` (``set_world``,
``join_sync``, ``sync_finished``, ``finish_sync``, ``remove_sync``,
``dump_state``/``load_state`` ``:78-89``).  A barrier opens once every
node of the current world joined, or when its owner finishes it.

Workers join a barrier once and then only poll, so with the HA journal
bound (``master/state.py``) the joins, the world (on a change only) and the
open latch (``sync.finished``, applied as it was decided) are journaled
before the ack: a standby resumes a half-formed barrier in place.  The
reference's ``ReshardManager`` and ``CellManager`` journal too; they come
with their host layers (``constants.HOST_LAYERS``).
"""

from __future__ import annotations

import threading
from typing import Dict, Set

from dlrover_tpu_torch.master.state import JournalBound


class SyncService(JournalBound):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._syncs: Dict[str, Set[int]] = {}
        self._finished: Set[str] = set()
        self._world_nodes: Set[int] = set()

    def set_world(self, node_ids) -> None:
        with self._lock:
            new = set(node_ids)
            if new != self._world_nodes:
                self._world_nodes = new
                self._jrec("sync.world", nodes=sorted(new))

    def join_sync(self, sync_name: str, node_id: int) -> bool:
        with self._lock:
            members = self._syncs.setdefault(sync_name, set())
            if node_id not in members:
                members.add(node_id)
                self._jrec("sync.join", name=sync_name, node_id=node_id)
            if self._world_nodes and self._world_nodes.issubset(members):
                self._finish_locked(sync_name)
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def finish_sync(self, sync_name: str) -> bool:
        with self._lock:
            self._finish_locked(sync_name)
            return True

    def _finish_locked(self, sync_name: str) -> None:
        if sync_name not in self._finished:
            self._finished.add(sync_name)
            self._jrec("sync.finished", name=sync_name)

    def remove_sync(self, sync_name: str) -> None:
        with self._lock:
            existed = sync_name in self._syncs or sync_name in self._finished
            self._syncs.pop(sync_name, None)
            self._finished.discard(sync_name)
            if existed:
                self._jrec("sync.remove", name=sync_name)

    def dump_state(self) -> dict:
        with self._lock:
            return {"syncs": {name: sorted(members)
                              for name, members in self._syncs.items()},
                    "finished": sorted(self._finished),
                    "world": sorted(self._world_nodes)}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._syncs = {name: set(members) for name, members
                           in state.get("syncs", {}).items()}
            self._finished = set(state.get("finished", []))
            self._world_nodes = set(state.get("world", []))
