"""Master-hosted KV store — the port's own copy of
``dlrover_tpu/master/kv_store.py`` ``KVStoreService`` (``set``, ``get``,
``add``, ``multi_set``, ``multi_get``, ``delete``, ``scan``).  A tokened ``add`` or ``delete`` applies once and a retried
duplicate gets the first answer.  The reference journals each mutation
for its HA standby; that comes with the journal (``constants.HA_ITEM``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.token_cache import BoundedTokenCache


class KVStoreService:
    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        self._add_tokens = BoundedTokenCache()
        self._del_tokens = BoundedTokenCache()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._store[key] = value
            self._cond.notify_all()

    def get(self, key: str) -> Optional[bytes]:
        with self._cond:
            return self._store.get(key)


    def add(self, key: str, delta: int, token: str = "") -> int:
        with self._cond:
            cached = self._add_tokens.get(token)
            if cached is not None:
                return cached
            cur = int(self._store.get(key, b"0")) + delta
            self._store[key] = str(cur).encode()
            self._add_tokens.put(token, cur)
            self._cond.notify_all()
            return cur

    def multi_set(self, kvs: Dict[str, bytes]) -> None:
        with self._cond:
            self._store.update(kvs)
            self._cond.notify_all()

    def multi_get(self, keys: List[str]) -> Dict[str, bytes]:
        with self._cond:
            return {k: self._store[k] for k in keys if k in self._store}

    def delete(self, key: str, token: str = "") -> bool:
        """Whether this call removed ``key``."""
        with self._cond:
            cached = self._del_tokens.get(token)
            if cached is not None:
                return bool(cached)
            found = self._store.pop(key, None) is not None
            self._del_tokens.put(token, found)
            return found

    def scan(self, prefix: str) -> Dict[str, bytes]:
        with self._cond:
            return {k: v for k, v in self._store.items()
                    if k.startswith(prefix)}
