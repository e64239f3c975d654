"""Master-hosted KV store — the port's own copy of
``dlrover_tpu/master/kv_store.py`` ``KVStoreService`` (``set``, ``get``,
``add``, ``multi_set``, ``multi_get``, ``delete``, ``scan``, ``clear``,
``dump_state``/``load_state`` ``:121-129``).  A tokened ``add`` or
``delete`` applies once and a retried duplicate gets the first answer.

With the HA journal bound (``master/state.py``) each mutation is
journaled before the RPC is acked; ``add`` journals its result and
``delete`` its token, so that replay rebuilds the dedupe caches and an RPC
retried across a failover still gets its first answer.  The reference's
other journaled managers, ``ReshardManager`` and ``CellManager``, come with
their host layers (``constants.HOST_LAYERS``).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from dlrover_tpu_torch.common.token_cache import BoundedTokenCache
from dlrover_tpu_torch.master.state import JournalBound


class KVStoreService(JournalBound):
    def __init__(self) -> None:
        self._store: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        self._add_tokens = BoundedTokenCache()
        self._del_tokens = BoundedTokenCache()

    def set(self, key: str, value: bytes) -> None:
        with self._cond:
            self._store[key] = value
            self._jrec("kv.set", key=key, value=value)
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
            self._jrec("kv.add", key=key, delta=delta, token=token,
                       result=cur)
            self._cond.notify_all()
            return cur

    def multi_set(self, kvs: Dict[str, bytes]) -> None:
        with self._cond:
            self._store.update(kvs)
            self._jrec("kv.multi_set", kvs=dict(kvs))
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
            if found:
                self._jrec("kv.delete", key=key, token=token)
            return found

    def scan(self, prefix: str) -> Dict[str, bytes]:
        with self._cond:
            return {k: v for k, v in self._store.items()
                    if k.startswith(prefix)}

    def clear(self, prefix: str = "") -> None:
        """Drop every key under ``prefix`` (all keys for ``""``)."""
        with self._cond:
            for k in [k for k in self._store if k.startswith(prefix)]:
                del self._store[k]
            self._jrec("kv.clear", prefix=prefix)

    def dump_state(self) -> dict:
        with self._cond:
            return {"store": dict(self._store),
                    "add_tokens": self._add_tokens.dump_state(),
                    "del_tokens": self._del_tokens.dump_state()}

    def load_state(self, state: dict) -> None:
        with self._cond:
            self._store = dict(state.get("store", {}))
            self._add_tokens.load_state(state.get("add_tokens", []))
            self._del_tokens.load_state(state.get("del_tokens", []))
            self._cond.notify_all()
