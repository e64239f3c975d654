"""Bounded idempotency-token cache — the port's own copy of
``dlrover_tpu/common/token_cache.py`` ``BoundedTokenCache``.

The RPC layer retries a refused connection (and, for tokened calls, a
timeout); the master dedupes a retried mutation by caching ``token ->
first result`` here.  Not thread-safe by itself: callers hold their own
service lock.  ``dump_state``/``load_state`` give the insertion-ordered
``[token, result]`` pairs, as the task manager's snapshot carries them.
"""

from __future__ import annotations

import collections
from typing import Any, Optional


class BoundedTokenCache:
    """FIFO-bounded ``token -> result`` map."""

    def __init__(self, capacity: int = 4096):
        self._capacity = capacity
        self._items: "collections.OrderedDict[str, Any]" = (
            collections.OrderedDict())

    def get(self, token: str) -> Optional[Any]:
        if not token:
            return None
        return self._items.get(token)

    def put(self, token: str, result: Any) -> None:
        if not token:
            return
        self._items[token] = result
        while len(self._items) > self._capacity:
            self._items.popitem(last=False)

    def __len__(self) -> int:
        return len(self._items)

    def dump_state(self) -> list:
        """Insertion-ordered ``[token, result]`` pairs."""
        return [[t, r] for t, r in self._items.items()]

    def load_state(self, items: list) -> None:
        self._items.clear()
        for token, result in items:
            self.put(token, result)
