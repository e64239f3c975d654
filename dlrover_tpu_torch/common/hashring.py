"""Consistent hashing — the port's own copy of
``dlrover_tpu/common/hashring.py`` (``ring_hash`` ``:26``, ``HashRing``
``:34``), with the same placement.

Every layer that answers "who owns this id?" (the serving tier's gateway
ring, the cross-cell rendezvous hash) must compute the same answer from the
same member set in every process and in both packages, so a position is
the first 4 bytes of the id's sha1, big-endian, never Python's ``hash()``
(``PYTHONHASHSEED`` would move ownership between processes).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Tuple


def ring_hash(text: str) -> int:
    """Stable 32-bit ring position.  sha1, not ``hash()``: must agree
    across processes and interpreter runs (PYTHONHASHSEED)."""
    return int.from_bytes(
        hashlib.sha1(text.encode()).digest()[:4], "big"
    )


class HashRing:
    """Consistent-hash ring over a member id set (gateway ids, cell
    ids).

    Each member owns ``vnodes`` points; a key's owner is the first
    point clockwise from its hash.  Removing a dead member hands each
    of its arcs to the SUCCESSOR point's member — the "adopts the dead
    one's hash range" failover event, with no other ownership moving."""

    def __init__(self, member_ids, vnodes: int = 64):
        self.member_ids = tuple(sorted(set(member_ids)))
        self.vnodes = int(vnodes)
        points: List[Tuple[int, str]] = []
        for mid in self.member_ids:
            for v in range(self.vnodes):
                points.append((ring_hash(f"{mid}#{v}"), mid))
        points.sort()
        self._points = points

    # The serving tier named the member set after its members.
    @property
    def gateway_ids(self) -> Tuple[str, ...]:
        return self.member_ids

    def owner(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        h = ring_hash(key)
        # Binary search for the first point >= h (wrap to the start).
        lo, hi = 0, len(self._points)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._points[mid][0] < h:
                lo = mid + 1
            else:
                hi = mid
        return self._points[lo % len(self._points)][1]
