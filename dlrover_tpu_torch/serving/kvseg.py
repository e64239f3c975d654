"""Peer-to-peer KV-segment handoff: prefill replicas publish
segments, decode replicas pull them directly — the port's copy of
``dlrover_tpu/serving/kvseg.py`` (``KvSegmentStore``, ``KvSegmentServer``,
``pull_kv_segment`` and the segment helpers), held against it.

Relaying every prefill->decode segment through the gateway's memory
makes the gateway the data-plane bottleneck at production segment sizes.
Here the segment bytes never touch the gateway:

- the prefill replica ``put``s the packed segment into its local
  :class:`KvSegmentStore` and serves it from a :class:`KvSegmentServer`
  (the ``ReshardPeer`` pattern from ``reshard/mover.py``: a tiny RPC
  segment server per publisher, CRC-verified pulls);
- the gateway holds only a TICKET — ``(addr, seg_fp, crc32, nbytes)``
  on :class:`~dlrover_tpu_torch.common.messages.ServeKvReady` — and attaches
  it to the decode grant;
- the decode replica ``pull``s the bytes from the ticket's address and
  verifies length + CRC-32 + fingerprint before they can reach
  ``import_kv`` (which re-verifies the segment's own embedded CRC).

A failed pull (dead peer, evicted segment, torn bytes) raises
:class:`KvPullError`; the replica reports ``ServeKvReject`` and the
gateway re-queues the request for a fresh prefill in RELAY mode (the
payload rides through the gateway as before) — the fallback ladder is
bounded by the existing ``max_attempts`` contract.

The store is bounded (count + bytes) with TTL expiry: a segment must
outlive one decode-replica death (the gateway re-ships the same ticket
to the next decode grant) but a long-dead request's bytes must not pin
the prefill replica's memory forever.
"""

from __future__ import annotations

import hashlib
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    BaseResponse,
    KvSegmentData,
    KvSegmentFetch,
    Message,
)


class KvPullError(RuntimeError):
    """A ticketed segment could not be pulled intact (peer gone,
    segment expired/evicted, length/CRC/fingerprint mismatch).  The
    decode replica converts this into ``ServeKvReject`` so the gateway
    re-prefills through the relay fallback."""


def segment_fingerprint(payload: bytes) -> str:
    """Stable id of one published segment — pins a ticket to the exact
    bytes it promised, so a re-prefill under the same req_id can never
    satisfy a stale ticket."""
    return hashlib.sha1(payload).hexdigest()[:16]


def segment_block_info(payload: bytes) -> Optional[Tuple[int, int]]:
    """Peek a segment's block framing without touching the
    array data: ``(block_size, n_blocks)`` for a block-list payload
    from a paged prefill server, ``None`` for a monolithic one (or
    anything unparseable — the store treats payloads as opaque bytes,
    so a peek failure is telemetry lost, never an error)."""
    try:
        meta = msgpack_lite.unpackb(payload)["meta"]
        if "bs" in meta:
            return int(meta["bs"]), int(meta["nblk"])
    except Exception as e:  # noqa: BLE001 - telemetry-only peek
        logger.debug("segment block-info peek failed: %s", e)
    return None


class KvSegmentStore:
    """Bounded, TTL'd req_id -> segment table on the prefill replica.

    ``put`` returns the ticket tuple ``(seg_fp, crc32, nbytes)``.
    Eviction is oldest-first once either bound trips; ``get`` never
    resurrects an expired entry (the sweep is piggybacked on put/get so
    no thread is needed)."""

    def __init__(self, max_segments: int = 64,
                 max_bytes: int = 256 << 20, ttl_s: float = 120.0,
                 clock: Callable[[], float] = time.monotonic):
        self.max_segments = int(max_segments)
        self.max_bytes = int(max_bytes)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        # RLock: the *_locked helpers re-take it under the public
        # methods' hold, keeping every state write lexically inside a
        # lock block (the Histogram._roll_locked pattern).
        self._mu = threading.RLock()
        # req_id -> (payload, seg_fp, crc32, published_at); dict order
        # doubles as insertion order for oldest-first eviction.
        self._segs: Dict[str, Tuple[bytes, str, int, float]] = {}
        self._bytes = 0

    def put(self, req_id: str,
            payload: bytes) -> Optional[Tuple[str, int, int]]:
        """Publish one segment.  Returns the ticket tuple ``(seg_fp,
        crc32, nbytes)`` — or ``None`` when the store could not RETAIN
        it (payload alone exceeds ``max_bytes``, or the post-insert
        sweep evicted it): a ticket for bytes the server no longer
        holds would guarantee a failed pull that burns one of the
        request's bounded attempts, so the caller must fall back to
        the relay path instead of shipping it."""
        if len(payload) > self.max_bytes:
            return None
        fp = segment_fingerprint(payload)
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        now = self._clock()
        with self._mu:
            self._drop_locked(req_id)
            self._segs[req_id] = (bytes(payload), fp, crc, now)
            self._bytes += len(payload)
            self._sweep_locked(now)
            if req_id not in self._segs:
                return None
        return fp, crc, len(payload)

    def get(self, req_id: str,
            seg_fp: str = "") -> Optional[Tuple[bytes, int]]:
        """-> (payload, crc32), or None when absent/expired or when
        ``seg_fp`` names a different publication."""
        now = self._clock()
        with self._mu:
            ent = self._segs.get(req_id)
            if ent is None:
                return None
            payload, fp, crc, ts = ent
            if now - ts > self.ttl_s:
                self._drop_locked(req_id)
                return None
            if seg_fp and seg_fp != fp:
                return None
            return payload, crc

    def discard(self, req_id: str) -> None:
        with self._mu:
            self._drop_locked(req_id)

    def __len__(self) -> int:
        with self._mu:
            return len(self._segs)

    @property
    def nbytes(self) -> int:
        with self._mu:
            return self._bytes

    def stats(self) -> Dict[str, int]:
        """Store telemetry including the block framing:
        how many retained segments ride as block lists and the total
        KV blocks they hold — the handoff-side view of the paged
        fleet's memory motion."""
        with self._mu:
            entries = [p for p, _f, _c, _t in self._segs.values()]
        paged = 0
        blocks = 0
        for p in entries:
            info = segment_block_info(p)
            if info is not None:
                paged += 1
                blocks += info[1]
        return {
            "segments": len(entries),
            "bytes": sum(len(p) for p in entries),
            "paged_segments": paged,
            "blocks_held": blocks,
        }

    # -- internals (called under self._mu; RLock re-entry keeps the
    # writes lexically lock-scoped) ---------------------------------------

    def _drop_locked(self, req_id: str) -> None:
        with self._mu:
            ent = self._segs.pop(req_id, None)
            if ent is not None:
                self._bytes -= len(ent[0])

    def _sweep_locked(self, now: float) -> None:
        with self._mu:
            for rid in [
                r for r, (_p, _f, _c, ts) in self._segs.items()
                if now - ts > self.ttl_s
            ]:
                self._drop_locked(rid)
            while self._segs and (
                len(self._segs) > self.max_segments
                or self._bytes > self.max_bytes
            ):
                self._drop_locked(next(iter(self._segs)))


def handle_fetch(store: KvSegmentStore,
                 msg: Message) -> Optional[Message]:
    """The segment server's dispatch, separable from the RPC wrapper
    so loopback fleets (tests, smoke benches) serve pulls with zero
    sockets."""
    if not isinstance(msg, KvSegmentFetch):
        return BaseResponse(
            success=False,
            reason=f"unknown message {type(msg).__name__}",
        )
    got = store.get(msg.req_id, msg.seg_fp)
    if got is None:
        return KvSegmentData(
            found=False,
            reason=f"segment {msg.req_id!r} not published "
                   "(expired, evicted, or re-prefilled)",
        )
    payload, crc = got
    return KvSegmentData(found=True, payload=payload, crc32=crc)


class KvSegmentServer:
    """RPC front of one replica's :class:`KvSegmentStore` — the
    publishing half of the P2P handoff.  Lazy-started by the replica
    runner on its first P2P prefill; ``addr`` is what rides the
    ticket."""

    def __init__(self, store: Optional[KvSegmentStore] = None,
                 port: int = 0):
        from dlrover_tpu_torch.common.rpc import RpcServer, local_ip

        self.store = store or KvSegmentStore()
        self._server = RpcServer(port, self.handle)
        self._server.start()
        self.addr = f"{local_ip()}:{self._server.port}"

    def handle(self, msg: Message) -> Optional[Message]:
        return handle_fetch(self.store, msg)

    def stop(self) -> None:
        self._server.stop()


def pull_kv_segment(addr: str, req_id: str, seg_fp: str,
                    crc32: int, nbytes: int,
                    transport=None, timeout: float = 10.0) -> bytes:
    """Pull one ticketed segment from ``addr`` and verify it against
    the ticket: byte count, CRC-32, and fingerprint must all match
    before the bytes are trusted (``import_kv`` then re-verifies the
    segment's own embedded CRC — belt and braces, same as the
    replica-ring fetch path).  ``transport`` overrides the RpcClient
    (loopback tests); raises :class:`KvPullError` on any failure."""
    close_after = False
    if transport is None:
        from dlrover_tpu_torch.common.rpc import RpcClient

        transport = RpcClient(addr, timeout=timeout)
        close_after = True
    try:
        try:
            resp = transport.call(
                KvSegmentFetch(req_id=req_id, seg_fp=seg_fp),
                deadline=timeout,
            )
        except Exception as e:  # noqa: BLE001 - converge on KvPullError
            raise KvPullError(
                f"segment pull for {req_id!r} from {addr} failed: {e}"
            ) from e
    finally:
        if close_after:
            try:
                transport.close()
            except Exception:  # noqa: BLE001 - best-effort teardown
                logger.debug("kvseg: pull client close failed", exc_info=True)
    if not isinstance(resp, KvSegmentData) or not resp.found:
        raise KvPullError(
            f"segment {req_id!r} not served by {addr}: "
            f"{getattr(resp, 'reason', 'bad reply type')}"
        )
    payload = resp.payload
    if len(payload) != int(nbytes):
        raise KvPullError(
            f"segment {req_id!r} pulled {len(payload)} bytes, ticket "
            f"promised {nbytes}"
        )
    if (zlib.crc32(payload) & 0xFFFFFFFF) != int(crc32):
        raise KvPullError(
            f"segment {req_id!r} payload CRC mismatch (torn transfer)"
        )
    if seg_fp and segment_fingerprint(payload) != seg_fp:
        raise KvPullError(
            f"segment {req_id!r} fingerprint mismatch (stale "
            "publication)"
        )
    return payload
