"""The sharded gateway tier — the port's own copy of
``dlrover_tpu/serving/tier.py``: N gateway processes over a shared leased
registry, requests consistent-hashed by request id to one owning gateway,
replicas polling every live gateway, clients riding out a gateway's death
by resubmitting the same id to the new owner.

- **Registry** (``LocalKv`` ``:99``, ``MasterKv`` ``:128`` over the port's
  ``MasterClient``, ``RpcKv`` ``:149``, ``RegistryServer`` ``:188`` with the
  tokened delete of ``common/token_cache.py``, ``ServeRegistry``
  ``:242-380``): leased ``serve/{job}/gw/{gid}`` and ``serve/{job}/rep/
  {rid}`` entries, ``json.dumps({"addr", "ts"})`` bytes like the
  reference's, liveness judged on the READER's clock (``_observe_live``).
- **One gateway** (``GatewayTierNode`` ``:387-620``): a ``Gateway`` plus
  the registry heartbeat, the once-a-lease GC, ``gateway_id`` in its
  stats snapshot and an optional ``/metrics`` endpoint with the merged
  tier gauges (``tier_*``).
- **Clients** (``_GatewaySet`` ``:634``, ``_fetch_gateway_stats`` ``:722``,
  ``TierClient`` ``:743``): owner routing over ``common/hashring.py``,
  failover resubmission of the same ``req_id``.
- **Replicas** (``TierReplicaLink`` ``:941``): rotating fan-out polls,
  grants merged without double-granting a slot, ``drain`` the AND of every
  gateway's flag, reports routed to the granting gateway and else to the
  ring owner.
- **Autoscale** (``merge_snapshots`` ``:1126``, ``TierStats`` ``:1248``,
  ``pick_drain_victim_merged`` ``:1270``, ``TierActuator`` ``:1288``): the
  per-gateway snapshots merged into one fleet view (histograms bucket-
  wise), and tier-wide drains broadcast to every gateway.

Not ported: the reference's ``obs`` spans (``client.resubmit``), the
flight recorder (its ``obs_flight_*`` gauges, the process label and
``crash()``'s recorder dump) and the chaos sites of the heartbeat
(``serving.gateway_kill``, ``cell.blackout``); ``DLROVER_TPU_FAULTS`` is
refused where a fleet process starts.  The gateway side imports no torch.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from dlrover_tpu_torch.agent.metrics import Histogram
from dlrover_tpu_torch.common.hashring import HashRing, ring_hash  # noqa: F401
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    BaseResponse,
    KVStoreDelete,
    KVStoreGet,
    KVStoreScan,
    KVStoreScanResult,
    KVStoreSet,
    KVStoreValue,
    Message,
    ServeAck,
    ServeDone,
    ServeDrainRequest,
    ServeFleetStatsRequest,
    ServeGrants,
    ServeKvReady,
    ServeKvReject,
    ServeReplicaDeregister,
    ServeReplicaPoll,
    ServeReplicaRegister,
    ServeStatusReply,
    ServeStatusRequest,
    ServeSubmit,
    ServeTokens,
)
from dlrover_tpu_torch.serving.gateway import Gateway, GatewayConfig


# ---------------------------------------------------------------------------
# Registry KV backends
# ---------------------------------------------------------------------------


class LocalKv:
    """In-process KV backend with the registry's contract (set / get /
    scan / delete) — the test and smoke-bench substrate, and the store
    behind :class:`RegistryServer`."""

    def __init__(self):
        self._mu = threading.Lock()
        self._store: Dict[str, bytes] = {}

    def set(self, key: str, value: bytes) -> None:
        with self._mu:
            self._store[key] = bytes(value)

    def get(self, key: str) -> Optional[bytes]:
        with self._mu:
            return self._store.get(key)

    def scan(self, prefix: str) -> Dict[str, bytes]:
        with self._mu:
            return {
                k: v for k, v in self._store.items()
                if k.startswith(prefix)
            }

    def delete(self, key: str) -> bool:
        with self._mu:
            return self._store.pop(key, None) is not None


class MasterKv:
    """The master's KV store as the registry backend: the tier's
    shared state rides the job's existing control plane (``KVStoreSet/
    Get/Scan/Delete`` RPCs through the port's ``MasterClient``)."""

    def __init__(self, master_client):
        self._mc = master_client

    def set(self, key: str, value: bytes) -> None:
        self._mc.kv_store_set(key, value)

    def get(self, key: str) -> Optional[bytes]:
        return self._mc.kv_store_get(key)

    def scan(self, prefix: str) -> Dict[str, bytes]:
        return self._mc.kv_store_scan(prefix)

    def delete(self, key: str) -> bool:
        return self._mc.kv_store_delete(key)


class RpcKv:
    """KV client over a raw address speaking the ``KVStore*`` messages
    — works against a :class:`RegistryServer` or a master; what the
    gateway/replica/driver subprocesses of an e2e use."""

    def __init__(self, addr: str, timeout: float = 5.0):
        from dlrover_tpu_torch.common.rpc import RpcClient

        self._c = RpcClient(addr, timeout=timeout)

    def set(self, key: str, value: bytes) -> None:
        self._c.call(KVStoreSet(key=key, value=value), deadline=5.0,
                     idempotent=True)

    def get(self, key: str) -> Optional[bytes]:
        resp = self._c.call(KVStoreGet(key=key), deadline=5.0,
                            idempotent=True)
        if isinstance(resp, KVStoreValue) and resp.found:
            return resp.value
        return None

    def scan(self, prefix: str) -> Dict[str, bytes]:
        resp = self._c.call(KVStoreScan(prefix=prefix), deadline=5.0,
                            idempotent=True)
        return resp.kvs if isinstance(resp, KVStoreScanResult) else {}

    def delete(self, key: str) -> bool:
        # Tokened: a DEADLINE-retried delete must
        # answer what the FIRST attempt did, not "key already gone".
        resp = self._c.call(
            KVStoreDelete(key=key, token=uuid.uuid4().hex),
            deadline=5.0, idempotent=True,
        )
        return bool(getattr(resp, "success", False))

    def close(self) -> None:
        self._c.close()


class RegistryServer:
    """Standalone registry: a :class:`LocalKv` behind the repo RPC,
    answering the same ``KVStore*`` messages as the master — so a
    serving fleet without a training master still has a shared
    registry, and every e2e/bench runs the REAL wire path."""

    def __init__(self, port: int = 0):
        from dlrover_tpu_torch.common.rpc import RpcServer, local_ip
        from dlrover_tpu_torch.common.token_cache import BoundedTokenCache

        self.kv = LocalKv()
        # Tokened delete dedupe: the wire path is
        # DEADLINE-retried; the reply must be the FIRST attempt's.
        # BoundedTokenCache is not thread-safe by itself and handle()
        # runs on the RPC thread pool, so the check-delete-put
        # sequence holds one lock — a retry racing its own slow first
        # attempt must not double-pop and latch the wrong answer.
        self._del_tokens = BoundedTokenCache()
        self._del_mu = threading.Lock()
        self._server = RpcServer(port, self.handle)
        self._server.start()
        self.addr = f"{local_ip()}:{self._server.port}"

    def handle(self, msg: Message) -> Optional[Message]:
        if isinstance(msg, KVStoreSet):
            self.kv.set(msg.key, msg.value)
            return BaseResponse(success=True)
        if isinstance(msg, KVStoreGet):
            val = self.kv.get(msg.key)
            return KVStoreValue(key=msg.key, value=val or b"",
                                found=val is not None)
        if isinstance(msg, KVStoreScan):
            return KVStoreScanResult(kvs=self.kv.scan(msg.prefix))
        if isinstance(msg, KVStoreDelete):
            with self._del_mu:
                cached = self._del_tokens.get(msg.token)
                if cached is not None:
                    return BaseResponse(success=bool(cached))
                found = self.kv.delete(msg.key)
                self._del_tokens.put(msg.token, found)
            return BaseResponse(success=found)
        return BaseResponse(
            success=False, reason=f"unhandled {type(msg).__name__}"
        )

    def stop(self) -> None:
        self._server.stop()


# ---------------------------------------------------------------------------
# The shared registry
# ---------------------------------------------------------------------------


class ServeRegistry:
    """Leased gateway/replica announcements in a shared KV store.

    Entries are JSON values carrying a heartbeat timestamp, but
    liveness is judged by READER-SIDE OBSERVATION: each registry
    handle remembers when it last saw an entry's timestamp *change*
    (on its own clock) and treats the entry as dead once it has gone
    ``lease_s`` without changing.  Writer and reader clocks are never
    compared — a client host whose wall clock is skewed past the lease
    would otherwise see a perfectly healthy fleet as empty (or keep a
    dead gateway alive), and a skewed member's sweep would delete its
    peers' fresh entries.  The trade: a fresh reader grants an already
    -dead entry up to one lease of grace before declaring it (the ring
    converges within ``lease_s`` either way, and long-lived members'
    sweeps physically remove the garbage).

    Dead entries are invisible in :meth:`gateways`/:meth:`replicas` at
    the very next read; :meth:`gc_stale` physically deletes them.
    Keys are namespaced per job so two jobs sharing one master KV
    never see each other's fleets."""

    #: KV namespace and the leased sub-spaces under it.  Subclasses
    #: (the reference's cell registry) override these two and inherit the
    #: reader-side lease machinery unchanged — one lease implementation
    #: for every fleet-membership surface.
    NAMESPACE = "serve"
    SUBSPACES = ("gw/", "rep/")

    def __init__(self, kv, job: str = "default", lease_s: float = 10.0,
                 clock: Callable[[], float] = time.time):
        self.kv = kv
        self.job = job
        self.lease_s = float(lease_s)
        self._clock = clock
        self._prefix = f"{self.NAMESPACE}/{job}/"
        #: key -> (last seen ts VALUE, local time that value appeared).
        self._seen: Dict[str, Tuple[float, float]] = {}

    # -- key layout -------------------------------------------------------

    def gw_key(self, gid: str) -> str:
        return f"{self._prefix}gw/{gid}"

    def rep_key(self, rid: str) -> str:
        return f"{self._prefix}rep/{rid}"

    # -- gateways ---------------------------------------------------------

    def announce_gateway(self, gid: str, addr: str) -> None:
        now = self._clock()
        self.kv.set(self.gw_key(gid), json.dumps(
            {"addr": addr, "ts": now}
        ).encode())
        # The announcing handle observed its own heartbeat: its reads
        # age the entry from NOW, not from a first-read grace.
        self._seen[self.gw_key(gid)] = (now, now)

    def remove_gateway(self, gid: str) -> None:
        self.kv.delete(self.gw_key(gid))
        self._seen.pop(self.gw_key(gid), None)

    def gateways(self) -> Dict[str, str]:
        """Live (lease-valid) gateway id -> addr."""
        out: Dict[str, str] = {}
        for key, raw in self.kv.scan(f"{self._prefix}gw/").items():
            ent = self._parse(key, raw)
            if ent is None:
                continue
            if self._observe_live(key, float(ent.get("ts", 0.0))):
                out[key.rsplit("/", 1)[1]] = ent.get("addr", "")
        return out

    # -- replicas ---------------------------------------------------------

    def announce_replica(self, rid: str, slots: int,
                         role: str = "unified",
                         kv_addr: str = "") -> None:
        now = self._clock()
        self.kv.set(self.rep_key(rid), json.dumps({
            "slots": int(slots), "role": role or "unified",
            "kv_addr": kv_addr, "ts": now,
        }).encode())
        self._seen[self.rep_key(rid)] = (now, now)

    def remove_replica(self, rid: str) -> None:
        self.kv.delete(self.rep_key(rid))
        self._seen.pop(self.rep_key(rid), None)

    def replicas(self) -> Dict[str, dict]:
        """Live replica id -> {slots, role, kv_addr}."""
        out: Dict[str, dict] = {}
        for key, raw in self.kv.scan(f"{self._prefix}rep/").items():
            ent = self._parse(key, raw)
            if ent is None:
                continue
            if self._observe_live(key, float(ent.get("ts", 0.0))):
                out[key.rsplit("/", 1)[1]] = ent
        return out

    # -- maintenance ------------------------------------------------------

    def gc_stale(self) -> List[str]:
        """Physically delete lease-expired entries — expiry judged by
        THIS handle's observation window, so a clock-skewed member can
        never delete peers' fresh entries (any tier member may sweep;
        deletes are idempotent).  Returns the deleted keys."""
        dead: List[str] = []
        for sub in self.SUBSPACES:
            for key, raw in self.kv.scan(self._prefix + sub).items():
                ent = self._parse(key, raw)
                if ent is None or not self._observe_live(
                    key, float(ent.get("ts", 0.0))
                ):
                    if self.kv.delete(key):
                        self._seen.pop(key, None)
                        dead.append(key)
        if dead:
            logger.info("serve registry: GC'd stale entries %s", dead)
        return dead

    def _observe_live(self, key: str, ts_value: float) -> bool:
        """Reader-side lease: live while the entry's heartbeat VALUE
        keeps changing within ``lease_s`` of this handle's clock."""
        now = self._clock()
        seen = self._seen.get(key)
        if seen is None or seen[0] != ts_value:
            self._seen[key] = (ts_value, now)
            return True
        return now - seen[1] <= self.lease_s

    def _parse(self, key: str, raw: bytes) -> Optional[dict]:
        try:
            return json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            logger.warning(
                "serve registry: undecodable entry %s dropped", key
            )
            return None


# ---------------------------------------------------------------------------
# One gateway of the tier
# ---------------------------------------------------------------------------


class GatewayTierNode:
    """One gateway process of a sharded tier: a plain :class:`Gateway`
    plus the registry heartbeat.  The node does NOT know its peers —
    ownership lives in the clients' rings over the registry, so
    gateways need zero coordination; failover is purely the dead
    node's lease aging out."""

    def __init__(self, gateway_id: str, registry: ServeRegistry,
                 port: int = 0,
                 config: Optional[GatewayConfig] = None,
                 heartbeat_s: float = 1.0, addr: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 cell_id: str = "", **gateway_kw):
        from dlrover_tpu_torch.common.rpc import local_ip

        self.gateway_id = gateway_id
        #: Which cell this gateway belongs to ("" = single-cell tier).
        #: The reference's ``cell.blackout`` chaos site selects a process
        #: by it; the port keeps the attribute (the chaos layer is not
        #: ported).
        self.cell_id = cell_id
        self.registry = registry
        self.gateway = Gateway(port=port, config=config, **gateway_kw)
        # ONE clock with the wrapped gateway: the
        # merged-metrics TTL and the heartbeat GC throttle advance
        # with whatever clock the gateway was built on.
        self._clock = self.gateway._clock
        self._heartbeat_s = heartbeat_s
        self._addr_override = addr
        self._local_ip = local_ip()
        self._last_gc = float("-inf")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        gid = gateway_id
        extras = self.gateway.core.snapshot_extras

        def tier_extras():
            out = extras() if extras is not None else {}
            out["gateway_id"] = gid
            return out

        self.gateway.core.snapshot_extras = tier_extras
        #: Optional /metrics endpoint: OFF by default (None); a port
        #: (0 = ephemeral) serves this gateway's own CounterSet/Histogram
        #: gauges and the MERGED tier view over the shared registry.
        self.metrics: Optional[Any] = None
        self._metrics_set: Optional[_GatewaySet] = None
        if metrics_port is not None:
            self._start_metrics(metrics_port)

    def _start_metrics(self, port: int) -> None:
        """Prometheus endpoint for one tier gateway: own gauges +
        merged tier view."""
        from dlrover_tpu_torch.agent.metrics import (
            MetricsRegistry,
            MetricsServer,
        )

        registry = MetricsRegistry()
        self.gateway.register_gauges(registry)
        # Merged tier view: the same union this node's TierActuator
        # consumers see, TTL-cached — a scrape must not fan RPCs out
        # to every peer gateway more than once per interval.
        self._metrics_set = _GatewaySet(self.registry)
        cache = {"ts": float("-inf"), "snap": {}}

        def _merged():
            now = self._clock()
            if now - cache["ts"] > 2.0:
                snaps = [self.gateway.core.stats_snapshot()]
                snaps.extend(
                    s for s in _fetch_gateway_stats(self._metrics_set)
                    if s.get("gateway_id") != self.gateway_id
                )
                cache["snap"] = merge_snapshots(snaps)
                cache["ts"] = now
            return cache["snap"]

        def _tier_gauge(key):
            def read():
                return float(_merged().get(key, 0.0))
            return read

        for key in ("queue_depth", "in_flight", "replicas_alive",
                    "gateways", "occupancy", "ttft_p95_ms",
                    "latency_p95_ms"):
            registry.gauge(f"tier_{key}", _tier_gauge(key))

        self.metrics = MetricsServer(registry, port)
        self.metrics.start()

    @property
    def metrics_port(self) -> Optional[int]:
        return self.metrics.port if self.metrics is not None else None

    @property
    def addr(self) -> str:
        if self._addr_override:
            return self._addr_override
        return f"{self._local_ip}:{self.gateway.port}"

    @property
    def core(self):
        return self.gateway.core

    def start(self) -> None:
        self.gateway.start()
        self.registry.announce_gateway(self.gateway_id, self.addr)
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._heartbeat_loop,
                name=f"gw-tier-{self.gateway_id}", daemon=True,
            )
            self._thread.start()
        logger.info(
            "gateway tier node %s up at %s (job %s)",
            self.gateway_id, self.addr, self.registry.job,
        )

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_s):
            try:
                self.registry.announce_gateway(
                    self.gateway_id, self.addr
                )
                # The sweep is hygiene, not liveness (readers filter
                # stale entries themselves): one full-namespace scan
                # per LEASE per gateway, not per heartbeat.
                now = self._clock()
                if now - self._last_gc >= self.registry.lease_s:
                    self._last_gc = now
                    self.registry.gc_stale()
            except Exception:  # noqa: BLE001 - heartbeat must survive
                logger.exception(
                    "gateway %s registry heartbeat failed",
                    self.gateway_id,
                )

    def _stop_metrics(self) -> None:
        if self.metrics is not None:
            try:
                self.metrics.stop()
            except Exception:  # noqa: BLE001 - teardown
                logger.debug("metrics server stop failed",
                             exc_info=True)
            self.metrics = None
        if self._metrics_set is not None:
            self._metrics_set.close()
            self._metrics_set = None

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.registry.remove_gateway(self.gateway_id)
        except Exception:  # noqa: BLE001 - best-effort deregistration
            logger.warning("gateway %s deregistration failed",
                           self.gateway_id, exc_info=True)
        self._stop_metrics()
        self.gateway.stop(grace)

    def crash(self) -> None:
        """Die WITHOUT deregistering: heartbeats stop, the RPC server
        closes, the registry entry is left to age out — exactly what a
        killed gateway process looks like to the fleet."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._stop_metrics()
        self.gateway.stop(0.0)


# ---------------------------------------------------------------------------
# Transport plumbing shared by clients and replicas
# ---------------------------------------------------------------------------


def _default_connect(addr: str):
    from dlrover_tpu_torch.common.rpc import RpcClient

    return RpcClient(addr, timeout=5.0)


class _GatewaySet:
    """Cached registry view + per-address transports.  ``connect`` is
    injectable (loopback fleets); dead transports are dropped when the
    registry drops the gateway or a call errors."""

    def __init__(self, registry: ServeRegistry,
                 connect: Optional[Callable[[str], Any]] = None,
                 refresh_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self._connect = connect or _default_connect
        self._refresh_s = refresh_s
        self._clock = clock
        self._mu = threading.Lock()
        self._gws: Dict[str, str] = {}  # gid -> addr
        self._transports: Dict[str, Any] = {}  # gid -> transport
        self._ring = HashRing(())
        self._last_refresh = float("-inf")

    def refresh(self, force: bool = False) -> Dict[str, str]:
        with self._mu:
            now = self._clock()
            if not force and now - self._last_refresh < self._refresh_s \
                    and self._gws:
                return dict(self._gws)
            try:
                gws = self.registry.gateways()
            except Exception as e:  # noqa: BLE001 - keep the last view
                logger.warning("gateway registry read failed: %s", e)
                return dict(self._gws)
            self._last_refresh = now
            if gws != self._gws:
                for gid in list(self._transports):
                    if gws.get(gid) != self._gws.get(gid):
                        self._close_locked(gid)
                self._gws = gws
                self._ring = HashRing(gws)
            return dict(self._gws)

    def drop(self, gid: str) -> None:
        """Forget a gateway whose transport just errored and force the
        next refresh.  No registry sweep here: liveness is the
        reader-side lease (the entry goes invisible on its own once
        its heartbeat stops changing), and a transport blip must not
        cost a full-namespace scan per error."""
        with self._mu:
            self._close_locked(gid)
            self._last_refresh = float("-inf")

    def owner(self, req_id: str) -> Optional[str]:
        with self._mu:
            return self._ring.owner(req_id)

    def transport(self, gid: str):
        with self._mu:
            tr = self._transports.get(gid)
            if tr is None:
                addr = self._gws.get(gid)
                if not addr:
                    return None
                tr = self._connect(addr)
                self._transports[gid] = tr
            return tr

    def items(self) -> List[Tuple[str, str]]:
        with self._mu:
            return list(self._gws.items())

    def close(self) -> None:
        with self._mu:
            for gid in list(self._transports):
                self._close_locked(gid)

    def _close_locked(self, gid: str) -> None:
        tr = self._transports.pop(gid, None)
        close = getattr(tr, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - teardown
                logger.debug("transport close failed", exc_info=True)


# ---------------------------------------------------------------------------
# Client side: consistent-hash routing + failover resubmit
# ---------------------------------------------------------------------------


def _fetch_gateway_stats(gw_set: _GatewaySet) -> List[Dict[str, Any]]:
    """One ``ServeFleetStatsRequest`` per live gateway in ``gw_set``,
    skipping (and dropping) unreachable ones — the shared read loop
    behind :meth:`TierClient.stats` and :class:`TierActuator`."""
    snaps: List[Dict[str, Any]] = []
    gw_set.refresh()
    for gid, _addr in gw_set.items():
        tr = gw_set.transport(gid)
        if tr is None:
            continue
        try:
            resp = tr.call(ServeFleetStatsRequest(), deadline=10.0)
        except Exception:  # noqa: BLE001 - skip dead gateways
            gw_set.drop(gid)
            continue
        stats = getattr(resp, "stats", None)
        if isinstance(stats, dict):
            snaps.append(stats)
    return snaps


class TierClient:
    """Submit/poll against a sharded gateway tier.

    The owner of a request id is a pure function of (req_id, live
    gateway set); the client refreshes the set from the registry and
    re-routes when it changes.  Failover contract: if the owner dies
    mid-flight, the request id hashes to a NEW owner (the adopted
    range), which answers ``unknown`` — the client RESUBMITS the same
    req_id there (prompts are cached until terminal).  The new owner
    re-dispatches; a replica that already served it answers from its
    journal, the dedupe cache absorbs duplicate completions, and the
    client sees exactly one terminal result."""

    def __init__(self, registry: ServeRegistry,
                 connect: Optional[Callable[[str], Any]] = None,
                 poll_interval: float = 0.02, refresh_s: float = 0.5):
        self._set = _GatewaySet(registry, connect, refresh_s)
        self._poll_interval = poll_interval
        self._mu = threading.Lock()
        #: req_id -> submit kwargs, for failover resubmission; dropped
        #: at the terminal result.
        self._inflight: Dict[str, dict] = {}
        self.resubmitted = 0

    def _owner_transport(self, req_id: str):
        self._set.refresh()
        gid = self._set.owner(req_id)
        if gid is None:
            return None, None
        return gid, self._set.transport(gid)

    def submit(self, req_id: str, prompt, max_new_tokens: int,
               deadline_s: float = 0.0, submit_timeout: float = 30.0,
               prefix_len: int = 0, prefix_fp: str = "") -> ServeAck:
        """Owner-routed submit honouring rejection backpressure (sleep
        ``retry_after_s`` and retry until ``submit_timeout``) and
        transport failures (drop the gateway, re-resolve, retry)."""
        if prefix_len and not prefix_fp:
            from dlrover_tpu_torch.serving.replica import prefix_fingerprint

            prefix_fp = prefix_fingerprint(prompt[:prefix_len])
        msg = ServeSubmit(
            req_id=req_id, prompt=[int(t) for t in prompt],
            max_new_tokens=max_new_tokens, deadline_s=deadline_s,
            prefix_len=prefix_len, prefix_fp=prefix_fp,
        )
        with self._mu:
            self._inflight[req_id] = {"msg": msg}
            # Bounded: entries normally leave at the terminal result,
            # but a caller that abandons accepted requests must not
            # grow this forever (oldest-first — dict order is
            # insertion order).
            while len(self._inflight) > 8192:
                self._inflight.pop(next(iter(self._inflight)))
        start = time.monotonic()
        last: Any = ServeAck(req_id=req_id, status="rejected",
                             reason="no live gateway")
        while time.monotonic() - start < submit_timeout:
            gid, tr = self._owner_transport(req_id)
            if tr is None:
                time.sleep(0.1)
                continue
            try:
                ack = tr.call(msg, deadline=10.0)
            except Exception as e:  # noqa: BLE001 - failover path
                logger.warning(
                    "tier client: submit %s to %s failed (%s); "
                    "re-routing", req_id, gid, e,
                )
                self._set.drop(gid)
                continue
            if not isinstance(ack, ServeAck):
                return ack
            if ack.status != "rejected":
                if ack.status not in ("accepted",):
                    self._forget(req_id)  # dedupe-cache terminal
                return ack
            last = ack
            wait = max(0.01, ack.retry_after_s)
            if time.monotonic() - start + wait > submit_timeout:
                break
            time.sleep(wait)
        # Never admitted (backpressure to the timeout, or no live
        # gateway): the caller was told so — a later status() poll
        # must NOT silently resubmit work the caller may have retried
        # under a fresh id.
        self._forget(req_id)
        return last

    def call(self, msg, deadline: float = 10.0):
        """Owner-route one RAW admission message (ServeSubmit /
        ServeStatusRequest) — the cross-cell spillover door.  A forwarded submit must keep its ``spill_from`` /
        ``spill_hops`` marks and its original trace context, which
        the kwarg surface of :meth:`submit` would rebuild without;
        routing it raw also hands the forward the sibling cell's own
        ring routing and gateway failover."""
        req_id = getattr(msg, "req_id", "")
        gid, tr = self._owner_transport(req_id)
        if tr is None:
            raise RuntimeError("no live gateway")
        try:
            return tr.call(msg, deadline=deadline)
        except Exception:
            self._set.drop(gid)
            raise

    def status(self, req_id: str) -> ServeStatusReply:
        gid, tr = self._owner_transport(req_id)
        if tr is None:
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason="no live gateway")
        try:
            reply = tr.call(ServeStatusRequest(req_id=req_id),
                            deadline=10.0)
        except Exception as e:  # noqa: BLE001 - failover path
            self._set.drop(gid)
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(e))
        if not isinstance(reply, ServeStatusReply):
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(reply))
        if reply.state == "unknown":
            self._maybe_resubmit(req_id)
        return reply

    def result(self, req_id: str, timeout: float = 60.0
               ) -> ServeStatusReply:
        """Poll to a terminal state, riding out gateway failovers."""
        deadline = time.monotonic() + timeout
        while True:
            reply = self.status(req_id)
            if reply.state in ("done", "failed", "timeout"):
                self._forget(req_id)
                return reply
            if time.monotonic() >= deadline:
                return reply
            time.sleep(self._poll_interval)

    def stats(self) -> List[dict]:
        """One stats snapshot per live gateway (skipping unreachable
        ones) — :func:`merge_snapshots` input."""
        return _fetch_gateway_stats(self._set)

    def close(self) -> None:
        self._set.close()

    # -- internals --------------------------------------------------------

    def _forget(self, req_id: str) -> None:
        with self._mu:
            self._inflight.pop(req_id, None)

    def _maybe_resubmit(self, req_id: str) -> None:
        """The owner answered ``unknown`` for a request we believe is
        in flight: the original owner died and this gateway adopted its
        range without its queue.  Resubmit (idempotent: if the request
        actually finished, a replica's journal replay or the dedupe
        cache answers without re-decoding)."""
        with self._mu:
            ent = self._inflight.get(req_id)
        if ent is None:
            return
        gid, tr = self._owner_transport(req_id)
        if tr is None:
            return
        try:
            ack = tr.call(ent["msg"], deadline=10.0)
        except Exception as e:  # noqa: BLE001 - next poll retries
            logger.warning(
                "tier client: failover resubmit of %s failed: %s",
                req_id, e,
            )
            return
        self.resubmitted += 1
        logger.info(
            "tier client: resubmitted %s to %s after gateway "
            "failover (ack=%s)", req_id, gid,
            getattr(ack, "status", ack),
        )


# ---------------------------------------------------------------------------
# Replica side: poll every gateway that owns work for you
# ---------------------------------------------------------------------------


class TierReplicaLink:
    """The fan-out transport a :class:`ReplicaRunner` uses against a
    sharded tier — same ``call(msg, **kw)`` convention, so the runner
    is unchanged.

    - ``ServeReplicaRegister``/``Deregister`` broadcast to every live
      gateway (and to gateways that appear later, before their first
      poll).
    - ``ServeReplicaPoll`` fans out in ROTATING order (no gateway gets
      permanent first claim on this replica's slots): each gateway is
      offered the slots still free after earlier grants in the same
      fan-out, every gateway still sees the full owned set (its
      reconcile needs it), grants/cancels merge, and ``drain`` is the
      AND of the flags (each gateway must have released the replica).
      A ``known=False`` reply re-registers at THAT gateway only —
      re-registering broadcast-wide would needlessly requeue healthy
      gateways' assigned work.
    - Terminal reports (``ServeDone``/``ServeTokens``/``ServeKvReady``/
      ``ServeKvReject``) route to the gateway that GRANTED the request;
      if it died, to the current ring owner of the req_id — which is
      the adopted range, exactly where the client resubmitted, so
      journal replays land where the request now lives."""

    def __init__(self, registry: ServeRegistry, replica_id: str,
                 connect: Optional[Callable[[str], Any]] = None,
                 refresh_s: float = 1.0):
        self._set = _GatewaySet(registry, connect, refresh_s)
        self.replica_id = replica_id
        self.registry = registry
        self._mu = threading.Lock()
        self._granted_by: Dict[str, str] = {}  # rid -> granting gid
        self._registered: set = set()
        self._register_msg: Optional[ServeReplicaRegister] = None
        self._rotate = 0

    # -- transport convention ---------------------------------------------

    def call(self, msg: Message, **_kw) -> Optional[Message]:
        if isinstance(msg, ServeReplicaRegister):
            self._register_msg = msg
            # Refresh + announce in the shared registry too: the
            # registry is how NEW gateways (scale-out, failover
            # replacements) learn the fleet before replicas poll them.
            try:
                self.registry.announce_replica(
                    msg.replica_id, msg.slots, msg.role,
                )
            except Exception:  # noqa: BLE001 - best-effort announce
                logger.warning("replica registry announce failed",
                               exc_info=True)
            self._set.refresh(force=True)
            for gid, _addr in self._set.items():
                self._register_at(gid)
            return BaseResponse(success=True)
        if isinstance(msg, ServeReplicaDeregister):
            try:
                self.registry.remove_replica(msg.replica_id)
            except Exception:  # noqa: BLE001 - best-effort removal
                logger.debug("replica registry removal failed",
                             exc_info=True)
            for gid, _addr in self._set.items():
                self._send_to(gid, msg)
            self._registered.clear()
            return BaseResponse(success=True)
        if isinstance(msg, ServeReplicaPoll):
            return self._fanout_poll(msg)
        if isinstance(msg, (ServeDone, ServeTokens, ServeKvReady,
                            ServeKvReject)):
            return self._route_report(msg)
        # Anything else goes to an arbitrary live gateway.
        for gid, _addr in self._set.items():
            reply = self._send_to(gid, msg)
            if reply is not None:
                return reply
        return BaseResponse(success=False, reason="no live gateway")

    # -- internals --------------------------------------------------------

    def _register_at(self, gid: str) -> None:
        if self._register_msg is None:
            return
        if self._send_to(gid, self._register_msg) is not None:
            self._registered.add(gid)

    def _send_to(self, gid: str, msg: Message) -> Optional[Message]:
        tr = self._set.transport(gid)
        if tr is None:
            return None
        try:
            return tr.call(msg, deadline=10.0)
        except Exception as e:  # noqa: BLE001 - lease machinery heals
            logger.warning(
                "replica %s: %s to gateway %s failed: %s",
                self.replica_id, type(msg).__name__, gid, e,
            )
            self._set.drop(gid)
            self._registered.discard(gid)
            return None

    def _fanout_poll(self, msg: ServeReplicaPoll) -> ServeGrants:
        self._set.refresh()
        items = self._set.items()
        if not items:
            # No live gateway: nothing granted, keep serving in-flight.
            return ServeGrants(known=True)
        # Rotate so slot claims are fair across gateways over time.
        self._rotate = (self._rotate + 1) % len(items)
        items = items[self._rotate:] + items[:self._rotate]
        free = max(0, int(msg.free_slots))
        merged = ServeGrants(known=True)
        drain_votes: List[bool] = []
        for gid, _addr in items:
            if gid not in self._registered:
                self._register_at(gid)
            sub = ServeReplicaPoll(
                replica_id=msg.replica_id, free_slots=free,
                active=msg.active, stats=msg.stats,
                warm_prefixes=msg.warm_prefixes,
            )
            reply = self._send_to(gid, sub)
            if not isinstance(reply, ServeGrants):
                continue
            if not reply.known:
                # THIS gateway restarted/lost us: re-register there
                # only; its next poll hands work again.
                self._registered.discard(gid)
                self._register_at(gid)
                continue
            with self._mu:
                for grant in reply.requests:
                    self._granted_by[grant.req_id] = gid
                for rid in reply.cancel:
                    # A cancelled request produces no terminal report
                    # from this replica: prune its route now.
                    self._granted_by.pop(rid, None)
                # Safety bound: routes normally leave at the terminal
                # report, but a grant the runner dropped (chaos, a
                # capacity race) must not leak an entry forever; an
                # evicted route just falls back to the ring owner.
                while len(self._granted_by) > 8192:
                    self._granted_by.pop(
                        next(iter(self._granted_by))
                    )
            merged.requests.extend(reply.requests)
            free = max(0, free - len(reply.requests))
            merged.cancel.extend(reply.cancel)
            drain_votes.append(reply.drain)
            if reply.draft_addr and not merged.draft_addr:
                # Draft endpoint: first gateway offering
                # one wins — draft replicas register at EVERY gateway,
                # so any offer names a live proposal server.
                merged.draft_addr = reply.draft_addr
        merged.drain = bool(drain_votes) and all(drain_votes)
        return merged

    def _route_report(self, msg) -> Optional[Message]:
        rid = msg.req_id
        with self._mu:
            gid = self._granted_by.get(rid)
        reply = self._send_to(gid, msg) if gid is not None else None
        if reply is None:
            # Granting gateway gone (or unknown — journal replay at
            # startup): the current ring owner of the req_id holds the
            # failover copy.
            self._set.refresh()
            owner = self._set.owner(rid)
            if owner is not None and owner != gid:
                reply = self._send_to(owner, msg)
        if isinstance(msg, (ServeDone, ServeKvReject, ServeKvReady)):
            # All three end THIS replica's ownership of the rid (a
            # prefill's terminal report is ServeKvReady — the decode
            # grant re-records a route if it lands here again).
            with self._mu:
                self._granted_by.pop(rid, None)
        return reply

    def close(self) -> None:
        self._set.close()


# ---------------------------------------------------------------------------
# Tier-wide autoscale signals
# ---------------------------------------------------------------------------


def merge_snapshots(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-gateway ``stats_snapshot`` dicts into one fleet view
    the PURE ``decide``/``decide_pools`` policies consume unchanged.

    - queue depths / in-flight / counters: sums (each gateway owns a
      disjoint hash range, so its queues and counters are disjoint);
    - replicas: UNION by replica id (every replica registers at every
      gateway) with per-gateway ``assigned`` summed;
    - occupancy/pools: recomputed from the union so a replica's slots
      are never double-counted;
    - ``ttft_p95_ms``/``latency_p95_ms``: percentiles of the
      BUCKET-WISE MERGED histograms (``Histogram.merged`` over the
      per-gateway ``*_hist`` states) — merging the per-gateway p95s
      themselves is the unmergeable-signal mistake this exists to
      avoid."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {
            "queue_depth": 0, "in_flight": 0, "replicas_alive": 0,
            "occupancy": 0.0, "counters": {}, "replicas": {},
            "pools": {}, "gateways": 0,
        }
    replicas: Dict[str, dict] = {}
    counters: Dict[str, int] = {}
    sums = {"queue_depth": 0, "in_flight": 0, "queue_prefill": 0,
            "queue_kv_ready": 0}
    pool_queues: Dict[str, int] = {}
    for snap in snaps:
        for key in sums:
            sums[key] += int(snap.get(key, 0))
        for name, val in snap.get("counters", {}).items():
            counters[name] = counters.get(name, 0) + int(val)
        for role, pool in snap.get("pools", {}).items():
            pool_queues[role] = pool_queues.get(role, 0) + int(
                pool.get("queue_depth", 0)
            )
        for rid, rep in snap.get("replicas", {}).items():
            ent = replicas.get(rid)
            if ent is None:
                ent = dict(rep)
                ent["assigned"] = 0
                replicas[rid] = ent
            ent["assigned"] += int(rep.get("assigned", 0))
            ent["draining"] = bool(ent.get("draining")) or bool(
                rep.get("draining")
            )
    alive = {
        rid: r for rid, r in replicas.items() if not r.get("draining")
    }
    total_slots = sum(int(r.get("slots", 0)) for r in alive.values())
    total_assigned = sum(int(r["assigned"]) for r in alive.values())
    from dlrover_tpu_torch.serving.autoscale import (
        draft_pool_tokens_per_round,
        mean_measured,
    )

    def _tpr(r) -> float:
        try:
            return float(
                (r.get("stats") or {}).get("tokens_per_round", 0.0)
            )
        except (TypeError, ValueError):
            return 0.0

    pools: Dict[str, Dict[str, Any]] = {}
    for role in ("unified", "prefill", "decode", "draft"):
        members = [
            r for r in alive.values()
            if r.get("role", "unified") == role
        ]
        slots = sum(int(r.get("slots", 0)) for r in members)
        assigned = sum(int(r["assigned"]) for r in members)
        pools[role] = {
            "alive": len(members),
            "slots": slots,
            "assigned": assigned,
            "occupancy": assigned / slots if slots else 0.0,
            "queue_depth": pool_queues.get(role, 0),
            "tokens_per_round": mean_measured(
                _tpr(r) for r in members
            ),
        }
    # Draft pool earned value = the acceptance its CONSUMERS (spec
    # targets) report — ONE convention, shared with the per-gateway
    # snapshot via serving.autoscale.
    pools["draft"]["tokens_per_round"] = draft_pool_tokens_per_round(
        (bool(r.get("spec")), r.get("role", "unified"), _tpr(r))
        for r in alive.values()
    )
    merged: Dict[str, Any] = {
        **sums,
        "replicas_alive": len(alive),
        "replicas_draining": len(replicas) - len(alive),
        "occupancy": (
            total_assigned / total_slots if total_slots else 0.0
        ),
        "counters": counters,
        "replicas": replicas,
        "pools": pools,
        "gateways": len(snaps),
        "gateway_ids": sorted(
            str(s.get("gateway_id")) for s in snaps
            if s.get("gateway_id") is not None
        ),
    }
    for hist_key, p95_key in (("ttft_hist", "ttft_p95_ms"),
                              ("latency_hist", "latency_p95_ms")):
        states = [s[hist_key] for s in snaps if s.get(hist_key)]
        if states:
            try:
                agg = Histogram.merged(states)
                merged[p95_key] = agg.percentile(0.95)
                merged[hist_key] = agg.state()
                continue
            except ValueError as e:
                logger.warning("histogram merge failed: %s", e)
        merged[p95_key] = max(
            (float(s.get(p95_key, 0.0)) for s in snaps), default=0.0
        )
    return merged


class TierStats:
    """Merged-snapshot provider for the existing autoscalers: pass
    ``TierStats(fetchers).snapshot`` as their ``snapshot_fn`` and the
    pure ``decide``/``decide_pools`` run over the whole tier.
    ``fetchers`` are zero-arg callables returning one gateway's
    snapshot each (bound ``core.stats_snapshot`` in-process, or a
    ``TierClient.stats``-style RPC read); a fetcher that throws is
    skipped — a dead gateway must not blind the autoscaler."""

    def __init__(self, fetchers: List[Callable[[], Dict[str, Any]]]):
        self.fetchers = list(fetchers)

    def snapshot(self) -> Dict[str, Any]:
        snaps = []
        for fetch in self.fetchers:
            try:
                snaps.append(fetch())
            except Exception:  # noqa: BLE001 - skip dead gateways
                logger.warning("tier stats fetch failed", exc_info=True)
        return merge_snapshots(snaps)


def pick_drain_victim_merged(merged: Dict[str, Any],
                             role: Optional[str] = None) -> Optional[str]:
    """Least-loaded non-draining replica by the TIER-WIDE assigned
    count (the merged snapshot's union view) — the scale-down choice a
    single gateway cannot make correctly once grants are spread across
    the shard (its local ``assigned`` undercounts every replica)."""
    best = None
    for rid, rep in merged.get("replicas", {}).items():
        if rep.get("draining"):
            continue
        if role is not None and rep.get("role", "unified") != role:
            continue
        key = (int(rep.get("assigned", 0)), rid)
        if best is None or key < best[0]:
            best = (key, rid)
    return best[1] if best else None


class TierActuator:
    """Tier-wide serving actuation: the gateway-shaped
    surface the autoscalers and the fleet's serving role drive —
    ``stats_snapshot`` / ``pick_drain_victim`` / ``drain`` — backed by
    the WHOLE multi-gateway fleet instead of one gateway's view.

    - ``stats_snapshot``: :func:`merge_snapshots` over every live
      gateway (a single gateway's snapshot sees only its own hash
      range's queue and its own grants);
    - ``pick_drain_victim``: least-loaded by the merged union view;
    - ``drain``: BROADCAST — a replica registers at every gateway, so
      the drain flag must be set at all of them or the others keep
      granting and the drain never completes.

    Backends: ``cores`` (in-process ``GatewayCore``/``Gateway.core``
    handles — master-side and bench fleets) and/or a ``registry``
    (+``connect``) for subprocess gateways over the wire
    (``ServeDrainRequest`` / ``ServeFleetStatsRequest``).  A
    single-entry actuator behaves exactly like the bare core, so the
    existing ``ServingFleetAutoScaler`` runs unchanged against it."""

    def __init__(self, cores: Optional[List[Any]] = None,
                 registry: Optional[ServeRegistry] = None,
                 connect: Optional[Callable[[str], Any]] = None,
                 refresh_s: float = 1.0):
        self._cores = list(cores or [])
        self._set = (
            _GatewaySet(registry, connect, refresh_s)
            if registry is not None else None
        )

    # -- reads --------------------------------------------------------------

    def _snaps(self) -> List[Dict[str, Any]]:
        snaps = []
        for core in self._cores:
            try:
                snaps.append(core.stats_snapshot())
            except Exception:  # noqa: BLE001 - skip sick gateways
                logger.warning("tier actuator: core snapshot failed",
                               exc_info=True)
        if self._set is not None:
            snaps.extend(_fetch_gateway_stats(self._set))
        return snaps

    def stats_snapshot(self) -> Dict[str, Any]:
        return merge_snapshots(self._snaps())

    def pick_drain_victim(self, role: Optional[str] = None
                          ) -> Optional[str]:
        return pick_drain_victim_merged(self.stats_snapshot(), role)

    # -- writes -------------------------------------------------------------

    def drain(self, replica_id: str) -> bool:
        """Broadcast the drain to every gateway; True if ANY gateway
        knew the replica (late joiners learn the flag when the replica
        re-registers there — drain is sticky per gateway)."""
        any_ok = False
        for core in self._cores:
            try:
                any_ok = core.drain(replica_id) or any_ok
            except Exception:  # noqa: BLE001 - best-effort broadcast
                logger.warning("tier actuator: core drain failed",
                               exc_info=True)
        if self._set is not None:
            self._set.refresh()
            for gid, _addr in self._set.items():
                tr = self._set.transport(gid)
                if tr is None:
                    continue
                try:
                    resp = tr.call(
                        ServeDrainRequest(replica_id=replica_id),
                        deadline=10.0,
                    )
                    any_ok = any_ok or bool(
                        getattr(resp, "success", False)
                    )
                except Exception:  # noqa: BLE001 - dead gateway can't
                    # grant to the victim anyway
                    self._set.drop(gid)
        return any_ok

    def close(self) -> None:
        if self._set is not None:
            self._set.close()
