"""Serving gateway: the fleet's front door — the port's copy of
``dlrover_tpu/serving/gateway.py`` (``GatewayConfig``, ``GatewayCore``,
``Gateway``, ``LoopbackTransport``, ``ServeClient``), held against it.
Trace contexts ride the wire as data (ids derived and drawn as the
reference's ``obs/span.py`` does); no span is recorded and the flight
recorder's ``ObsScrapeRequest`` is not answered (``obs/`` is not ported).
``Gateway.register_gauges`` exports the reference's ``serve_*`` gauges
(``dlrover_tpu/serving/gateway.py:1387-1457``), and ``Gateway.spill_router``
(a ``serving/spillover.py`` ``CellSpillRouter``) takes the submits and
status polls when it is set (``:1372-1375``, ``:1459-1471``).

One :class:`GatewayCore` holds the whole control-plane state machine —
pure Python, injectable clock, no RPC, no torch — so every admission /
routing / deadline / dedupe / drain law is unit-testable in
microseconds.  :class:`Gateway` wraps it with the repo's typed msgpack
RPC (``common/rpc.py``) and a lease sweeper thread.

Design contracts:

- **Bounded admission with explicit backpressure.**  The queue cap
  counts queued + assigned work; past it a submit is REJECTED with a
  ``retry_after_s`` hint instead of growing an unbounded buffer (the
  client backs off; the autoscaler sees the pressure and grows the
  fleet).
- **Exactly-once completion.**  ``req_id`` is the idempotency token:
  completed results live in a :class:`BoundedTokenCache`; a duplicate
  completion (journal replay after a replica kill racing a
  re-dispatch) is counted and dropped, a resubmit of a finished
  request answers from the cache.  The REPLICA's journal decides what
  already completed — the gateway never asks a replica to re-decode
  work its journal can prove finished.
- **Pull routing == least-loaded routing.**  Replicas poll with their
  free-slot count and get up to that many grants; capacity asks for
  work exactly when it exists, so work flows to the least-loaded
  replica without the gateway modelling per-replica speed.
- **Reconciliation.**  Each poll carries the replica's full owned set;
  a grant handed out before the replica's previous poll that the
  replica does not report owning was LOST in flight (or dropped) and
  is re-queued at the front.
- **Drain-aware scale-down.**  A draining replica gets no new grants;
  its poll reply carries ``drain=True`` once, the replica finishes
  in-flight work, deregisters, and exits — no request observes the
  shrink.
- **Prefix-aware routing.**  Requests may carry a prefix
  fingerprint (hash of their leading shared-template tokens); each
  replica's poll reports which templates it holds warm, and the grant
  scan prefers handing a fingerprinted request to a warm replica (the
  admission then costs a row copy + one chunk score instead of a full
  prefill, ~4.4x).  A request whose template is warm ELSEWHERE is
  deferred for that replica — bounded by the stealable-overload guard:
  once the warm holders are saturated or the request has waited
  ``prefix_reserve_s``, any capable replica steals it (counted), so a
  hot prefix can never starve the rest of the queue, and the queue
  scan skips deferred requests so requests BEHIND a hot prefix are
  never starved either.
- **Prefill/decode disaggregation.**  Replicas register a
  role: ``unified`` (the full path), ``prefill`` (score the prompt,
  export the KV segment), or ``decode`` (continue from an imported
  segment).  A queued request granted to a prefill replica follows the
  two-stage path: prefill-grant -> ``kv_ready`` (the CRC-carrying
  segment is held by the gateway and the request re-queues at the
  FRONT for the decode pool) -> decode-grant (segment attached).  Every
  stage rides the existing lease/reconcile/journal/dedupe contracts
  keyed by req_id, so a kill between stages re-queues cleanly: a dead
  prefill replica re-prefills elsewhere, a dead decode replica's grant
  re-ships the SAME held segment, and a torn segment (``ServeKvReject``
  — never decoded from) re-prefills, all bounded by ``max_attempts``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.agent.metrics import CounterSet
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    BaseResponse,
    Message,
    ServeAck,
    ServeDone,
    ServeDrainRequest,
    ServeFleetStats,
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
from dlrover_tpu_torch.common.token_cache import BoundedTokenCache


def trace_id_for(req_id: str) -> str:
    """The trace id of a request, derived as the reference's
    ``obs/span.py`` derives it, so every process agrees on it."""
    return hashlib.sha1(req_id.encode()).hexdigest()[:16]


def new_span_id() -> str:
    """A fresh random span id (``obs/span.py``'s law).  The port carries
    trace contexts on the wire as data and records no span."""
    return os.urandom(8).hex()


class GatewayConfig:
    """Knobs, deliberately a plain object (tests tweak freely)."""

    def __init__(
        self,
        queue_cap: int = 256,
        lease_timeout_s: float = 10.0,
        default_deadline_s: float = 0.0,  # 0 = none
        retry_after_s: float = 0.5,
        done_cache_cap: int = 4096,
        max_attempts: int = 5,
        prefix_reserve_s: float = 2.0,
        kv_p2p: bool = True,
        spec_decode_min_tokens: int = 0,
        spec_reserve_s: float = 2.0,
        trace_sample: float = 1.0,
    ):
        self.queue_cap = queue_cap
        self.lease_timeout_s = lease_timeout_s
        self.default_deadline_s = default_deadline_s
        self.retry_after_s = retry_after_s
        self.done_cache_cap = done_cache_cap
        #: Allow peer-to-peer KV handoff: prefill grants are
        #: issued WITHOUT ``kv_relay`` so a P2P-capable prefill replica
        #: publishes a ticket instead of relaying the payload.  False =
        #: every prefill grant orders the relay path.  Per-request fallback is automatic either way: a
        #: failed pull flips that request to relay on its re-prefill.
        self.kv_p2p = kv_p2p
        #: How long a queued request whose prefix template is warm on a
        #: replica WITH capacity is held for that replica before any
        #: capable replica may steal it (saturated warm holders are
        #: stealable immediately — the overload guard).
        self.prefix_reserve_s = prefix_reserve_s
        #: Re-dispatches a request may survive before it is failed
        #: terminally: a poison request (one that reliably crashes its
        #: replica, or is repeatedly lost) re-queues at the FRONT and
        #: would otherwise head-of-line-block the fleet forever.
        self.max_attempts = max_attempts
        #: Spec-aware routing: a ``full``-stage request
        #: whose max_new_tokens reaches this is a LONG decode — the
        #: grant scan prefers spec-capable replicas for it (the
        #: speculation win scales with decode length; admission cost
        #: is identical).  0 = routing preference off.
        self.spec_decode_min_tokens = int(spec_decode_min_tokens)
        #: How long a long-decode request is held for a spec-capable
        #: replica WITH capacity before any replica may take it (the
        #: prefix_reserve_s shape — saturated spec replicas are
        #: bypassed immediately, so speculation never starves the
        #: queue).
        self.spec_reserve_s = float(spec_reserve_s)
        #: Head-based trace sampling: the fraction of
        #: admitted requests that get a distributed trace, decided HERE
        #: (the head) and deterministically from the request id — every
        #: gateway of a sharded tier makes the identical decision, so a
        #: failover resubmit keeps its sampled/unsampled fate.  1.0 in
        #: tests.  Every unsampled
        #: request is counted (``trace_unsampled``), never silent.
        self.trace_sample = float(trace_sample)


class _Request:
    __slots__ = (
        "req_id", "prompt", "max_new_tokens", "deadline", "submitted_at",
        "attempts", "assigned_to", "grant_seq", "first_token_at",
        "partial", "prefix_len", "prefix_fp", "stage", "kv",
        "kv_addr", "kv_fp", "kv_crc32", "kv_nbytes", "kv_relay",
        "trace_tid", "trace_root", "phase_mark",
    )

    def __init__(self, req_id: str, prompt: List[int],
                 max_new_tokens: int, deadline: Optional[float],
                 now: float, prefix_len: int = 0, prefix_fp: str = ""):
        self.req_id = req_id
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.submitted_at = now
        self.attempts = 0
        self.assigned_to: Optional[str] = None
        self.grant_seq = -1
        self.first_token_at: Optional[float] = None
        self.partial: List[int] = []
        self.prefix_len = int(prefix_len)
        self.prefix_fp = prefix_fp
        #: queued -> (full | prefill) -> kv_ready -> decode; a requeue
        #: falls back to kv_ready when the gateway still holds the
        #: segment OR a ticket for it, queued otherwise (re-prefill).
        self.stage = "queued"
        self.kv: bytes = b""
        # P2P ticket: a non-empty kv_addr means the segment
        # bytes live on the prefill replica's segment server and only
        # the ticket rides the decode grant.  kv_relay flips to True
        # after a failed pull: the NEXT prefill grant orders the
        # through-the-gateway payload path instead.
        self.kv_addr = ""
        self.kv_fp = ""
        self.kv_crc32 = 0
        self.kv_nbytes = 0
        self.kv_relay = False
        # Tracing: trace id + root span id of a SAMPLED
        # request, and the rolling phase mark — each gateway phase
        # span covers [phase_mark, now] and advances the mark, so the
        # phases tile [submitted_at, terminal] EXACTLY on one clock
        # (the per-request TTFT/latency decomposition law).
        self.trace_tid = ""
        self.trace_root = ""
        self.phase_mark = now

    def clear_kv(self) -> None:
        self.kv = b""
        self.kv_addr = ""
        self.kv_fp = ""
        self.kv_crc32 = 0
        self.kv_nbytes = 0

    @property
    def has_kv(self) -> bool:
        return bool(self.kv) or bool(self.kv_addr)


class _Replica:
    __slots__ = (
        "replica_id", "slots", "assigned", "last_seen", "poll_seq",
        "draining", "stats", "role", "warm", "spec", "draft_addr",
        "spec_seen",
    )

    def __init__(self, replica_id: str, slots: int, now: float,
                 role: str = "unified", spec: bool = False,
                 draft_addr: str = ""):
        self.replica_id = replica_id
        self.slots = int(slots)
        self.assigned: Dict[str, _Request] = {}
        self.last_seen = now
        self.poll_seq = 0
        self.draining = False
        self.stats: Dict[str, Any] = {}
        self.role = role or "unified"
        #: Prefix fingerprints held warm — replaced wholesale by every
        #: poll report, so evictions/restarts self-correct the map.
        self.warm: set = set()
        #: Speculative capability + (draft role) proposal-server addr
        #:.
        self.spec = bool(spec)
        self.draft_addr = draft_addr or ""
        #: Last cumulative spec counters seen in a poll report — the
        #: baseline the gateway's counter deltas fold from (reset on
        #: restart: a smaller report re-baselines).
        self.spec_seen: Dict[str, int] = {}


class GatewayCore:
    """The serving control-plane state machine (see module docstring).

    Thread-safe: every public method takes the single mutex.  Latency
    instruments are injected (``observe_latency_ms`` /
    ``observe_ttft_ms`` callables) so the core stays import-light;
    :class:`Gateway` wires them to ``agent.metrics.Histogram``.
    """

    def __init__(self, config: Optional[GatewayConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or GatewayConfig()
        self._clock = clock
        self._mu = threading.Lock()
        self._queue: List[_Request] = []  # FIFO; requeues go to front
        self._by_id: Dict[str, _Request] = {}  # queued + assigned
        self._done = BoundedTokenCache(self.cfg.done_cache_cap)
        self._replicas: Dict[str, _Replica] = {}
        # CounterSet (thread-safe by itself) rather than a plain dict:
        # several counts are bumped from the *_locked helpers, and the
        # set's own lock keeps the increments race-free without tying
        # them to the core mutex.
        self._counters = CounterSet()
        for name in (
            "submitted", "accepted", "rejected", "dedupe_hits",
            "completed", "failed", "timeout", "duplicate_completions",
            "redispatched", "replicas_lost", "streamed_tokens",
            "late_completions",
            # Prefix-router outcomes: a fingerprinted grant
            # to a warm replica / to a cold one with no warm holder /
            # stolen from a warm holder by the overload guard.
            "prefix_hits", "prefix_misses", "prefix_steals",
            # Disaggregation: completed prefill->decode
            # handoffs, rejected (torn) segments, and the shipped vs
            # fp32-equivalent byte volume (the int8 saving, measured).
            # kv_bytes counts RELAYED payload bytes only — in the P2P
            # plane it stays ~0 and kv_p2p_bytes counts the
            # ticketed bytes that moved peer-to-peer instead;
            # kv_relay_fallbacks counts requests that fell back to the
            # relay path after a failed pull.
            "kv_handoffs", "kv_rejects", "kv_bytes", "kv_fp32_bytes",
            "kv_p2p_bytes", "kv_relay_fallbacks",
            # Speculative serving.  spec_rounds /
            # spec_accepted / spec_fallbacks aggregate the replicas'
            # cumulative poll reports as deltas (restart-safe
            # re-baselining); spec_grants / spec_bypass are the
            # router's long-decode outcomes (granted to a spec replica
            # / given up to a plain one after the reserve window).
            "spec_rounds", "spec_accepted", "spec_fallbacks",
            "spec_grants", "spec_bypass",
            # Tracing: head-based sampling outcomes — every
            # request is one or the other; a drop is counted, never
            # silent.
            "trace_sampled", "trace_unsampled",
            # Cross-cell spillover.  spill_forwarded: submits
            # this cell forwarded to a sibling instead of queueing;
            # spill_ingress: submits RECEIVED with a hop mark
            # (spill_hops>0) — global merges subtract it from the
            # summed `submitted` so a forwarded request counts once;
            # spill_rebuffed: hop-marked submits this cell had to
            # reject (both cells saturated); spill_adopted: sibling
            # terminals folded into the local dedupe cache.
            "spill_forwarded", "spill_ingress", "spill_rebuffed",
            "spill_adopted",
        ):
            self._counters.inc(name, 0)
        self._last_sweep = float("-inf")
        self.observe_latency_ms: Optional[Callable[[float], None]] = None
        self.observe_ttft_ms: Optional[Callable[[float], None]] = None
        #: Optional provider merged into stats_snapshot() — the Gateway
        #: wrapper injects its histogram percentiles here so consumers
        #: of the snapshot (the autoscaler's ttft_p95_ms signal, the
        #: fleet example's stats line) see them.
        self.snapshot_extras: Optional[Callable[[], Dict[str, Any]]] = None

    @property
    def counters(self) -> Dict[str, int]:
        """Point-in-time counter snapshot (a fresh dict)."""
        return self._counters.snapshot()

    # -- client surface ---------------------------------------------------

    def submit(self, req_id: str, prompt: List[int],
               max_new_tokens: int, deadline_s: float = 0.0,
               prefix_len: int = 0, prefix_fp: str = "",
               trace: Optional[dict] = None,
               spill_hops: int = 0) -> ServeAck:
        now = self._clock()
        if not req_id:
            # BoundedTokenCache treats "" as no-token: the completion
            # would be unrecordable and the client would poll an
            # 'unknown' id to its timeout.
            return ServeAck(req_id=req_id, status="failed",
                            reason="empty req_id")
        with self._mu:
            self._counters.inc("submitted")
            if spill_hops > 0:
                # Cross-cell hop mark: the origin cell
                # already counted this req_id as submitted when it
                # forwarded — merged GLOBAL stats subtract ingress
                # from the summed `submitted` to dedupe the hop.
                self._counters.inc("spill_ingress")
            hit = self._done.get(req_id)
            if hit is not None:
                # Idempotent resubmit of a request with a TERMINAL
                # outcome: answer from the cache with that outcome —
                # the decode never runs twice, and a timed-out/failed
                # request must NOT be masked as a zero-token success
                # (the req_id is the idempotency key; retry a failure
                # under a fresh id).
                self._counters.inc("dedupe_hits")
                return ServeAck(
                    req_id=req_id,
                    status=hit.get("state", "done"),
                    tokens=list(hit.get("tokens", [])),
                    reason=hit.get("reason", ""),
                )
            if req_id in self._by_id:
                # Retried submit of an in-flight request: already
                # admitted, no second queue entry.
                return ServeAck(req_id=req_id, status="accepted",
                                reason="duplicate-submit")
            in_flight = len(self._by_id)
            if in_flight >= self.cfg.queue_cap:
                self._counters.inc("rejected")
                if spill_hops > 0:
                    # Both cells saturated: the forwarded request is
                    # rebuffed back to the origin's own reject path.
                    self._counters.inc("spill_rebuffed")
                return ServeAck(
                    req_id=req_id, status="rejected",
                    retry_after_s=self.cfg.retry_after_s,
                    reason=f"admission queue full ({in_flight} >= "
                           f"{self.cfg.queue_cap})",
                )
            if deadline_s <= 0.0:
                deadline_s = self.cfg.default_deadline_s
            req = _Request(
                req_id, prompt, max_new_tokens,
                now + deadline_s if deadline_s > 0 else None, now,
                prefix_len=prefix_len, prefix_fp=prefix_fp,
            )
            self._trace_admit_locked(req, trace)
            self._queue.append(req)
            self._by_id[req_id] = req
            self._counters.inc("accepted")
            return ServeAck(req_id=req_id, status="accepted")

    def status(self, req_id: str) -> ServeStatusReply:
        with self._mu:
            hit = self._done.get(req_id)
            if hit is not None:
                return ServeStatusReply(
                    req_id=req_id, state=hit.get("state", "done"),
                    tokens=list(hit.get("tokens", [])),
                    replica=hit.get("replica", ""),
                    reason=hit.get("reason", ""),
                )
            req = self._by_id.get(req_id)
            if req is None:
                return ServeStatusReply(req_id=req_id, state="unknown")
            if req.assigned_to is not None:
                return ServeStatusReply(
                    req_id=req_id, state="running",
                    tokens=list(req.partial), replica=req.assigned_to,
                )
            return ServeStatusReply(req_id=req_id, state="queued")

    # -- cross-cell spillover surface --------------------------

    def peek_admission(self, req_id: str) -> str:
        """What :meth:`submit` would do RIGHT NOW, without counting or
        admitting anything: ``terminal`` (dedupe cache answers),
        ``duplicate`` (already in flight here), ``full`` (queue cap —
        the spillover trigger), or ``admit``.  The router probes this
        BEFORE local admission so a forwarded request never pollutes
        the origin's queue, counters, or latency histograms."""
        with self._mu:
            if not req_id:
                return "admit"  # submit() fails it with a reason
            if self._done.get(req_id) is not None:
                return "terminal"
            if req_id in self._by_id:
                return "duplicate"
            if len(self._by_id) >= self.cfg.queue_cap:
                return "full"
            return "admit"

    def pressure(self) -> Dict[str, Any]:
        """Cheap admission-pressure read for the spillover policy —
        the handful of fields a forward decision needs, without the
        full :meth:`stats_snapshot` pool walk."""
        with self._mu:
            alive = [r for r in self._replicas.values()
                     if not r.draining]
            slots = sum(r.slots for r in alive)
            assigned = sum(len(r.assigned) for r in alive)
            return {
                "in_flight": len(self._by_id),
                "queue_cap": self.cfg.queue_cap,
                "occupancy": assigned / slots if slots else 0.0,
                "replicas_alive": len(alive),
            }

    def adopt_terminal(self, req_id: str, state: str,
                       tokens: List[int], replica: str = "",
                       reason: str = "") -> str:
        """Fold a terminal outcome owned by a SIBLING cell into this
        cell's dedupe cache: once a spilled request finishes remotely,
        a resubmit HERE answers byte-identical without another hop.
        Counts ``spill_adopted`` — never ``completed``/``failed``; the
        decode happened (and was counted) in the cell that served it."""
        if not req_id or state not in ("done", "failed", "timeout"):
            return "ignored"
        with self._mu:
            if self._done.get(req_id) is not None:
                return "duplicate"
            req = self._by_id.get(req_id)
            if req is not None:
                # A local copy raced the hop (client resubmitted while
                # the sibling was already serving it): the sibling owns
                # the terminal — release the local copy un-decoded.
                self._detach_locked(req)
            self._done.put(req_id, {
                "state": state, "tokens": [int(t) for t in tokens],
                "replica": replica, "reason": reason,
            })
            self._counters.inc("spill_adopted")
            return "adopted"

    def fold_external(self, name: str, n: int = 1) -> None:
        """Spillover-router hook: count an admission event that
        happened OUTSIDE :meth:`submit` — e.g. a submit this cell
        forwarded without locally queueing — so per-cell snapshots
        stay complete."""
        self._counters.inc(name, n)

    # -- replica surface --------------------------------------------------

    def register(self, replica_id: str, slots: int,
                 role: str = "unified", spec: bool = False,
                 draft_addr: str = "") -> None:
        with self._mu:
            rep = self._replicas.get(replica_id)
            if rep is None:
                self._replicas[replica_id] = _Replica(
                    replica_id, slots, self._clock(), role=role,
                    spec=spec, draft_addr=draft_addr,
                )
                logger.info(
                    "gateway: replica %s registered (%d slots, %s%s)",
                    replica_id, slots, role or "unified",
                    ", spec" if spec else "",
                )
            else:
                # Restarted replica re-registering under the same id:
                # whatever it was assigned before the crash is either in
                # its journal (it will replay a completion) or must be
                # re-dispatched.
                rep.slots = int(slots)
                rep.last_seen = self._clock()
                rep.draining = False
                rep.role = role or "unified"
                rep.warm = set()
                rep.spec = bool(spec)
                rep.draft_addr = draft_addr or ""
                rep.spec_seen = {}
                self._requeue_assigned_locked(rep, "re-register")

    def deregister(self, replica_id: str) -> None:
        with self._mu:
            rep = self._replicas.pop(replica_id, None)
            if rep is None:
                return
            self._requeue_assigned_locked(rep, "deregister")
            logger.info("gateway: replica %s deregistered", replica_id)

    def poll(self, replica_id: str, free_slots: int,
             active: List[str], stats: Optional[dict] = None,
             warm_prefixes: Optional[List[str]] = None
             ) -> ServeGrants:
        now = self._clock()
        with self._mu:
            # Rate-limited safety-net sweep (bare-core users have no
            # sweeper thread): a full lease/deadline scan on EVERY poll
            # would be O(replicas + queue) on the hottest RPC path.
            if now - self._last_sweep >= 1.0:
                self._sweep_locked(now)
                self._last_sweep = now
            rep = self._replicas.get(replica_id)
            if rep is None:
                # The gateway restarted (or the replica was reaped after
                # a lease lapse): tell it to re-register.
                return ServeGrants(known=False)
            rep.last_seen = now
            rep.poll_seq += 1
            if stats:
                self._fold_spec_stats_locked(rep, stats)
                rep.stats = dict(stats)
            if warm_prefixes is not None:
                # Wholesale replacement: the replica's own report is
                # the truth (LRU evictions and restarts self-correct
                # the routing map).
                rep.warm = set(warm_prefixes)
            owned = set(active)
            # Reconcile lost grants: anything granted before this
            # replica's PREVIOUS poll must show up in its owned set by
            # now (the replica runner admits grants before its next
            # poll); a missing one evaporated in flight.
            cancels: List[str] = []
            for rid_key in list(rep.assigned):
                req = rep.assigned[rid_key]
                if req.deadline is not None and now > req.deadline:
                    # Deadline passed mid-decode: terminal timeout; tell
                    # the replica to drop it if still pending.
                    self._finish_locked(
                        req, "timeout", [], replica_id,
                        reason="deadline exceeded in flight",
                    )
                    cancels.append(rid_key)
                    continue
                if rid_key not in owned and req.grant_seq < rep.poll_seq - 1:
                    del rep.assigned[rid_key]
                    self._requeue_locked(
                        req, f"lost by replica {replica_id}"
                    )
            grants: List[ServeSubmit] = []
            if not rep.draining:
                # Ordered scan, not a head pop: requests this replica
                # cannot take (wrong role for the stage) or should not
                # take yet (template warm elsewhere, within the reserve
                # window) are SKIPPED, never blocking what's behind.
                free = max(0, int(free_slots))
                if stats:
                    # Paged-KV memory gate: a replica whose
                    # block pool is exhausted has free SLOTS but no
                    # free MEMORY — granting into it would only queue
                    # (or preempt) replica-side.  Let another poll
                    # take the work.
                    try:
                        if int(stats.get("total_blocks", 0) or 0) > 0 \
                                and int(
                                    stats.get("free_blocks", 0) or 0
                                ) == 0:
                            free = 0
                    except (TypeError, ValueError):
                        pass
                i = 0
                while len(grants) < free and i < len(self._queue):
                    req = self._queue[i]
                    if req.deadline is not None and now > req.deadline:
                        self._queue.pop(i)
                        self._finish_locked(
                            req, "timeout", [], "",
                            reason="deadline exceeded in queue",
                        )
                        continue
                    stage = self._stage_for_locked(rep, req)
                    if stage is None:
                        i += 1
                        continue
                    if stage in ("full", "prefill") and req.prefix_fp:
                        route = self._prefix_route_locked(rep, req, now)
                        if route == "defer":
                            i += 1
                            continue
                        self._counters.inc(
                            {"hit": "prefix_hits",
                             "miss": "prefix_misses",
                             "steal": "prefix_steals"}[route]
                        )
                    if (
                        stage == "full"
                        and self.cfg.spec_decode_min_tokens > 0
                        and req.max_new_tokens
                        >= self.cfg.spec_decode_min_tokens
                    ):
                        # Long decode: prefer a spec-capable
                        # replica — its accepted-tokens-per-round win
                        # scales with decode length.  Bounded reserve:
                        # once every capable spec replica is saturated
                        # or the window expires, anyone takes it.
                        route = self._spec_route_locked(rep, req, now)
                        if route == "defer":
                            i += 1
                            continue
                        self._counters.inc(
                            "spec_grants" if route == "grant"
                            else "spec_bypass"
                        )
                    self._queue.pop(i)
                    req.assigned_to = replica_id
                    req.grant_seq = rep.poll_seq
                    req.stage = stage
                    rep.assigned[req.req_id] = req
                    if req.trace_tid:
                        # The wait this grant ends: fresh admission ->
                        # queue_wait; a held KV segment -> kv_wait
                        # (decode-pool capacity wait).  Plus the scan
                        # pass that found it, as a detail span.
                        self._phase_locked(
                            req,
                            "gw.kv_wait" if stage == "decode"
                            and req.has_kv else "gw.queue_wait",
                            now,
                        )
                    if stage == "decode" and req.kv_addr:
                        # Ticketed bytes GRANTED for a peer pull: a
                        # re-shipped ticket (decode-replica death)
                        # counts again, matching the pulls actually
                        # attempted — counting at kv_ready would book
                        # bytes that never moved.
                        self._counters.inc("kv_p2p_bytes",
                                           req.kv_nbytes)
                    grants.append(ServeSubmit(
                        req_id=req.req_id, prompt=list(req.prompt),
                        max_new_tokens=req.max_new_tokens,
                        deadline_s=(
                            max(0.0, req.deadline - now)
                            if req.deadline is not None else 0.0
                        ),
                        prefix_len=req.prefix_len,
                        prefix_fp=req.prefix_fp,
                        stage=stage,
                        kv=req.kv if stage == "decode" else b"",
                        kv_addr=req.kv_addr if stage == "decode"
                        else "",
                        kv_fp=req.kv_fp if stage == "decode" else "",
                        kv_crc32=req.kv_crc32
                        if stage == "decode" else 0,
                        kv_nbytes=req.kv_nbytes
                        if stage == "decode" else 0,
                        # Order the relay path on a prefill grant when
                        # P2P is off tier-wide or this request already
                        # burned a failed pull.
                        kv_relay=(
                            stage == "prefill"
                            and (req.kv_relay or not self.cfg.kv_p2p)
                        ),
                        trace=(
                            {"tid": req.trace_tid,
                             "sid": req.trace_root}
                            if req.trace_tid else {}
                        ),
                    ))
            drain = rep.draining and not rep.assigned
            return ServeGrants(
                requests=grants, cancel=cancels, drain=drain, known=True,
                draft_addr=self._draft_addr_locked(),
            )

    def stream(self, replica_id: str, req_id: str,
               tokens: List[int]) -> None:
        now = self._clock()
        with self._mu:
            req = self._by_id.get(req_id)
            if req is None or req.assigned_to != replica_id:
                return  # stale stream from a superseded assignment
            if req.first_token_at is None and tokens:
                # Phase closes BEFORE first_token_at is set, so the
                # exec span still carries pre_ttft — the TTFT subset
                # ends exactly here.
                self._phase_locked(req, "gw.exec_to_first_token", now)
                req.first_token_at = now
                if self.observe_ttft_ms is not None:
                    self.observe_ttft_ms(
                        (now - req.submitted_at) * 1000.0
                    )
            req.partial.extend(int(t) for t in tokens)
            self._counters.inc("streamed_tokens", len(tokens))

    def complete(self, replica_id: str, req_id: str, tokens: List[int],
                 ok: bool = True, reason: str = "",
                 replayed: bool = False, tokens_per_round: float = 0.0,
                 spec_rounds: int = 0,
                 trace: Optional[dict] = None) -> str:
        """Terminal report.  Returns ``recorded`` | ``duplicate`` |
        ``unknown`` (the replica does not branch on it; tests do)."""
        with self._mu:
            hit = self._done.get(req_id)
            if hit is not None:
                if hit.get("state") == "timeout":
                    # The replica finished work the gateway had already
                    # timed out: not a dedupe event — keep the
                    # duplicate counter meaningful (the e2e reads it as
                    # journal-replay evidence).
                    self._counters.inc("late_completions")
                else:
                    self._counters.inc("duplicate_completions")
                req = self._by_id.get(req_id)
                if req is not None:
                    # A re-dispatched copy still in the books: the first
                    # completion already answered the client; release it.
                    self._detach_locked(req)
                return "duplicate"
            req = self._by_id.get(req_id)
            if req is None:
                # A journal replay for a request this gateway never
                # admitted (fresh gateway, old journal): nothing to
                # complete.
                return "unknown"
            if not req.trace_tid and (trace or {}).get("tid"):
                # A journal replay carrying the ORIGINAL trace for a
                # request this gateway admitted untraced (sampling
                # knobs differ across restarts): adopt it — the replay
                # must join the original trace, not orphan a new one.
                req.trace_tid = str(trace["tid"])
                req.trace_root = new_span_id()
            state = "done" if ok else "failed"
            self._finish_locked(
                req, state, tokens, replica_id, reason=reason,
                extra=(
                    {"tokens_per_round": float(tokens_per_round),
                     "spec_rounds": int(spec_rounds)}
                    if tokens_per_round else None
                ),
            )
            if replayed:
                logger.info(
                    "gateway: request %s completed from %s's journal "
                    "replay", req_id, replica_id,
                )
            return "recorded"

    def kv_ready(self, replica_id: str, req_id: str, payload: bytes,
                 fp32_bytes: int = 0, addr: str = "",
                 seg_fp: str = "", crc32: int = 0,
                 nbytes: int = 0,
                 trace: Optional[dict] = None) -> str:
        """Stage two of the disaggregated path: the prefill replica's
        KV segment arrives — as relayed ``payload`` bytes, or
        as a P2P TICKET (non-empty ``addr``; the bytes stay
        on the prefill replica's segment server and the decode replica
        pulls them directly).  Either way the request leaves the
        prefill replica's books and re-queues at the FRONT in stage
        ``kv_ready`` for the decode pool (the prefill investment is
        sunk — decode capacity should consume it before fresh
        prefills).  Returns ``recorded`` | ``stale`` | ``unknown``
        (tests branch; the replica does not)."""
        with self._mu:
            req = self._by_id.get(req_id)
            if req is None:
                # Already terminal (timeout while prefilling) or never
                # admitted: drop the payload.
                return "unknown"
            if req.assigned_to != replica_id:
                # Superseded assignment (the prefill replica was
                # presumed dead and the request re-dispatched): the
                # live assignment produces its own segment.
                return "stale"
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.assigned.pop(req_id, None)
            if not req.trace_tid and (trace or {}).get("tid"):
                # Handoff arriving at a gateway that admitted this
                # request untraced (failover adoption): join the
                # original trace, the ServeDone.trace contract.
                req.trace_tid = str(trace["tid"])
                req.trace_root = new_span_id()
            # The prefill stage ends here: segment (or ticket) in hand.
            self._phase_locked(req, "gw.prefill_exec", self._clock())
            req.assigned_to = None
            req.clear_kv()
            if addr:
                req.kv_addr = addr
                req.kv_fp = seg_fp
                req.kv_crc32 = int(crc32)
                req.kv_nbytes = int(nbytes)
                # kv_p2p_bytes is counted at DECODE-GRANT time, when
                # the ticket is actually handed to a puller.
            else:
                req.kv = bytes(payload)
                self._counters.inc("kv_bytes", len(payload))
            req.stage = "kv_ready"
            self._queue.insert(0, req)
            self._counters.inc("kv_handoffs")
            self._counters.inc("kv_fp32_bytes", int(fp32_bytes))
            return "recorded"

    def kv_reject(self, replica_id: str, req_id: str,
                  reason: str = "") -> str:
        """A decode replica refused a KV segment (CRC/shape mismatch —
        torn in flight — or a FAILED P2P
        PULL: dead peer, evicted/stale publication).  The held segment
        or ticket is DROPPED (never re-shipped, never decoded from)
        and the request re-queues for a fresh prefill — through
        ``_requeue_locked``, so a persistently-torn handoff fails
        terminally after ``max_attempts`` instead of looping.  A
        request whose TICKET failed re-prefills in RELAY mode: the
        peer path already proved unreliable for it, and the bounded
        attempts budget must not be spent re-proving that."""
        with self._mu:
            req = self._by_id.get(req_id)
            if req is None:
                return "unknown"
            if req.assigned_to != replica_id:
                # Superseded assignment (a stalled decode replica
                # rejecting after the lease machinery re-granted the
                # segment elsewhere): the LIVE assignment owns the
                # request — tearing it down here would orphan an
                # in-flight decode and burn attempts on a healthy
                # request.  Same guard as kv_ready/stream/complete.
                return "stale"
            self._counters.inc("kv_rejects")
            rep = self._replicas.get(replica_id)
            if rep is not None:
                rep.assigned.pop(req_id, None)
            req.assigned_to = None
            if req.kv_addr:
                req.kv_relay = True
                self._counters.inc("kv_relay_fallbacks")
            req.clear_kv()
            self._requeue_locked(
                req, f"kv segment rejected by {replica_id}: {reason}"
            )
            return "recorded"

    # -- operator surface -------------------------------------------------

    def drain(self, replica_id: str) -> bool:
        with self._mu:
            rep = self._replicas.get(replica_id)
            if rep is None:
                return False
            rep.draining = True
            logger.info("gateway: draining replica %s", replica_id)
            return True

    def pick_drain_victim(self, role: Optional[str] = None
                          ) -> Optional[str]:
        """Least-loaded non-draining replica — the scale-down choice.
        ``role`` restricts to one pool (the per-role autoscaler)."""
        with self._mu:
            best = None
            for rep in self._replicas.values():
                if rep.draining:
                    continue
                if role is not None and rep.role != role:
                    continue
                key = (len(rep.assigned), rep.replica_id)
                if best is None or key < best[0]:
                    best = (key, rep.replica_id)
            return best[1] if best else None

    def sweep(self) -> None:
        with self._mu:
            self._sweep_locked(self._clock())

    def stats_snapshot(self) -> Dict[str, Any]:
        with self._mu:
            reps = {
                rid_key: {
                    "slots": rep.slots,
                    "assigned": len(rep.assigned),
                    "draining": rep.draining,
                    "role": rep.role,
                    "spec": rep.spec,
                    "draft_addr": rep.draft_addr,
                    "warm_prefixes": sorted(rep.warm),
                    "stats": dict(rep.stats),
                }
                for rid_key, rep in self._replicas.items()
            }
            alive = [r for r in self._replicas.values() if not r.draining]
            total_slots = sum(r.slots for r in alive)
            total_assigned = sum(len(r.assigned) for r in alive)
            # Per-role pools: each role's capacity plus the
            # queue depth IT drains — stage-queued work feeds the
            # prefill pool when one exists (else unified), kv_ready
            # work the decode pool — so each pool's autoscale signal is
            # independent.
            queued_stage = sum(
                1 for r in self._queue if r.stage != "kv_ready"
            )
            kv_ready_depth = len(self._queue) - queued_stage
            from dlrover_tpu_torch.serving.autoscale import (
                draft_pool_tokens_per_round,
                mean_measured,
            )

            def _tpr(rep: _Replica) -> float:
                try:
                    return float(
                        rep.stats.get("tokens_per_round", 0.0)
                    )
                except (TypeError, ValueError):
                    return 0.0

            def _kvocc(rep: _Replica) -> Optional[float]:
                """The replica's reported memory occupancy (block-pool
                utilization under paged KV, slot fraction otherwise);
                None when the replica predates the field."""
                try:
                    v = rep.stats.get("kv_occupancy")
                    return None if v is None else float(v)
                except (TypeError, ValueError):
                    return None

            def _blk(rep: _Replica, key: str) -> int:
                try:
                    return int(rep.stats.get(key, 0) or 0)
                except (TypeError, ValueError):
                    return 0

            pools: Dict[str, Dict[str, Any]] = {}
            for role in ("unified", "prefill", "decode", "draft"):
                members = [r for r in alive if r.role == role]
                slots = sum(r.slots for r in members)
                assigned = sum(len(r.assigned) for r in members)
                reported = [
                    x for x in (_kvocc(r) for r in members)
                    if x is not None
                ]
                pools[role] = {
                    "alive": len(members),
                    "slots": slots,
                    "assigned": assigned,
                    "occupancy": assigned / slots if slots else 0.0,
                    # Real memory headroom: mean reported
                    # kv_occupancy, falling back to the slot fraction
                    # for fleets that don't report it — continuous
                    # across the paged-flag flip, so autoscale
                    # hysteresis never sees a step.
                    "kv_occupancy": (
                        sum(reported) / len(reported) if reported
                        else (assigned / slots if slots else 0.0)
                    ),
                    "free_blocks": sum(
                        _blk(r, "free_blocks") for r in members
                    ),
                    "total_blocks": sum(
                        _blk(r, "total_blocks") for r in members
                    ),
                    "queue_depth": 0,
                    # Accepted-tokens-per-round signal:
                    # mean over the pool's reporting members; 0 =
                    # unmeasured.
                    "tokens_per_round": mean_measured(
                        _tpr(r) for r in members
                    ),
                }
            # The DRAFT pool's earned value is measured at its
            # CONSUMERS (the shared convention in serving.autoscale):
            # decide_pools steers the draft pool on this (shrink
            # below break-even).
            pools["draft"]["tokens_per_round"] = \
                draft_pool_tokens_per_round(
                    (r.spec, r.role, _tpr(r)) for r in alive
                )
            fed = "prefill" if pools["prefill"]["alive"] else "unified"
            pools[fed]["queue_depth"] += queued_stage
            fed = "decode" if pools["decode"]["alive"] else "unified"
            pools[fed]["queue_depth"] += kv_ready_depth
            snap = {
                "queue_depth": len(self._queue),
                "queue_prefill": queued_stage,
                "queue_kv_ready": kv_ready_depth,
                "in_flight": len(self._by_id),
                "replicas_alive": len(alive),
                "replicas_draining": len(self._replicas) - len(alive),
                "occupancy": (
                    total_assigned / total_slots if total_slots else 0.0
                ),
                # Fleet memory occupancy: slot-weighted
                # mean of each replica's reported kv_occupancy
                # (falling back to its slot fraction) — what paged-KV
                # admission and autoscale read for real headroom.
                "kv_occupancy": (
                    sum(
                        (
                            _kvocc(r) if _kvocc(r) is not None
                            else len(r.assigned) / max(1, r.slots)
                        ) * r.slots
                        for r in alive
                    ) / total_slots if total_slots else 0.0
                ),
                "pools": pools,
                "counters": self._counters.snapshot(),
                "replicas": reps,
            }
        # Outside the mutex: the extras provider (the Gateway wrapper's
        # latency/TTFT histograms) has its own locking, and the
        # autoscaler's ttft_p95_ms signal reads THIS snapshot — without
        # the hook that policy knob would be dead in production.
        if self.snapshot_extras is not None:
            try:
                snap.update(self.snapshot_extras())
            except Exception as e:  # noqa: BLE001 - stats must answer
                logger.warning("gateway snapshot extras failed: %s", e)
        return snap

    # -- internals (call with self._mu held) ------------------------------

    def _trace_admit_locked(self, req: _Request,
                            trace: Optional[dict]) -> None:
        """Head-based sampling at admission.  A client-sent
        trace context forces sampling; otherwise the decision is a pure
        function of (req_id, trace_sample) — deterministic across every
        gateway of the tier."""
        tid = (trace or {}).get("tid", "")
        if not tid:
            sample = self.cfg.trace_sample
            if sample < 1.0:
                if sample <= 0.0 or (
                    int(trace_id_for(req.req_id)[:8], 16) % 10000
                    >= int(sample * 10000)
                ):
                    self._counters.inc("trace_unsampled")
                    return
            tid = trace_id_for(req.req_id)
        self._counters.inc("trace_sampled")
        req.trace_tid = tid
        req.trace_root = new_span_id()

    def _phase_locked(self, req: _Request, name: str,
                      now: float) -> None:
        """Emit one phase span [phase_mark, now] and advance the mark.
        Phases are contiguous on the gateway's single clock, so per
        request they SUM EXACTLY to the measured latency (and the
        pre-first-token subset to the measured TTFT) — the decomposed
        view can never drift from the histogram's truth."""
        if not req.trace_tid or now < req.phase_mark:
            return
        req.phase_mark = now

    def _stage_for_locked(self, rep: _Replica,
                          req: _Request) -> Optional[str]:
        """Which grant stage this replica could run this request at —
        None = ineligible (skip in the scan)."""
        if req.stage == "kv_ready":
            return ("decode" if rep.role in ("decode", "unified")
                    else None)
        if rep.role == "unified":
            return "full"
        if rep.role == "prefill":
            # Prefilling is only worth the work while someone can
            # decode the result; otherwise the segment would sit in
            # the queue to its deadline.
            return ("prefill" if self._decode_capable_locked()
                    else None)
        return None  # decode-only replicas never prefill

    def _decode_capable_locked(self) -> bool:
        return any(
            r.role in ("decode", "unified") and not r.draining
            for r in self._replicas.values()
        )

    def _prefix_route_locked(self, rep: _Replica, req: _Request,
                             now: float) -> str:
        """Routing outcome for a fingerprinted request at this
        replica's poll: ``hit`` (warm here), ``miss`` (warm nowhere
        else capable), ``defer`` (reserved for a warm holder with
        capacity, within the reserve window), or ``steal`` (warm
        elsewhere but the overload guard fired)."""
        fp = req.prefix_fp
        if fp in rep.warm:
            return "hit"
        warm = [
            r for r in self._replicas.values()
            if r is not rep and not r.draining and fp in r.warm
            and r.role in ("prefill", "unified")
        ]
        if not warm:
            return "miss"
        if any(len(r.assigned) < r.slots for r in warm) and \
                now - req.submitted_at < self.cfg.prefix_reserve_s:
            return "defer"
        return "steal"

    def _spec_route_locked(self, rep: _Replica, req: _Request,
                           now: float) -> str:
        """Routing outcome for a LONG-decode request at this replica's
        poll: ``grant`` (this replica speculates),
        ``defer`` (a spec-capable replica with capacity exists, within
        the reserve window), or ``bypass`` (no spec capacity — plain
        decode beats queueing)."""
        if rep.spec:
            return "grant"
        capable = [
            r for r in self._replicas.values()
            if r is not rep and not r.draining and r.spec
            and r.role in ("unified", "decode")
        ]
        if any(len(r.assigned) < r.slots for r in capable) and \
                now - req.submitted_at < self.cfg.spec_reserve_s:
            return "defer"
        return "bypass"

    def _fold_spec_stats_locked(self, rep: _Replica, stats: dict) -> None:
        """Fold a poll report's CUMULATIVE spec counters into the
        gateway counters as deltas.  A replica restart resets its
        cumulative numbers — a smaller report re-baselines instead of
        going negative."""
        for src, dst in (
            ("spec_rounds", "spec_rounds"),
            ("spec_accepted", "spec_accepted"),
            ("spec_fallbacks", "spec_fallbacks"),
        ):
            if src not in stats:
                continue
            new = int(stats[src])
            old = rep.spec_seen.get(src, 0)
            delta = new - old if new >= old else new
            if delta > 0:
                self._counters.inc(dst, delta)
            rep.spec_seen[src] = new

    def _draft_addr_locked(self) -> str:
        """The proposal-server address spec targets should use right
        now: the least-loaded live draft replica's (sorted for
        determinism), "" when none is alive — targets then fall back
        to plain decode until one registers."""
        best = ""
        best_key = None
        for rep in self._replicas.values():
            if rep.role != "draft" or rep.draining or not rep.draft_addr:
                continue
            key = (int(rep.stats.get("streams", 0)), rep.replica_id)
            if best_key is None or key < best_key:
                best_key = key
                best = rep.draft_addr
        return best

    def _detach_locked(self, req: _Request) -> None:
        self._by_id.pop(req.req_id, None)
        if req.assigned_to is not None:
            rep = self._replicas.get(req.assigned_to)
            if rep is not None:
                rep.assigned.pop(req.req_id, None)
        elif req in self._queue:
            self._queue.remove(req)

    def _finish_locked(self, req: _Request, state: str,
                       tokens: List[int], replica_id: str,
                       reason: str = "",
                       extra: Optional[dict] = None) -> None:
        self._detach_locked(req)
        rec = {
            "state": state, "tokens": [int(t) for t in tokens],
            "replica": replica_id, "reason": reason,
        }
        if extra:
            rec.update(extra)
        self._done.put(req.req_id, rec)
        now = self._clock()
        if req.trace_tid:
            # Final phase: streamed decode after the first token, raw
            # exec when none arrived (lost/failed), pure queue wait
            # when never granted — then THE terminal span (the span
            # tree's root; exactly one per completion this gateway
            # records).
            if req.first_token_at is not None:
                final = "gw.decode_stream"
            elif req.grant_seq >= 0:
                final = "gw.exec"
            else:
                final = "gw.queue_wait"
            self._phase_locked(req, final, now)
        if state == "done":
            self._counters.inc("completed")
            if self.observe_latency_ms is not None:
                self.observe_latency_ms(
                    (now - req.submitted_at) * 1000.0
                )
        elif state == "timeout":
            self._counters.inc("timeout")
        else:
            self._counters.inc("failed")

    def _requeue_locked(self, req: _Request, why: str) -> None:
        """Return a lost/orphaned request to the FRONT of the queue —
        or fail it terminally once it has burned ``max_attempts``
        re-dispatches (a poison request must not serially kill the
        fleet while head-of-line-blocking everything behind it)."""
        # The phase the grant was burning ends HERE, visibly: a lost
        # assignment is a named slice of the request's latency, not a
        # silent gap (the tiling law holds across re-dispatches).
        self._phase_locked(req, "gw.exec_lost", self._clock())
        req.assigned_to = None
        req.attempts += 1
        req.partial = []
        # Fall back to the right stage: a held KV segment OR ticket
        # survives its decode replica's death (re-ship it), a lost
        # prefill re-prefills from scratch.
        req.stage = "kv_ready" if req.has_kv else "queued"
        if req.attempts >= self.cfg.max_attempts:
            self._finish_locked(
                req, "failed", [], "",
                reason=f"re-dispatched {req.attempts} times "
                       f"(max_attempts={self.cfg.max_attempts}); "
                       f"last: {why}",
            )
            logger.error(
                "gateway: request %s failed terminally after %d "
                "re-dispatches (%s)", req.req_id, req.attempts, why,
            )
            return
        self._queue.insert(0, req)
        self._counters.inc("redispatched")
        logger.warning(
            "gateway: request %s re-queued (%s)", req.req_id, why,
        )

    def _requeue_assigned_locked(self, rep: _Replica,
                                 why: str) -> None:
        for req in list(rep.assigned.values()):
            rep.assigned.pop(req.req_id, None)
            self._requeue_locked(req, f"{why} of replica {rep.replica_id}")

    def _sweep_locked(self, now: float) -> None:
        # Dead replicas: lease lapsed -> requeue their work.
        for rid_key in list(self._replicas):
            rep = self._replicas[rid_key]
            if now - rep.last_seen > self.cfg.lease_timeout_s:
                self._counters.inc("replicas_lost")
                logger.warning(
                    "gateway: replica %s lease expired (%.1fs); "
                    "re-dispatching %d in-flight request(s)",
                    rid_key, now - rep.last_seen, len(rep.assigned),
                )
                self._requeue_assigned_locked(rep, "lease expiry")
                del self._replicas[rid_key]
        # Queued requests past their deadline: terminal timeout.
        for req in list(self._queue):
            if req.deadline is not None and now > req.deadline:
                self._finish_locked(
                    req, "timeout", [], "",
                    reason="deadline exceeded in queue",
                )


class Gateway:
    """RPC front of :class:`GatewayCore`: one msgpack route
    (``common/rpc.py``) dispatching on message type, plus a lease
    sweeper thread and the latency/TTFT histograms."""

    def __init__(self, port: int = 0,
                 config: Optional[GatewayConfig] = None,
                 sweep_interval: float = 1.0,
                 metrics_registry=None,
                 histogram_window_s: float = 60.0,
                 histogram_buckets=None,
                 clock: Callable[[], float] = time.monotonic):
        from dlrover_tpu_torch.agent.metrics import Histogram
        from dlrover_tpu_torch.common.rpc import RpcServer

        self.core = GatewayCore(config, clock=clock)
        # ONE clock for the wrapper and the core: the gauge-snapshot TTL below and every core lease/deadline
        # must advance together when a simulated clock is injected.
        self._clock = self.core._clock
        # Windowed: these percentiles steer the autoscaler and the
        # gauges — a lifetime histogram would ratchet (one bad warmup
        # period keeps p95 high forever and the fleet never shrinks).
        # ``histogram_buckets`` overrides the default ms bounds (a
        # finer ladder resolves routing deltas the 1-2-5 default rounds
        # away).
        kw = {"window_s": histogram_window_s}
        if histogram_buckets is not None:
            kw["buckets"] = tuple(histogram_buckets)
        self.latency_ms = Histogram(**kw)
        self.ttft_ms = Histogram(**kw)
        self.core.observe_latency_ms = self.latency_ms.observe
        self.core.observe_ttft_ms = self.ttft_ms.observe
        # The *_hist entries are Histogram.state() dicts — the
        # MERGEABLE form a sharded tier aggregates bucket-wise
        # (Histogram.merged) before reading percentiles; merging the
        # per-gateway p95s themselves would whipsaw the autoscaler.
        self.core.snapshot_extras = lambda: {
            "ttft_p95_ms": self.ttft_ms.percentile(0.95),
            "latency_p95_ms": self.latency_ms.percentile(0.95),
            "ttft_hist": self.ttft_ms.state(),
            "latency_hist": self.latency_ms.state(),
            # Wire messages served by this gateway process (process CPU
            # over this is the per-message admission cost).
            "rpc_calls": self._server.calls,
        }
        #: Optional :class:`serving.spillover.CellSpillRouter` — when
        #: attached, ServeSubmit/ServeStatusRequest dispatch through it
        #: so a saturated cell forwards admission to a sibling cell.
        self.spill_router = None
        if metrics_registry is not None:
            self.register_gauges(metrics_registry)
        self._sweep_interval = sweep_interval
        self._stop = threading.Event()
        self._server = RpcServer(port, self.handle)
        self._sweeper: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.port

    def register_gauges(self, registry) -> None:
        """Gateway latency histograms + fleet gauges on an agent
        metrics registry (``serve_*`` namespace)."""
        self.latency_ms.register_gauges(registry, "serve_latency")
        self.ttft_ms.register_gauges(registry, "serve_ttft")

        # One snapshot per scrape, not one per gauge: every gauge taking
        # the core mutex and copying all counters would contend with the
        # submit/poll hot path.
        cache = {"ts": 0.0, "snap": {}}

        def _snap():
            now = self._clock()
            if now - cache["ts"] > 0.5:
                cache["snap"] = self.core.stats_snapshot()
                cache["ts"] = now
            return cache["snap"]

        def _snap_gauge(key):
            def read():
                return float(_snap().get(key, 0.0))
            return read

        for key in ("queue_depth", "in_flight", "replicas_alive",
                    "occupancy", "queue_prefill", "queue_kv_ready"):
            registry.gauge(f"serve_{key}", _snap_gauge(key))

        def _counter_gauge(name):
            def read():
                return float(
                    _snap().get("counters", {}).get(name, 0)
                )
            return read

        # Every core counter is exported.
        for name in ("submitted", "accepted", "rejected", "completed",
                     "failed", "timeout", "dedupe_hits",
                     "duplicate_completions", "late_completions",
                     "redispatched", "replicas_lost",
                     "streamed_tokens",
                     "prefix_hits", "prefix_misses", "prefix_steals",
                     "kv_handoffs", "kv_rejects", "kv_bytes",
                     "kv_p2p_bytes", "kv_fp32_bytes",
                     "kv_relay_fallbacks",
                     "spec_rounds", "spec_accepted", "spec_fallbacks",
                     "spec_grants", "spec_bypass",
                     "trace_sampled", "trace_unsampled",
                     "spill_forwarded", "spill_ingress",
                     "spill_rebuffed", "spill_adopted"):
            registry.gauge(f"serve_{name}", _counter_gauge(name))

        def _pool_gauge(role, key):
            def read():
                return float(
                    _snap().get("pools", {}).get(role, {}).get(key, 0)
                )
            return read

        for role in ("unified", "prefill", "decode", "draft"):
            for key in ("alive", "assigned", "queue_depth",
                        "occupancy", "tokens_per_round"):
                registry.gauge(f"serve_pool_{role}_{key}",
                               _pool_gauge(role, key))

    def handle(self, msg: Message) -> Optional[Message]:
        core = self.core
        if isinstance(msg, ServeSubmit):
            if self.spill_router is not None:
                # Cross-cell spillover: the router decides local vs
                # forward; a hop-marked submit (spill_hops>0) arriving
                # FROM a sibling always lands locally — the router's
                # depth bound keeps it from bouncing back.
                return self.spill_router.submit(msg)
            return core.submit(msg.req_id, msg.prompt,
                               msg.max_new_tokens, msg.deadline_s,
                               msg.prefix_len, msg.prefix_fp,
                               msg.trace, spill_hops=msg.spill_hops)
        if isinstance(msg, ServeStatusRequest):
            if self.spill_router is not None:
                return self.spill_router.status(msg.req_id)
            return core.status(msg.req_id)
        if isinstance(msg, ServeReplicaRegister):
            core.register(msg.replica_id, msg.slots, msg.role,
                          msg.spec, msg.draft_addr)
            return BaseResponse(success=True)
        if isinstance(msg, ServeReplicaDeregister):
            core.deregister(msg.replica_id)
            return BaseResponse(success=True)
        if isinstance(msg, ServeReplicaPoll):
            return core.poll(msg.replica_id, msg.free_slots,
                             msg.active, msg.stats, msg.warm_prefixes)
        if isinstance(msg, ServeKvReady):
            outcome = core.kv_ready(msg.replica_id, msg.req_id,
                                    msg.payload, msg.fp32_bytes,
                                    msg.addr, msg.seg_fp, msg.crc32,
                                    msg.nbytes, msg.trace)
            return BaseResponse(success=True, reason=outcome)
        if isinstance(msg, ServeKvReject):
            outcome = core.kv_reject(msg.replica_id, msg.req_id,
                                     msg.reason)
            return BaseResponse(success=True, reason=outcome)
        if isinstance(msg, ServeTokens):
            core.stream(msg.replica_id, msg.req_id, msg.tokens)
            return BaseResponse(success=True)
        if isinstance(msg, ServeDone):
            outcome = core.complete(
                msg.replica_id, msg.req_id, msg.tokens, msg.ok,
                msg.reason, msg.replayed, msg.tokens_per_round,
                msg.spec_rounds, msg.trace,
            )
            return BaseResponse(success=True, reason=outcome)
        if isinstance(msg, ServeDrainRequest):
            ok = core.drain(msg.replica_id)
            return BaseResponse(success=ok)
        if isinstance(msg, ServeFleetStatsRequest):
            return ServeFleetStats(stats=self.core.stats_snapshot())
        return BaseResponse(
            success=False, reason=f"unhandled {type(msg).__name__}"
        )

    def start(self) -> None:
        self._server.start()
        if self._sweeper is None:
            self._sweeper = threading.Thread(
                target=self._sweep_loop, name="gw-sweeper", daemon=True
            )
            self._sweeper.start()

    def _sweep_loop(self) -> None:
        while not self._stop.wait(self._sweep_interval):
            try:
                self.core.sweep()
            except Exception:  # noqa: BLE001 - sweeper must survive
                logger.exception("gateway sweep failed")

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        self._server.stop(grace)
        if self._sweeper is not None:
            self._sweeper.join(timeout=5.0)
            self._sweeper = None


class LoopbackTransport:
    """In-process transport with the RPC client's calling convention:
    ``call(msg) -> reply``.  Lets one-process fleets and the unit
    tests run a whole fleet (core + replicas) in one process with zero
    sockets."""

    def __init__(self, handler: Callable[[Message], Optional[Message]]):
        self._handler = handler

    def call(self, msg: Message, **_kw) -> Message:
        resp = self._handler(msg)
        return resp if resp is not None else BaseResponse(success=True)


class ServeClient:
    """Convenience client: submit with bounded backpressure retry, poll
    for the result.  ``transport`` is anything with the ``call(msg,
    **kw)`` convention — an ``RpcClient`` or a
    :class:`LoopbackTransport`."""

    def __init__(self, transport, poll_interval: float = 0.02):
        self._t = transport
        self._poll_interval = poll_interval

    def submit(self, req_id: str, prompt, max_new_tokens: int,
               deadline_s: float = 0.0, submit_timeout: float = 30.0,
               prefix_len: int = 0, prefix_fp: str = "") -> ServeAck:
        """Submit, honouring rejection backpressure: sleeps the
        gateway's ``retry_after_s`` and retries until accepted (or
        ``submit_timeout`` is spent — then the last rejected ack is
        returned for the caller to surface).  ``prefix_len``/
        ``prefix_fp`` declare the prompt's leading shared template for
        prefix-aware routing (the fingerprint is derived when omitted)."""
        if prefix_len and not prefix_fp:
            from dlrover_tpu_torch.serving.replica import prefix_fingerprint

            prefix_fp = prefix_fingerprint(prompt[:prefix_len])
        start = time.monotonic()
        while True:
            ack = self._t.call(ServeSubmit(
                req_id=req_id, prompt=[int(t) for t in prompt],
                max_new_tokens=max_new_tokens, deadline_s=deadline_s,
                prefix_len=prefix_len, prefix_fp=prefix_fp,
            ))
            if not isinstance(ack, ServeAck) or ack.status != "rejected":
                return ack
            wait = max(0.01, ack.retry_after_s)
            if time.monotonic() - start + wait > submit_timeout:
                return ack
            time.sleep(wait)

    def status(self, req_id: str) -> ServeStatusReply:
        reply = self._t.call(ServeStatusRequest(req_id=req_id))
        if not isinstance(reply, ServeStatusReply):
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(reply))
        return reply

    def result(self, req_id: str, timeout: float = 60.0
               ) -> ServeStatusReply:
        """Poll until the request reaches a terminal state."""
        deadline = time.monotonic() + timeout
        while True:
            reply = self.status(req_id)
            if reply.state in ("done", "failed", "timeout"):
                return reply
            if time.monotonic() >= deadline:
                return reply
            time.sleep(self._poll_interval)
