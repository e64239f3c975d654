"""Queue-driven serving autoscale: replica count from load signals —
the port's copy of ``dlrover_tpu/serving/autoscale.py`` (the whole
module), held against it; its decision journal is a log line here.

The policy is a PURE function (:func:`decide`) over a gateway stats
snapshot — queue depth per alive replica, p95 TTFT, slot occupancy —
with hysteresis carried in an explicit :class:`ScaleState`, so the
arithmetic is unit-testable without threads, RPC, or models (the shape
``master/job_auto_scaler.py`` uses for training: signals in, target
count out, actuation elsewhere).

Scale-up triggers on pressure (deep queue OR slow p95 TTFT) sustained
for ``up_patience`` consecutive passes; scale-down on sustained idleness
(shallow queue AND low occupancy) for ``down_patience`` passes —
asymmetric patience because adding a replica is cheap and shedding one
mid-burst is not.  Scale-down is DRAIN-AWARE: the actuator
(:class:`ServeAutoScaler`, or the master's ``ServingFleetAutoScaler``)
picks the least-loaded replica and asks the gateway to drain it; the
replica finishes in-flight work, deregisters, and only then goes away —
no admitted request ever observes the shrink.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Optional

from dlrover_tpu_torch.common.log import logger


def journal(kind: str, **fields: Any) -> None:
    """A decision or an actuation, as one log line (the reference records
    it in its observability journal, which the port does not have)."""
    logger.info("%s %s", kind, fields)


@dataclasses.dataclass
class ScalePolicy:
    min_replicas: int = 1
    max_replicas: int = 8
    #: Scale up when queued requests per alive replica exceed this.
    queue_high_per_replica: float = 4.0
    #: Scale up when gateway p95 TTFT exceeds this (0 = signal off).
    ttft_p95_high_ms: float = 0.0
    #: Scale down only when queued per replica is below this ...
    queue_low_per_replica: float = 0.5
    #: ... AND mean slot occupancy is below this.
    occupancy_low: float = 0.3
    up_patience: int = 2
    down_patience: int = 5
    #: Replicas added per up decision (load can spike faster than one
    #: replica's worth; shrink is always one at a time — drains are
    #: serialized so capacity never cliff-drops).
    up_step: int = 1
    #: Earned-value floor (the draft pool's signal): when a
    #: pool's MEASURED accepted-tokens-per-round falls below this, the
    #: pool is not earning its chips — the pass counts as idle (down
    #: pressure) regardless of occupancy, and up pressure is
    #: suppressed.  0 = signal off; an UNMEASURED pool (0.0 reported)
    #: is never punished.
    tokens_per_round_low: float = 0.0
    #: Memory-pressure ceiling (paged KV): scale up when the
    #: fleet's ``kv_occupancy`` — block-pool utilization under paged
    #: KV, the slot fraction otherwise — exceeds this.  A nearly-full
    #: block pool preempts/queues work even while free SLOTS remain,
    #: a pressure the queue-depth signal lags.  0 = signal off
    #: (default: no behavior change for existing fleets).
    mem_high_occupancy: float = 0.0
    #: Per-chip speed weight.  Queue pressure is judged per WEIGHTED
    #: replica — a pool of chips twice as fast drains twice the queue of
    #: the same count, so it should not bid for more chips at the same
    #: raw depth.  A
    #: snapshot-level ``speed_weight`` (per-pool hardware mix) wins
    #: over this policy default.  1.0 = chips count equal (exactly the
    #: pre-weight behavior).  See ``scheduler.platform.
    #: chip_speed_weight`` for the generation -> weight map.
    speed_weight: float = 1.0


@dataclasses.dataclass
class ScaleState:
    up_streak: int = 0
    down_streak: int = 0


def decide(snapshot: Dict[str, Any], policy: ScalePolicy,
           state: ScaleState) -> int:
    """Target replica count for one pass.  ``snapshot`` is
    ``GatewayCore.stats_snapshot()`` (needs ``replicas_alive``,
    ``queue_depth``, ``occupancy``; ``ttft_p95_ms`` optional).
    Mutates ``state`` streaks; returns the target (== alive when no
    change is warranted)."""
    alive = max(1, int(snapshot.get("replicas_alive", 1)))
    # Weighted capacity: queue depth per unit of decode
    # THROUGHPUT, not per chip — a fast generation absorbs more queue
    # before it deserves another chip, a slow one less.
    weight = float(snapshot.get("speed_weight", policy.speed_weight))
    if weight <= 0:
        weight = 1.0
    queue_per = snapshot.get("queue_depth", 0) / (alive * weight)
    # Memory occupancy when reported (block-pool utilization
    # under paged KV, identical to the slot fraction otherwise — the
    # two agree in dense mode, so hysteresis sees no step at the flag
    # flip), slot occupancy for older snapshots.
    occupancy = float(
        snapshot.get("kv_occupancy", snapshot.get("occupancy", 0.0))
    )
    ttft_p95 = float(snapshot.get("ttft_p95_ms", 0.0))

    pressure = queue_per > policy.queue_high_per_replica or (
        policy.ttft_p95_high_ms > 0
        and ttft_p95 > policy.ttft_p95_high_ms
    ) or (
        policy.mem_high_occupancy > 0
        and occupancy > policy.mem_high_occupancy
    )
    idle = (
        queue_per < policy.queue_low_per_replica
        and occupancy < policy.occupancy_low
    )
    tpr = float(snapshot.get("tokens_per_round", 0.0))
    if policy.tokens_per_round_low > 0 and \
            0 < tpr < policy.tokens_per_round_low:
        # Below break-even the pool is not earning its chips: shed
        # one regardless of occupancy — the chips are worth
        # more wherever the borrow arbiter sends them.
        pressure = False
        idle = True
    if pressure:
        state.up_streak += 1
        state.down_streak = 0
    elif idle:
        state.down_streak += 1
        state.up_streak = 0
    else:
        state.up_streak = 0
        state.down_streak = 0

    target = alive
    if state.up_streak >= policy.up_patience:
        target = min(policy.max_replicas, alive + policy.up_step)
        state.up_streak = 0
    elif state.down_streak >= policy.down_patience:
        target = max(policy.min_replicas, alive - 1)
        state.down_streak = 0
    return target


def mean_measured(values) -> float:
    """Mean over the MEASURED entries (> 0) of an iterable, 0.0 when
    none — the pool-signal aggregation rule (an unmeasured member must
    not drag a pool's signal toward zero)."""
    vals = [v for v in values if v > 0]
    return round(sum(vals) / len(vals), 3) if vals else 0.0


def draft_pool_tokens_per_round(members) -> float:
    """THE draft-pool earned-value convention, defined once
    so the per-gateway snapshot and the tier-wide merge cannot drift:
    a draft pool's value is the mean measured accepted-tokens-per-round
    its CONSUMERS report — the spec-capable non-draft members whose
    acceptance says what the proposals are worth.  ``members`` yields
    ``(spec, role, tokens_per_round)`` triples."""
    return mean_measured(
        t for spec, role, t in members
        if spec and (role or "unified") != "draft"
    )


#: Which snapshot percentile signal matters per role: TTFT is an
#: admission signal — in a disaggregated fleet the prefill pool owns
#: admission latency; decode pressure shows as queue/occupancy only.
_TTFT_ROLES = ("unified", "prefill")


def decide_pools(snapshot: Dict[str, Any],
                 policies: Dict[str, ScalePolicy],
                 states: Dict[str, ScaleState]) -> Dict[str, int]:
    """Per-role pool decisions: one independent
    :func:`decide` pass per role over the gateway snapshot's ``pools``
    block (``GatewayCore.stats_snapshot``: per-role alive/occupancy
    plus the queue depth THAT pool drains — stage-queued work for
    prefill, kv_ready work for decode).  Returns role -> target count;
    roles absent from the snapshot scale against an empty pool.
    ``states`` entries are created on demand, so one dict carries all
    hysteresis."""
    pools = snapshot.get("pools", {})
    targets: Dict[str, int] = {}
    for role, policy in policies.items():
        pool = pools.get(role, {})
        sub = {
            "replicas_alive": pool.get("alive", 0),
            "queue_depth": pool.get("queue_depth", 0),
            "occupancy": pool.get("occupancy", 0.0),
            # Earned-value signal: the draft pool's is the
            # acceptance its CONSUMERS measure (gateway snapshot).
            "tokens_per_round": pool.get("tokens_per_round", 0.0),
        }
        if "kv_occupancy" in pool:
            # Memory headroom carry-through.
            sub["kv_occupancy"] = pool.get("kv_occupancy", 0.0)
        if "speed_weight" in pool:
            # Per-pool hardware mix: a pool's reported
            # mean chip speed weight re-scales its queue pressure.
            sub["speed_weight"] = pool.get("speed_weight", 1.0)
        if role in _TTFT_ROLES:
            sub["ttft_p95_ms"] = snapshot.get("ttft_p95_ms", 0.0)
        targets[role] = decide(
            sub, policy, states.setdefault(role, ScaleState())
        )
    return targets


class PoolAutoScaler:
    """Per-role actuator around :func:`decide_pools` — the
    disaggregated-fleet peer of :class:`ServeAutoScaler`.
    ``scale_up_fn(role, n)`` provisions ``n`` replicas of ``role``;
    ``drain_fn(role)`` picks and drains one replica of that role
    (``GatewayCore.pick_drain_victim(role=...)`` + ``drain``)."""

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict[str, Any]],
        scale_up_fn: Callable[[str, int], Any],
        drain_fn: Callable[[str], Any],
        policies: Dict[str, ScalePolicy],
        interval: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        self.policies = dict(policies)
        self.states: Dict[str, ScaleState] = {}
        self._snapshot_fn = snapshot_fn
        self._scale_up_fn = scale_up_fn
        self._drain_fn = drain_fn
        self._interval = interval
        # Audit stamps flow through this seam: replay feeds a simulated clock and compares decision
        # sequences byte-for-byte; production keeps wall time.
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: list = []  # (ts, role, alive, target)

    def scale_once(self) -> Dict[str, int]:
        """One pass; returns role -> applied delta."""
        snap = self._snapshot_fn()
        pools = snap.get("pools", {})
        targets = decide_pools(snap, self.policies, self.states)
        deltas: Dict[str, int] = {}
        for role, target in targets.items():
            alive = int(pools.get(role, {}).get("alive", 0))
            if target == alive:
                deltas[role] = 0
                continue
            self.decisions.append((self._clock(), role, alive, target))
            journal("autoscale.decide", scope="pool", role=role,
                    alive=alive, target=target,
                    queue_depth=int(
                        pools.get(role, {}).get("queue_depth", 0)
                    ))
            if target > alive:
                logger.info(
                    "serve-autoscaler: scaling %s pool up %d -> %d",
                    role, alive, target,
                )
                self._scale_up_fn(role, target - alive)
            else:
                logger.info(
                    "serve-autoscaler: draining one %s replica "
                    "(%d -> %d)", role, alive, target,
                )
                self._drain_fn(role)
            journal("autoscale.actuate", scope="pool", role=role,
                    delta=target - alive)
            deltas[role] = target - alive
        return deltas

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serve-pool-autoscaler",
                daemon=True,
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scale_once()
            except Exception:  # noqa: BLE001 - scaler must survive
                logger.exception("serve pool-autoscale pass failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


class ServeAutoScaler:
    """Periodic actuator around :func:`decide`.

    ``snapshot_fn`` reads the gateway (a bound
    ``GatewayCore.stats_snapshot`` enriched with the TTFT p95 by the
    :class:`~dlrover_tpu_torch.serving.gateway.Gateway` wrapper);
    ``scale_up_fn(n)`` asks the platform for ``n`` more replicas (the
    master's job manager in a supervised fleet, a subprocess spawner
    otherwise); ``drain_fn()`` picks and drains one replica for
    scale-down (``GatewayCore.pick_drain_victim`` + ``drain``)."""

    def __init__(
        self,
        snapshot_fn: Callable[[], Dict[str, Any]],
        scale_up_fn: Callable[[int], Any],
        drain_fn: Callable[[], Any],
        policy: Optional[ScalePolicy] = None,
        interval: float = 1.0,
        clock: Callable[[], float] = time.time,
    ):
        self.policy = policy or ScalePolicy()
        self.state = ScaleState()
        self._snapshot_fn = snapshot_fn
        self._scale_up_fn = scale_up_fn
        self._drain_fn = drain_fn
        self._interval = interval
        # Same DET705 seam as PoolAutoScaler: injected for replay,
        # wall time by default for operators reading the audit trail.
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.decisions: list = []  # (ts, alive, target) audit trail

    def scale_once(self) -> int:
        """One decision + actuation pass; returns the applied delta."""
        snap = self._snapshot_fn()
        alive = max(1, int(snap.get("replicas_alive", 1)))
        target = decide(snap, self.policy, self.state)
        if target == alive:
            return 0
        self.decisions.append((self._clock(), alive, target))
        journal("autoscale.decide", scope="fleet", alive=alive,
                target=target,
                queue_depth=int(snap.get("queue_depth", 0)),
                ttft_p95_ms=float(snap.get("ttft_p95_ms", 0.0)))
        if target > alive:
            logger.info(
                "serve-autoscaler: scaling up %d -> %d "
                "(queue=%s p95_ttft=%.0fms)", alive, target,
                snap.get("queue_depth"), snap.get("ttft_p95_ms", 0.0),
            )
            self._scale_up_fn(target - alive)
        else:
            logger.info(
                "serve-autoscaler: draining one replica (%d -> %d)",
                alive, target,
            )
            self._drain_fn()
        journal("autoscale.actuate", scope="fleet",
                delta=target - alive)
        return target - alive

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serve-autoscaler", daemon=True
            )
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scale_once()
            except Exception:  # noqa: BLE001 - scaler must survive
                logger.exception("serve-autoscale pass failed")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
