"""Auto-scalers of the master — the port's own copy of the interface and
the serving scaler of ``dlrover_tpu/master/job_auto_scaler.py``:
``JobAutoScaler`` (``:26``), ``ServingFleetAutoScaler`` (``:289-420``) and
the serving branch of ``new_job_auto_scaler`` (``_serving_family``
``:430-455``, the factory ``:490``).

The serving scaler steers a fleet's replica count on its gateways' live
load (queue depth per replica, p95 TTFT, slot occupancy) through the pure
policy of ``serving/autoscale.py``.  ``gateway`` is any object with
``stats_snapshot``, ``pick_drain_victim`` and ``drain``: one
``GatewayCore``, or a ``serving/tier.py`` ``TierActuator`` over a whole
sharded tier.  Scale-up asks the job manager for more replica workers;
scale-down is drain-first and two-phase: the least-loaded replica is
drained at every gateway, and the manager's target is lowered only once
that replica has left every gateway and its worker is reaped
(``_pending_drain``), so no request observes the shrink.

The training, embedding and offline scalers (the speed-based
``AllreduceTrainingAutoScaler``, ``EmbeddingStoreAutoScaler``) need the
cluster-side masters (``dist_master``/``dist_job_manager``, the resource
optimizer): they raise ``NotImplementedError`` naming
``QUEUE_A_ITEMS["rest"]``, and so does a serving job without a gateway,
whose reference falls back to the training scaler.
"""

from __future__ import annotations

import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import HOST_LAYERS
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.common.log import logger


class JobAutoScaler:
    """ABC (reference ``job_auto_scaler.py``)."""

    def start_auto_scaling(self) -> None:
        raise NotImplementedError

    def stop_auto_scaling(self) -> None:
        raise NotImplementedError


class ServingFleetAutoScaler(JobAutoScaler):
    """Replica-count adjustment for a SERVING fleet: the training
    scalers steer on speed history; this one steers on the gateway's
    live load signals (queue depth per replica, p95 TTFT, slot
    occupancy) via the pure policy in ``serving/autoscale.py``.

    Scale-up asks the job manager for more replica workers (each new
    replica registers with the gateway on boot).  Scale-down is
    DRAIN-FIRST: the gateway stops admitting to the least-loaded
    replica, in-flight requests finish, the replica deregisters — only
    then does the job manager release the worker, so no request ever
    observes the shrink."""

    def __init__(
        self,
        job_args,
        job_manager,
        gateway,  # GatewayCore-shaped: stats_snapshot/pick_drain_victim/drain
        policy=None,
        interval: Optional[float] = None,
    ):
        from dlrover_tpu_torch.serving.autoscale import (
            ScalePolicy,
            ScaleState,
        )

        self._job_args = job_args
        self._job_manager = job_manager
        self._gateway = gateway
        group = job_args.workers
        self._policy = policy or ScalePolicy(
            min_replicas=max(1, group.min_count),
            max_replicas=max(group.max_count, 1),
        )
        self._state = ScaleState()
        self._interval = interval or get_context().scale_interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: In-progress two-phase scale-down: (victim replica id, target
        #: worker count).  The manager's count is lowered ONLY after
        #: the drained replica has deregistered and its worker exit is
        #: reaped — an immediate scale_workers_to would kill the
        #: highest-rank live worker, which is generally NOT the replica
        #: the gateway is draining.
        self._pending_drain: Optional[tuple] = None

    def _live_workers(self) -> int:
        return len(self._job_manager.alive_workers()) + len(
            self._job_manager.pending_workers()
        )

    def scale_once(self) -> int:
        """One decision pass; returns the applied worker delta."""
        from dlrover_tpu_torch.serving import autoscale

        snap = self._gateway.stats_snapshot()
        alive = max(1, int(snap.get("replicas_alive", 1)))
        live = self._live_workers()
        if self._pending_drain is not None:
            # Phase B of a scale-down: hold every decision until the
            # drained victim has left the gateway AND its worker exit
            # has been reaped; only then lower the manager's target —
            # at that point it is pure bookkeeping (no live worker is
            # ever killed), it just stops the backfill.
            victim, target = self._pending_drain
            if victim in snap.get("replicas", {}) or live > target:
                return 0
            self._pending_drain = None
            logger.info(
                "serving auto-scaler: drain of %s complete; worker "
                "target -> %d", victim, target,
            )
            self._job_manager.scale_workers_to(target)
            return 0
        target = autoscale.decide(snap, self._policy, self._state)
        if target > alive:
            if live > alive:
                # Workers beyond the registered replicas are still
                # warming up: capacity is already on its way, and an
                # absolute scale_workers_to computed from registered
                # counts could even KILL a warming worker.
                logger.info(
                    "serving auto-scaler: pressure with %d worker(s) "
                    "still warming (%d live, %d registered); holding",
                    live - alive, live, alive,
                )
                return 0
            logger.info(
                "serving auto-scaler: growing replicas %d -> %d "
                "(queue=%s)", alive, target, snap.get("queue_depth"),
            )
            return self._job_manager.scale_workers_to(target)
        if target < alive:
            victim = self._gateway.pick_drain_victim()
            if victim is None:
                return 0
            logger.info(
                "serving auto-scaler: draining replica %s (%d -> %d)",
                victim, alive, target,
            )
            self._gateway.drain(victim)
            self._pending_drain = (victim, target)
        return 0

    def start_auto_scaling(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="serving-auto-scaler",
                daemon=True,
            )
            self._thread.start()

    def stop_auto_scaling(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.scale_once()
            except Exception:
                logger.exception("serving auto-scale pass failed")


def _not_ported(family: str):
    def factory(job_args, job_manager, speed_monitor, **_kw):
        raise NotImplementedError(
            f"the {family} auto-scaler comes with {HOST_LAYERS}")
    return factory


def _serving_family(
    job_args, job_manager, speed_monitor, *,
    resource_optimizer=None, serving_gateway=None, reshard_manager=None,
) -> JobAutoScaler:
    """A serving job needs the gateway handle — its scaler steers on
    live admission-queue signals, not speed.  The reference falls back to
    the speed-based training scaler without one; that scaler is not
    ported, so the port refuses by name."""
    if serving_gateway is None:
        raise NotImplementedError(
            "a serving-strategy job without serving_gateway= falls back "
            f"to the training auto-scaler, which comes with {HOST_LAYERS}")
    return ServingFleetAutoScaler(job_args, job_manager, serving_gateway)


#: ``distribution_strategy`` -> scaler factory (the reference resolves it
#: through its fleet role registry, ``fleet/registry.py``).
_FAMILIES = {
    "allreduce": _not_ported("allreduce (training)"),
    "embedding": _not_ported("embedding-store"),
    "serving": _serving_family,
    "offline": _not_ported("offline-tier"),
}


def new_job_auto_scaler(
    job_args,
    job_manager,
    speed_monitor,
    resource_optimizer=None,
    serving_gateway=None,
    reshard_manager=None,
) -> JobAutoScaler:
    """Factory (reference ``new_job_auto_scaler``): the scaler of
    ``job_args.distribution_strategy``.  Only the serving family is
    ported; an unknown strategy falls to the reference's default family
    (``allreduce``), which is refused."""
    strategy = getattr(job_args, "distribution_strategy", "allreduce")
    factory = _FAMILIES.get(strategy)
    if factory is None:
        logger.error(
            "unknown distribution_strategy %r (registered: %s); "
            "falling back to the %r role family",
            strategy, sorted(_FAMILIES), "allreduce",
        )
        factory = _FAMILIES["allreduce"]
    return factory(
        job_args, job_manager, speed_monitor,
        resource_optimizer=resource_optimizer,
        serving_gateway=serving_gateway,
        reshard_manager=reshard_manager,
    )
