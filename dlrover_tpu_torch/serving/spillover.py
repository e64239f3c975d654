"""Cross-cell gateway spillover — the port's own copy of
``dlrover_tpu/serving/spillover.py``: a request that lands in a saturated
or dying cell is forwarded, under the same ``req_id``, to a sibling cell.

- ``SpilloverConfig``, ``SpillDecision``, ``_pressure_of`` and
  ``SpilloverPolicy`` (``:61-159``): the pure forward/stay decision over
  the local cell's pressure, the siblings' backpressure view and the
  submit's hop count; the clock is injected.
- ``CellSpillRouter`` (``:160-356``): sits between a cell's gateway
  dispatch (``Gateway.spill_router``) and its ``GatewayCore``.  Local
  admission first; when the core would reject or the cell is draining it
  forwards the SAME ``ServeSubmit`` to a sibling (never queueing it
  locally: the origin counts ``spill_forwarded``, the sibling
  ``spill_ingress``), and adopts the sibling's terminal into the origin's
  dedupe cache on the first status poll that sees it.
- ``GlobalClient`` and ``_rendezvous_key`` (``:357-540``): home-cell
  routing by rendezvous hash over the live cells, and whole-cell failover
  by resubmitting the same ``req_id`` to a survivor.
- ``merge_global_snapshots`` (``:541-585``): the cross-cell roll-up, with
  ``submitted_unique = Σsubmitted − Σspill_ingress``.

Not ported: the reference's ``obs`` spans (``gw.spill_forward``,
``client.cell_failover``); ``obs/`` comes with a later item.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from dlrover_tpu_torch.common.hashring import ring_hash
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    ServeAck,
    ServeStatusReply,
    ServeStatusRequest,
    ServeSubmit,
)

#: Terminal request states — the only outcomes the origin adopts.
TERMINAL_STATES = ("done", "failed", "timeout")


@dataclasses.dataclass(frozen=True)
class SpilloverConfig:
    """Knobs of the forward/stay decision.

    ``max_hops`` bounds forward depth: a request admitted with
    ``spill_hops >= max_hops`` is never re-forwarded, so two mutually
    saturated cells reject instead of ping-ponging one request.
    ``spill_at`` is the local pressure (in_flight / queue_cap) at or
    above which the policy starts forwarding fresh admissions (1.0 =
    only once the core would hard-reject).  ``sibling_headroom`` is
    the pressure a sibling must be BELOW to receive the forward — a
    sibling nearly as hot as the origin would just rebuff the hop.
    ``failure_cooldown_s`` keeps a sibling whose transport just failed
    out of the candidate set long enough for its cell to be declared
    dead or to recover."""

    max_hops: int = 1
    spill_at: float = 1.0
    sibling_headroom: float = 0.85
    failure_cooldown_s: float = 5.0


@dataclasses.dataclass(frozen=True)
class SpillDecision:
    forward: bool
    target: str = ""
    reason: str = ""


def _pressure_of(stats: Dict[str, Any]) -> float:
    """Admission pressure of one cell from whatever fields its merged
    view carries: an explicit ``pressure``, else in_flight/queue_cap,
    else 0.0 (unknown = assume headroom; the rebuff path bounds the
    cost of optimism)."""
    if "pressure" in stats:
        return float(stats["pressure"])
    cap = float(stats.get("queue_cap", 0) or 0)
    if cap > 0:
        return float(stats.get("in_flight", 0)) / cap
    return 0.0


class SpilloverPolicy:
    """Pure forward/stay decision — no I/O, no ambient clock (the
    clock is injected; ``note_failure``/cooldowns advance on it).

    Sibling selection is backpressure-aware and deterministic: among
    alive siblings below ``sibling_headroom`` and out of failure
    cooldown, the least-loaded wins, cell-id as the tiebreak."""

    def __init__(self, config: Optional[SpilloverConfig] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.cfg = config or SpilloverConfig()
        self._clock = clock
        #: cell_id -> clock time of the last transport failure.
        self._failed_at: Dict[str, float] = {}

    def note_failure(self, cell_id: str) -> None:
        """A forward to ``cell_id`` failed at the transport layer:
        cool it down before offering it again."""
        self._failed_at[cell_id] = self._clock()

    def decide(self, local: Dict[str, Any],
               siblings: Dict[str, Dict[str, Any]],
               hops: int = 0) -> SpillDecision:
        """``local``: {"pressure": float, "draining": bool}.
        ``siblings``: cell_id -> {"alive": bool, and pressure fields
        as in :func:`_pressure_of`} — the federation's merged view.
        ``hops``: the submit's ``spill_hops`` (0 = client-fresh)."""
        if hops >= self.cfg.max_hops:
            return SpillDecision(False, reason="hop-budget")
        draining = bool(local.get("draining"))
        if not draining and _pressure_of(local) < self.cfg.spill_at:
            return SpillDecision(False, reason="local-headroom")
        now = self._clock()
        best: Optional[tuple] = None
        for cell_id in sorted(siblings):
            stats = siblings[cell_id]
            if not stats.get("alive", True):
                continue
            failed = self._failed_at.get(cell_id)
            if failed is not None and \
                    now - failed < self.cfg.failure_cooldown_s:
                continue
            pressure = _pressure_of(stats)
            if pressure >= self.cfg.sibling_headroom:
                continue
            key = (pressure, cell_id)
            if best is None or key < best:
                best = key
        if best is None:
            return SpillDecision(False, reason="no-sibling-headroom")
        return SpillDecision(
            True, target=best[1],
            reason="draining" if draining else "saturated",
        )


class CellSpillRouter:
    """One cell's spillover front: local-first admission with a
    policy-gated forward to a sibling cell.

    ``siblings`` maps cell_id -> a transport-shaped object
    (``call(msg, **kw)``): a sibling cell's :class:`TierClient` (its
    ``call`` owner-routes raw messages) or any loopback in tests.
    ``view_fn`` (optional) returns the sibling backpressure view,
    cell_id -> stats dict — in production the federation's merged
    snapshot; absent, siblings are assumed alive with headroom.

    The router NEVER locally queues a request it forwards — the
    origin's windowed histograms and accepted/rejected counters see
    only requests the origin actually served (the hop is counted in
    ``spill_forwarded``/``spill_ingress`` instead; see
    :func:`merge_global_snapshots`)."""

    def __init__(self, cell_id: str, core,
                 siblings: Dict[str, Any],
                 policy: Optional[SpilloverPolicy] = None,
                 view_fn: Optional[
                     Callable[[], Dict[str, Dict[str, Any]]]] = None,
                 clock: Callable[[], float] = time.monotonic,
                 spilled_cap: int = 8192):
        self.cell_id = cell_id
        self._core = core
        self._siblings = siblings
        self._policy = policy or SpilloverPolicy(clock=clock)
        self._view_fn = view_fn
        self._clock = clock
        self._mu = threading.Lock()
        #: req_id -> sibling cell that accepted the forward; entries
        #: leave when the terminal is adopted (bounded oldest-first
        #: like TierClient._inflight for abandoning callers).
        self._spilled: Dict[str, str] = {}
        self._spilled_cap = spilled_cap
        self._draining = False

    # -- operator surface --------------------------------------------------

    def set_draining(self, draining: bool = True) -> None:
        """Cell-shed mode: a dying/blacking-out cell forwards every
        fresh admission while its own in-flight work finishes."""
        self._draining = bool(draining)

    @property
    def spilled_count(self) -> int:
        with self._mu:
            return len(self._spilled)

    # -- admission surface ---------------------------------------------

    def submit(self, msg: ServeSubmit) -> ServeAck:
        peek = self._core.peek_admission(msg.req_id)
        if peek in ("terminal", "duplicate"):
            # The local core already owns this req_id (admitted here,
            # or a sibling terminal adopted earlier): dedupe answers.
            return self._local_submit(msg)
        with self._mu:
            spilled_to = self._spilled.get(msg.req_id)
        if spilled_to is not None:
            # A retried submit of a request already forwarded: keep it
            # with the sibling that owns it (its dedupe/duplicate-
            # submit path absorbs the retry).
            ack = self._forward(msg, spilled_to)
            if ack is not None:
                return ack
        local = {
            "pressure": 1.0 if peek == "full"
            else _pressure_of(self._core.pressure()),
            "draining": self._draining,
        }
        decision = self._policy.decide(
            local, self._sibling_view(), msg.spill_hops,
        )
        if decision.forward:
            ack = self._forward(msg, decision.target)
            if ack is not None:
                return ack
            # Transport failure: the policy cooled the target down —
            # one re-decide covers the remaining siblings.
            retry = self._policy.decide(
                local, self._sibling_view(), msg.spill_hops,
            )
            if retry.forward and retry.target != decision.target:
                ack = self._forward(msg, retry.target)
                if ack is not None:
                    return ack
        # No sibling took it: plain local admission (a full queue
        # rejects with honest backpressure; both-cells-saturated is
        # the client's retry loop, not the router's).
        return self._local_submit(msg)

    def status(self, req_id: str) -> ServeStatusReply:
        local = self._core.status(req_id)
        if local.state != "unknown":
            return local
        with self._mu:
            cell = self._spilled.get(req_id)
        if cell is None:
            return local
        transport = self._siblings.get(cell)
        if transport is None:
            return local
        try:
            reply = transport.call(ServeStatusRequest(req_id=req_id),
                                   deadline=10.0)
        except Exception as e:  # noqa: BLE001 - sibling died mid-poll
            self._policy.note_failure(cell)
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(e))
        if not isinstance(reply, ServeStatusReply):
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(reply))
        if reply.state in TERMINAL_STATES:
            # Adopt the sibling's terminal: from here on the ORIGIN
            # answers resubmits byte-identical from its own dedupe
            # cache — whichever cell owns the terminal, one answer.
            self._core.adopt_terminal(
                req_id, reply.state, reply.tokens,
                replica=reply.replica, reason=reply.reason,
            )
            with self._mu:
                self._spilled.pop(req_id, None)
        return reply

    # -- internals ---------------------------------------------------------

    def _local_submit(self, msg: ServeSubmit) -> ServeAck:
        return self._core.submit(
            msg.req_id, msg.prompt, msg.max_new_tokens,
            msg.deadline_s, msg.prefix_len, msg.prefix_fp, msg.trace,
            spill_hops=msg.spill_hops,
        )

    def _sibling_view(self) -> Dict[str, Dict[str, Any]]:
        if self._view_fn is None:
            return {cell: {"alive": True} for cell in self._siblings}
        try:
            view = self._view_fn() or {}
        except Exception as e:  # noqa: BLE001 - stale view beats none
            logger.warning("spillover: sibling view failed: %s", e)
            return {cell: {"alive": True} for cell in self._siblings}
        return {cell: view.get(cell, {"alive": True})
                for cell in self._siblings}

    def _forward(self, msg: ServeSubmit,
                 cell: str) -> Optional[ServeAck]:
        """One hop to ``cell``; None = the forward failed (transport
        error or sibling rebuff) and the caller falls back."""
        transport = self._siblings.get(cell)
        if transport is None:
            return None
        fwd = dataclasses.replace(
            msg,
            spill_from=msg.spill_from or self.cell_id,
            spill_hops=msg.spill_hops + 1,
        )
        try:
            ack = transport.call(fwd, deadline=10.0)
        except Exception as e:  # noqa: BLE001 - sibling died mid-hop
            logger.warning(
                "spillover: forward of %s from %s to %s failed: %s",
                msg.req_id, self.cell_id, cell, e,
            )
            self._policy.note_failure(cell)
            return None
        if not isinstance(ack, ServeAck) or ack.status == "rejected":
            # The sibling rebuffed (it is saturated too): let the
            # origin's own reject path answer with honest backpressure.
            return None
        with self._mu:
            self._spilled[msg.req_id] = cell
            while len(self._spilled) > self._spilled_cap:
                self._spilled.pop(next(iter(self._spilled)))
        # One submitted per client call, wherever it lands: the origin
        # folds `submitted` (the client arrived HERE) + the hop mark.
        self._core.fold_external("submitted")
        self._core.fold_external("spill_forwarded")
        logger.info(
            "spillover: %s forwarded %s -> %s (hops=%d, ack=%s)",
            msg.req_id, self.cell_id, cell, fwd.spill_hops, ack.status,
        )
        return ack


class GlobalClient:
    """Cross-cell front door: deterministic home-cell routing with
    whole-cell failover — ``TierClient``'s owner/resubmit contract
    lifted one level, from gateways in a cell to cells on the planet.

    ``cells`` maps cell_id -> a TierClient-shaped object (``submit`` /
    ``status`` kwargs surface).  ``alive_fn`` (optional) returns the
    currently-live cell ids (the federation's view); a cell absent
    from it is skipped without waiting out a transport timeout.  On a
    blackout the client resubmits the SAME req_id to a survivor: if
    the dead cell had spilled the request there, the survivor's dedupe
    cache answers byte-identical; if not, the survivor serves it fresh
    — either way exactly once, because the dead cell can no longer
    answer."""

    def __init__(self, cells: Dict[str, Any],
                 alive_fn: Optional[Callable[[], Any]] = None,
                 poll_interval: float = 0.01):
        self._cells = dict(cells)
        self._alive_fn = alive_fn
        self._poll_interval = poll_interval
        self._mu = threading.Lock()
        #: req_id -> (owning cell, submit kwargs) until terminal.
        self._inflight: Dict[str, dict] = {}
        self.cell_failovers = 0

    # -- routing -----------------------------------------------------------

    def _alive(self) -> List[str]:
        cells = sorted(self._cells)
        if self._alive_fn is not None:
            try:
                live = set(self._alive_fn())
            except Exception:  # noqa: BLE001 - stale view beats none
                return cells
            alive = [c for c in cells if c in live]
            return alive or cells
        return cells

    def home_cell(self, req_id: str) -> Optional[str]:
        """Rendezvous hash over live cells: stable per req_id while
        the cell set holds, deterministic across every client."""
        cells = self._alive()
        if not cells:
            return None
        return max(cells, key=lambda c: ring_hash(f"{c}|{req_id}"))

    # -- client surface ------------------------------------------------

    def submit(self, req_id: str, prompt, max_new_tokens: int,
               deadline_s: float = 0.0,
               submit_timeout: float = 10.0) -> ServeAck:
        kwargs = {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "deadline_s": float(deadline_s),
        }
        home = self.home_cell(req_id)
        order = ([home] if home else []) + [
            c for c in self._alive() if c != home
        ]
        last = ServeAck(req_id=req_id, status="rejected",
                        reason="no live cell")
        for cell in order:
            ack = self._submit_to(cell, req_id, kwargs, submit_timeout)
            if ack is None:
                continue
            if ack.status != "rejected":
                with self._mu:
                    self._inflight[req_id] = {"cell": cell,
                                              "kwargs": kwargs}
                    while len(self._inflight) > 8192:
                        self._inflight.pop(next(iter(self._inflight)))
                if ack.status != "accepted":
                    self._forget(req_id)  # dedupe-cache terminal
                return ack
            last = ack
        return last

    def result(self, req_id: str, timeout: float = 30.0
               ) -> ServeStatusReply:
        """Poll to a terminal state, riding out whole-cell deaths by
        resubmitting the same req_id to a surviving cell."""
        deadline = time.monotonic() + timeout
        while True:
            with self._mu:
                ent = self._inflight.get(req_id)
            cell = ent["cell"] if ent else self.home_cell(req_id)
            reply = self._status_at(cell, req_id)
            if reply.state in TERMINAL_STATES:
                self._forget(req_id)
                return reply
            if reply.state == "unknown":
                self._failover(req_id, dead=cell)
            if time.monotonic() >= deadline:
                return reply
            time.sleep(self._poll_interval)

    # -- internals ---------------------------------------------------------

    def _submit_to(self, cell: str, req_id: str, kwargs: dict,
                   submit_timeout: float) -> Optional[ServeAck]:
        cli = self._cells.get(cell)
        if cli is None:
            return None
        try:
            ack = cli.submit(req_id, kwargs["prompt"],
                             kwargs["max_new_tokens"],
                             deadline_s=kwargs["deadline_s"],
                             submit_timeout=submit_timeout)
        except Exception as e:  # noqa: BLE001 - cell died mid-submit
            logger.warning(
                "global client: submit %s to cell %s failed: %s",
                req_id, cell, e,
            )
            return None
        return ack if isinstance(ack, ServeAck) else None

    def _status_at(self, cell: Optional[str],
                   req_id: str) -> ServeStatusReply:
        cli = self._cells.get(cell) if cell else None
        if cli is None:
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason="no live cell")
        try:
            return cli.status(req_id)
        except Exception as e:  # noqa: BLE001 - cell died mid-poll
            return ServeStatusReply(req_id=req_id, state="unknown",
                                    reason=str(e))

    def _failover(self, req_id: str, dead: Optional[str]) -> None:
        """The owning cell answered ``unknown`` (blacked out, or
        adopted ranges without the queue): resubmit the same req_id to
        the best surviving cell.  Idempotent — the survivor's dedupe
        cache (terminal spilled there earlier) or duplicate-submit
        path absorbs repeats without re-decoding."""
        with self._mu:
            ent = self._inflight.get(req_id)
        if ent is None:
            return
        survivors = [c for c in self._alive() if c != dead]
        if not survivors:
            return
        target = max(
            survivors,
            key=lambda c: _rendezvous_key(c, req_id),
        )
        ack = self._submit_to(target, req_id, ent["kwargs"],
                              submit_timeout=2.0)
        if ack is None or ack.status == "rejected":
            return
        with self._mu:
            self._inflight[req_id] = {"cell": target,
                                      "kwargs": ent["kwargs"]}
        self.cell_failovers += 1
        logger.info(
            "global client: resubmitted %s to cell %s after cell %s "
            "went dark (ack=%s)", req_id, target, dead, ack.status,
        )

    def _forget(self, req_id: str) -> None:
        with self._mu:
            self._inflight.pop(req_id, None)


def _rendezvous_key(cell: str, req_id: str) -> int:
    return ring_hash(f"{cell}|{req_id}")


def merge_global_snapshots(
        cell_snaps: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Roll per-cell merged tier snapshots (``tier.merge_snapshots``
    output) up to ONE global view, deduping the spillover hop.

    A forwarded request is counted ``submitted`` twice — once at the
    origin (the client arrived there) and once at the sibling (marked
    ``spill_ingress`` because its submit carried ``spill_hops>0``) —
    both under the same req_id.  ``submitted_unique`` subtracts the
    ingress marks, so every client call counts exactly once and the
    conservation law (unique = terminal outcomes + in flight, minus
    terminal rejects) holds ACROSS the hop, not just inside a cell."""
    counters: Dict[str, int] = {}
    cells: Dict[str, Dict[str, Any]] = {}
    in_flight = 0
    queue_depth = 0
    replicas_alive = 0
    for cell_id in sorted(cell_snaps):
        snap = cell_snaps[cell_id] or {}
        for name, val in (snap.get("counters") or {}).items():
            counters[name] = counters.get(name, 0) + int(val)
        in_flight += int(snap.get("in_flight", 0))
        queue_depth += int(snap.get("queue_depth", 0))
        replicas_alive += int(snap.get("replicas_alive", 0))
        cells[cell_id] = {
            "in_flight": int(snap.get("in_flight", 0)),
            "queue_depth": int(snap.get("queue_depth", 0)),
            "replicas_alive": int(snap.get("replicas_alive", 0)),
            "counters": dict(snap.get("counters") or {}),
        }
    submitted = counters.get("submitted", 0)
    ingress = counters.get("spill_ingress", 0)
    return {
        "cells": cells,
        "cells_alive": len(cells),
        "in_flight": in_flight,
        "queue_depth": queue_depth,
        "replicas_alive": replicas_alive,
        "counters": counters,
        "submitted_unique": submitted - ingress,
        "spill_forwarded": counters.get("spill_forwarded", 0),
        "spill_ingress": ingress,
        "spill_rebuffed": counters.get("spill_rebuffed", 0),
        "spill_adopted": counters.get("spill_adopted", 0),
    }
