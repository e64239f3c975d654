"""The master's diagnosis manager — the port's own copy of
``dlrover_tpu/diagnosis/manager.py`` ``DiagnosisManager`` (``:37``:
``collect_data``, ``report_failure``, ``enqueue_broadcast`` ``:97``,
``pop_actions`` ``:147``, the loop and ``diagnose_once`` ``:226``).

The servicer stores what the agents and workers report (``collect_data``,
``report_failure``); every ``interval_s`` (60 s) the loop runs the
inference chain over it and queues each conclusion's action for its
node; a node's next heartbeat pops its actions.  A whole-job conclusion
(node ``-1``, a global hang) fans out to the nodes alive at that moment
(``alive_nodes_fn``).  An action delivered is not queued again for the
same record until the redelivery cooldown (the data TTL) has passed, and
an undelivered one expires after ``BROADCAST_TTL_S``: a relaunched node
must not be killed again by a stale record.  The clocks are wall clocks:
the records carry the reporters' timestamps.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.diagnosis.data import (
    DiagnosisDataManager,
    DiagnosisDataType,
)
from dlrover_tpu_torch.diagnosis.inference import (
    Inference,
    InferenceChain,
    InferenceName,
    coordinate_solutions,
)
from dlrover_tpu_torch.diagnosis.operators import (
    CheckFailureNodeOperator,
    CheckStragglerOperator,
    CheckTrainingHangOperator,
)


class DiagnosisManager:
    BROADCAST_TTL_S = 300.0

    def __init__(self, speed_monitor=None, interval_s: float = 60.0,
                 hang_timeout_s: float = 1800.0, alive_nodes_fn=None):
        self.alive_nodes_fn = alive_nodes_fn
        self.speed_monitor = speed_monitor
        # The TTL outlives the hang timeout, or a stalled node's records
        # would expire before its stall could be seen.
        self.data_manager = DiagnosisDataManager(
            ttl_s=max(600.0, 2.0 * hang_timeout_s))
        self._interval = interval_s
        self._chain = InferenceChain([
            CheckTrainingHangOperator(self.data_manager, speed_monitor,
                                      hang_timeout_s=hang_timeout_s),
            CheckFailureNodeOperator(self.data_manager),
            CheckStragglerOperator(self.data_manager),
        ])
        # The latest runtime stragglers: observed and logged, never acted
        # on (a slow node that progresses is not restarted).
        self.runtime_stragglers: Dict[int, str] = {}
        self._lock = threading.Lock()
        self._pending: Dict[int, List[m.DiagnosisAction]] = {}
        # (node_id, action_type, reason) -> delivery time.
        self._delivered: Dict[tuple, float] = {}
        self._redeliver_cooldown_s = self.data_manager._ttl
        self._integrity_seen_ts = 0.0
        self._ckpt_perf_seen: tuple = (0.0, 0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- the servicer's entry points ------------------------------------------
    def collect_data(self, msg: m.DiagnosisReport) -> None:
        self.data_manager.store_data(msg.node_id, msg.data_type, msg.content,
                                     msg.timestamp or None)

    def report_failure(self, msg: m.NodeFailure) -> None:
        self.data_manager.store_data(msg.node_id, DiagnosisDataType.FAILURE,
                                     msg.error_data)

    def enqueue_broadcast(self, action_type: str, reason: str,
                          node_ids) -> int:
        """Queue one action for each of ``node_ids``' next heartbeats: the
        nodes named now, each with its own action object; a node already
        holding the same instruction gets no second copy, and expired
        entries are purged first.  The number queued."""
        now = time.time()
        queued = 0
        with self._lock:
            for nid in node_ids:
                existing = [e for e in self._pending.get(nid, [])
                            if now - e.payload.get("created", now)
                            < self.BROADCAST_TTL_S]
                self._pending[nid] = existing
                if any(e.action_type == action_type and e.reason == reason
                       for e in existing):
                    continue
                existing.append(m.DiagnosisAction(
                    action_type=action_type, reason=reason,
                    payload={"created": now}))
                queued += 1
        if queued:
            logger.info("diagnosis: broadcast %s to %d node(s) (%s)",
                        action_type, queued, reason)
        return queued

    def pop_actions(self, node_id: int) -> List[m.DiagnosisAction]:
        """The node's actions, consumed on delivery; those older than
        ``BROADCAST_TTL_S`` are dropped."""
        now = time.time()
        with self._lock:
            return [a for a in self._pending.pop(node_id, [])
                    if now - a.payload.get("created", now)
                    < self.BROADCAST_TTL_S]

    def pre_check(self) -> bool:
        return True

    # -- the loop -------------------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="diagnosis", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.diagnose_once()
            except Exception:  # noqa: BLE001
                logger.exception("diagnosis pass failed")

    def _surface_integrity_reports(self) -> None:
        """Log new checkpoint-integrity records (observed only: the
        restore ladder already routed around the damage)."""
        recs = self.data_manager.get_data(DiagnosisDataType.CKPT_INTEGRITY)
        fresh = [r for r in recs if r.timestamp > self._integrity_seen_ts]
        if not fresh:
            return
        self._integrity_seen_ts = max(r.timestamp for r in fresh)
        for rec in fresh:
            logger.warning("ckpt integrity (node %d): %s", rec.node_id,
                           rec.content)

    def _surface_ckpt_perf(self) -> None:
        """Log the aggregate persist rate and the skipped tensors when
        they move."""
        sm = self.speed_monitor
        if sm is None:
            return
        try:
            cur = (round(float(sm.ckpt_agg_persist_mbps), 1),
                   int(sm.ckpt_tensors_skipped))
        except AttributeError:  # a stand-in monitor without the gauges
            return
        if cur == self._ckpt_perf_seen or cur[0] <= 0.0:
            return
        self._ckpt_perf_seen = cur
        logger.info("ckpt perf: aggregate persist %.0f MB/s, %d tensors "
                    "skipped by dirty fences (goodput %.3f)", cur[0], cur[1],
                    sm.goodput())

    def diagnose_once(self) -> Dict[int, List[m.DiagnosisAction]]:
        self._surface_integrity_reports()
        self._surface_ckpt_perf()
        conclusions = self._chain.infer([
            Inference(InferenceName.TRAINING_HANG),
            Inference(InferenceName.NODE_FAILURE),
            Inference(InferenceName.STRAGGLER),
        ])
        stragglers = {int(c.configs.get("node_id", -1)):
                      c.configs.get("reason", "")
                      for c in conclusions
                      if c.name == InferenceName.STRAGGLER and c.resolved}
        if stragglers and stragglers.keys() != self.runtime_stragglers.keys():
            logger.warning("runtime stragglers: %s", stragglers)
        self.runtime_stragglers = stragglers
        actions = coordinate_solutions(conclusions)
        if actions:
            logger.info("diagnosis: %s", {
                nid: [a.action_type for a in acts]
                for nid, acts in actions.items()})
        now = time.time()
        whole_job: List[tuple] = []
        with self._lock:
            for key, ts in list(self._delivered.items()):
                if now - ts > self._redeliver_cooldown_s:
                    del self._delivered[key]
            for nid, acts in actions.items():
                for act in acts:
                    # The cooldown keys on the diagnosed scope: a
                    # whole-job incident is one incident.
                    key = (nid, act.action_type, act.reason)
                    if key in self._delivered:
                        continue
                    act.payload.setdefault("created", now)
                    if nid == -1:
                        whole_job.append((key, act.action_type, act.reason))
                        continue
                    existing = self._pending.setdefault(nid, [])
                    if not any(e.action_type == act.action_type
                               and e.reason == act.reason
                               for e in existing):
                        existing.append(act)
                        self._delivered[key] = now
        for key, action_type, reason in whole_job:
            targets = self.alive_nodes_fn() if self.alive_nodes_fn else []
            if targets:
                # The cooldown starts only once the fan-out reached a
                # node: with none alive, the next pass tries again.
                self.enqueue_broadcast(action_type, reason, targets)
                with self._lock:
                    self._delivered[key] = now
            else:
                logger.warning("whole-job action %s (%s) has no alive "
                               "nodes yet; will retry next diagnosis pass",
                               action_type, reason)
        return actions
