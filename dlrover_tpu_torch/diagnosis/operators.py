"""The master's inference operators — the port's own copy of
``dlrover_tpu/diagnosis/operators.py`` (``CheckTrainingHangOperator``
``:25``, ``CheckFailureNodeOperator``, ``parse_step_metrics``,
``CheckStragglerOperator``).

The hang signals are the speed monitor's global-step clock (a whole-job
hang, held off by a grace window until the first step is reported) and the
nodes' ``step_metrics`` reports (a node whose reports fell behind its
peers' by more than the timeout).  A failure record whose text names a
node or runtime fault (the reference's patterns) marks the node failed.
The straggler operator reads ``op_metrics`` reports; the port's workers
send none yet (``TrainingArgs.op_metrics_every`` is refused), so it
concludes nothing until that layer comes.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

from dlrover_tpu_torch.diagnosis.data import (
    DiagnosisDataManager,
    DiagnosisDataType,
)
from dlrover_tpu_torch.diagnosis.inference import (
    Attribution,
    Inference,
    InferenceName,
    InferenceOperator,
)


class CheckTrainingHangOperator(InferenceOperator):
    """Nodes whose steps stalled while the job runs."""

    def __init__(self, data_manager: DiagnosisDataManager,
                 speed_monitor=None, hang_timeout_s: float = 1800.0,
                 compile_grace_s: float = 3600.0):
        self._data = data_manager
        self._speed_monitor = speed_monitor
        self._hang_timeout = hang_timeout_s
        self._compile_grace = compile_grace_s
        self._started_at = time.monotonic()

    def is_compatible(self, inference: Inference) -> bool:
        return inference.name == InferenceName.TRAINING_HANG

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        now = time.monotonic()
        if self._speed_monitor is not None:
            if (self._speed_monitor.completed_global_step == 0
                    and now - self._started_at < self._compile_grace):
                return []  # still building, before the first step
            if self._speed_monitor.hang_detected(self._hang_timeout):
                return [Inference(
                    InferenceName.TRAINING_HANG, Attribution.HANG,
                    {"node_id": "-1",
                     "reason": f"global step stalled >"
                               f"{self._hang_timeout:.0f}s"})]
        latest = self._data.latest_per_node(DiagnosisDataType.STEP_METRICS)
        if len(latest) < 2:
            return []
        times = {nid: rec.timestamp for nid, rec in latest.items()}
        freshest = max(times.values())
        return [Inference(
            InferenceName.TRAINING_HANG, Attribution.HANG,
            {"node_id": str(nid),
             "reason": f"node {nid} step reports stalled "
                       f"{freshest - ts:.0f}s behind peers"})
            for nid, ts in times.items()
            if freshest - ts > self._hang_timeout]


class CheckFailureNodeOperator(InferenceOperator):
    """Classifies the reported failures: a node or runtime fault in the
    text means the node is sick (relaunch it), anything else is the
    user's code (restarted in place by the agent)."""

    NODE_ERROR_PATTERNS = (
        "hardware",
        "ici link",
        "device unavailable",
        "tpu initialization failed",
        "out of memory",
        "coordination service",
        "heartbeat",
    )

    def __init__(self, data_manager: DiagnosisDataManager):
        self._data = data_manager

    def is_compatible(self, inference: Inference) -> bool:
        return inference.name == InferenceName.NODE_FAILURE

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        out = []
        for rec in self._data.get_data(DiagnosisDataType.FAILURE):
            content = rec.content.lower()
            node_error = any(p in content for p in self.NODE_ERROR_PATTERNS)
            out.append(Inference(
                InferenceName.NODE_FAILURE,
                Attribution.FAILED if node_error else Attribution.HEALTHY,
                {"node_id": str(rec.node_id), "reason": rec.content[:200],
                 "node_error": str(node_error)}))
        return out


def parse_step_metrics(content: str) -> Optional[dict]:
    """A ``step_metrics`` payload (``{"step": int, "ts": float}``)."""
    try:
        d = json.loads(content)
        return d if isinstance(d, dict) else None
    except (ValueError, TypeError):
        return None


class CheckStragglerOperator(InferenceOperator):
    """A node whose step p50 (``op_metrics`` reports) exceeds ``ratio`` x
    the lower median of the fresh reports."""

    def __init__(self, data_manager: DiagnosisDataManager, *,
                 ratio: float = 2.0, min_nodes: int = 2,
                 stale_s: float = 600.0):
        self._data = data_manager
        self._ratio = ratio
        self._min_nodes = min_nodes
        self._stale = stale_s

    def is_compatible(self, inference: Inference) -> bool:
        return inference.name == InferenceName.STRAGGLER

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        latest = self._data.latest_per_node(DiagnosisDataType.OP_METRICS)
        now = time.time()
        p50, coll = {}, {}
        for nid, rec in latest.items():
            if now - rec.timestamp > self._stale:
                continue
            try:
                payload = json.loads(rec.content)
                if not isinstance(payload, dict):
                    continue
                metrics = payload.get("metrics", payload)
                if not isinstance(metrics, dict):
                    continue
                v = float(metrics.get("step_p50_s", 0.0))
            except (ValueError, TypeError, AttributeError):
                continue
            if v > 0:
                p50[nid] = v
                coll[nid] = float(metrics.get("optime_collective_frac", 0.0))
        if len(p50) < self._min_nodes:
            return []
        xs = sorted(p50.values())
        # The lower median: with two nodes the upper one is the
        # straggler's own value, and the ratio could never exceed it.
        median = xs[(len(xs) - 1) // 2]
        return [Inference(
            InferenceName.STRAGGLER, Attribution.STRAGGLER,
            {"node_id": str(nid),
             "reason": f"node {nid} step p50 {v * 1e3:.0f}ms > "
                       f"{self._ratio:.1f}x cluster median "
                       f"{median * 1e3:.0f}ms "
                       f"(collective_frac={coll.get(nid, 0):.2f})"})
            for nid, v in p50.items()
            if median > 0 and v > self._ratio * median]
