"""The master's diagnosis data store — the port's own copy of
``dlrover_tpu/diagnosis/data.py`` (``DiagnosisDataType``,
``DiagnosisRecord``, ``DiagnosisDataManager``): the agents' and workers'
reports, a bounded time series a type, each record dropped once it is
older than the TTL.  Record timestamps are the reporters' wall clocks.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional


class DiagnosisDataType:
    """The ``DiagnosisReport.data_type`` values of the reference."""

    TRAINING_LOG = "training_log"
    STEP_METRICS = "step_metrics"
    OP_METRICS = "op_metrics"
    NODE_RESOURCE = "node_resource"
    FAILURE = "failure"
    CKPT_INTEGRITY = "ckpt_integrity"


@dataclasses.dataclass
class DiagnosisRecord:
    node_id: int
    data_type: str
    content: str
    timestamp: float


class DiagnosisDataManager:
    def __init__(self, ttl_s: float = 600.0, max_per_type: int = 1000):
        self._ttl = ttl_s
        self._max = max_per_type
        self._lock = threading.Lock()
        self._data: Dict[str, List[DiagnosisRecord]] = {}

    def store_data(self, node_id: int, data_type: str, content: str,
                   timestamp: Optional[float] = None) -> None:
        rec = DiagnosisRecord(node_id, data_type, content,
                              timestamp or time.time())
        with self._lock:
            series = self._data.setdefault(data_type, [])
            series.append(rec)
            self._expire_locked(series)

    def get_data(self, data_type: str) -> List[DiagnosisRecord]:
        with self._lock:
            series = self._data.get(data_type, [])
            self._expire_locked(series)
            return list(series)

    def latest_per_node(self, data_type: str) -> Dict[int, DiagnosisRecord]:
        out: Dict[int, DiagnosisRecord] = {}
        for rec in self.get_data(data_type):
            cur = out.get(rec.node_id)
            if cur is None or rec.timestamp > cur.timestamp:
                out[rec.node_id] = rec
        return out

    def _expire_locked(self, series: List[DiagnosisRecord]) -> None:
        cutoff = time.time() - self._ttl
        while series and series[0].timestamp < cutoff:
            series.pop(0)
        if len(series) > self._max:
            del series[: len(series) - self._max]
