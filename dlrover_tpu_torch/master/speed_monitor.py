"""Training speed and goodput — the port's own copy of
``dlrover_tpu/master/speed_monitor.py`` ``SpeedMonitor``
(``collect_global_step``, ``mark_down``, ``record_ckpt_stall``, the
checkpoint gauges the master logs, ``running_speed``, ``goodput``,
``hang_detected``).

Goodput is the share of wall time since the first step spent making new
progress: the down windows (restart, rendezvous) and the synchronous
checkpoint stalls (per save step, the worst rank's) are taken out.

A step report is a gauge, so with the HA journal bound
(``master/state.py``) only a baseline is journaled, at most every
``ha_speed_journal_s`` (reference ``:57-76``); ``dump_state`` and
``load_state`` (``:86-97``) carry the step records, the first and last
step times and the down and stall totals across a failover.  The
reference's ``ReshardManager`` and ``CellManager`` journal too; they come
with their host layers (``constants.HOST_LAYERS``).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.master.state import JournalBound


class SpeedMonitor(JournalBound):
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ctx = get_context()
        self._records: Deque[Tuple[float, int]] = deque(
            maxlen=self._ctx.train_speed_record_num)
        self._global_step = 0
        self._first_step_time: Optional[float] = None
        self._last_step_time: Optional[float] = None
        self._start_time = time.time()
        self._downtime_total = 0.0
        self._down_since: Optional[float] = None
        self._sample_count = 0
        self._ckpt_stall_total = 0.0
        self._ckpt_stall_last_ms = 0.0
        self._ckpt_stall_by_step: Dict[int, float] = {}
        self._ckpt_persist_mbps = 0.0
        self._ckpt_staged_mbps = 0.0
        self._ckpt_agg_by_node: Dict[int, float] = {}
        self._ckpt_skipped_by_node: Dict[int, int] = {}
        self._last_step_journal = float("-inf")  # monotonic, this process

    def collect_global_step(self, step: int, timestamp: float = 0.0) -> None:
        ts = timestamp or time.time()
        with self._lock:
            if step <= self._global_step:
                return
            self._global_step = step
            self._records.append((ts, step))
            if self._first_step_time is None:
                self._first_step_time = ts
            self._last_step_time = ts
            self._sample_count += 1
            if self._journal is not None:
                now = time.monotonic()
                if now - self._last_step_journal >= \
                        self._ctx.ha_speed_journal_s:
                    self._last_step_journal = now
                    self._journal.append("speed.step",
                                         {"step": step, "ts": ts})
            if self._down_since is not None:
                self._downtime_total += ts - self._down_since
                self._down_since = None

    def dump_state(self) -> dict:
        with self._lock:
            return {"global_step": self._global_step,
                    "records": [list(r) for r in self._records],
                    "first_step_time": self._first_step_time,
                    "last_step_time": self._last_step_time,
                    "downtime_total": self._downtime_total,
                    "ckpt_stall_total": self._ckpt_stall_total}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._global_step = int(state.get("global_step", 0))
            self._records.clear()
            for ts, step in state.get("records", []):
                self._records.append((float(ts), int(step)))
            self._first_step_time = state.get("first_step_time")
            self._last_step_time = state.get("last_step_time")
            self._downtime_total = float(state.get("downtime_total", 0.0))
            self._ckpt_stall_total = float(state.get("ckpt_stall_total",
                                                     0.0))

    def mark_down(self) -> None:
        """Training paused (a restart, a rendezvous)."""
        with self._lock:
            if self._down_since is None:
                self._down_since = time.time()
            self._ckpt_agg_by_node.clear()
            self._ckpt_skipped_by_node.clear()


    def record_ckpt_stall(self, seconds: float, step: Optional[int] = None,
                          persist_mbps: float = 0.0,
                          staged_mbps: float = 0.0,
                          agg_persist_mbps: float = 0.0,
                          tensors_skipped: int = -1,
                          node_id: int = 0) -> None:
        """One reported save stall (``seconds <= 0``: a throughput-only
        report).  Ranks stall together for one save, so a step is charged
        its worst rank's stall, not the sum."""
        with self._lock:
            if persist_mbps > 0.0:
                self._ckpt_persist_mbps = persist_mbps
            if staged_mbps > 0.0:
                self._ckpt_staged_mbps = staged_mbps
            if agg_persist_mbps > 0.0:
                self._ckpt_agg_by_node[int(node_id)] = agg_persist_mbps
            if tensors_skipped >= 0:
                self._ckpt_skipped_by_node[int(node_id)] = int(
                    tensors_skipped)
            if seconds <= 0.0:
                return
            self._ckpt_stall_last_ms = seconds * 1000.0
            if self._down_since is not None:
                return
            if step is None:
                self._ckpt_stall_total += seconds
                return
            prev = self._ckpt_stall_by_step.get(step)
            if prev is None:
                self._ckpt_stall_by_step[step] = seconds
                self._ckpt_stall_total += seconds
                while len(self._ckpt_stall_by_step) > 16:
                    self._ckpt_stall_by_step.pop(
                        next(iter(self._ckpt_stall_by_step)))
            elif seconds > prev:
                self._ckpt_stall_total += seconds - prev
                self._ckpt_stall_by_step[step] = seconds



    @property
    def ckpt_agg_persist_mbps(self) -> float:
        with self._lock:
            return float(sum(self._ckpt_agg_by_node.values()))

    @property
    def ckpt_tensors_skipped(self) -> int:
        with self._lock:
            return int(sum(self._ckpt_skipped_by_node.values()))


    @property
    def ckpt_stall_last_ms(self) -> float:
        with self._lock:
            return self._ckpt_stall_last_ms

    @property
    def completed_global_step(self) -> int:
        with self._lock:
            return self._global_step

    def running_speed(self) -> float:
        """Steps a second over the sliding window."""
        with self._lock:
            if len(self._records) < 2:
                return 0.0
            (t0, s0), (t1, s1) = self._records[0], self._records[-1]
            if t1 <= t0:
                return 0.0
            return (s1 - s0) / (t1 - t0)

    def goodput(self) -> float:
        with self._lock:
            if self._first_step_time is None:
                return 0.0
            now = time.time()
            elapsed = now - self._first_step_time
            down = self._downtime_total + self._ckpt_stall_total
            if self._down_since is not None:
                down += now - self._down_since
            if elapsed <= 0:
                return 0.0
            return max(0.0, min(1.0, (elapsed - down) / elapsed))

    def hang_detected(self, timeout: Optional[float] = None) -> bool:
        """No step for longer than ``hang_timeout_s`` after steps had
        flowed; inside a known down window, twice that."""
        with self._lock:
            if self._last_step_time is None:
                return False
            t = timeout if timeout is not None else self._ctx.hang_timeout_s
            if self._down_since is not None:
                return time.time() - self._down_since > 2 * t
            return time.time() - self._last_step_time > t
