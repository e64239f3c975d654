"""The agent's failure diagnosis — the port's own copy of
``dlrover_tpu/diagnosis/agent.py`` ``TrainingLogCollector`` and
``DiagnosisAgent.diagnose_training_failure``: after its workers failed,
does the agent restart them in place, or ask for the node to be replaced?

The node is replaced (``RELAUNCH_WORKER``) when a recent worker log shows
a node-level error (``NODE_ERROR_PATTERNS``), when a worker was SIGKILLed
(-9) and the logs speak of memory, or when the in-place restart budget is
spent; otherwise the workers restart in place (``RESTART_WORKER``).
The patterns are the reference's, so the same logs give the same action
in both packages; a CUDA error in a worker's log is therefore an in-place
restart, counted against the budget.  ``HangingDetector`` watches a
worker's steps (``record_step`` or a heartbeat file's mtime) and calls
back once a stall outlasts its timeout, as the reference's does.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Tuple

from dlrover_tpu_torch.common.constants import DiagnosisActionType
from dlrover_tpu_torch.common.log import logger

NODE_ERROR_PATTERNS = (
    "hardware error",
    "tpu initialization failed",
    "device unavailable",
    "ici link",
    "failed to allocate",
    "resource_exhausted: out of memory",
)


class TrainingLogCollector:
    """The tails of the worker logs written in the last ``max_age_s``."""

    def __init__(self, log_dir: str = "", tail_bytes: int = 65536,
                 max_age_s: float = 600.0):
        self._log_dir = log_dir
        self._tail = tail_bytes
        self._max_age = max_age_s

    def collect(self) -> str:
        if not self._log_dir or not os.path.isdir(self._log_dir):
            return ""
        chunks: List[str] = []
        now = time.time()
        try:
            for name in sorted(os.listdir(self._log_dir)):
                path = os.path.join(self._log_dir, name)
                if not os.path.isfile(path):
                    continue
                if now - os.stat(path).st_mtime > self._max_age:
                    continue
                with open(path, "rb") as f:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() - self._tail))
                    chunks.append(f.read().decode("utf-8",
                                                  errors="replace"))
        except OSError:
            return ""
        return "\n".join(chunks)


class DiagnosisAgent:
    def __init__(self, master_client=None, log_dir: str = "",
                 max_in_place_restarts: int = 3):
        self.client = master_client
        self._log_collector = TrainingLogCollector(log_dir)
        self._max_restarts = max_in_place_restarts

    def diagnose_training_failure(self, failures: List[Tuple[int, int]],
                                  restart_count: int) -> str:
        """``failures``: ``[(local_rank, exit_code)]``; a
        ``DiagnosisActionType``."""
        logs = self._log_collector.collect().lower()
        node_sick = any(p in logs for p in NODE_ERROR_PATTERNS)
        oom_kill = any(code == -9 for _, code in failures) and (
            "out of memory" in logs or "oom" in logs)
        if node_sick or oom_kill:
            reason = "node-level error in worker logs"
            action = DiagnosisActionType.RELAUNCH_WORKER
        elif restart_count > self._max_restarts:
            reason = f"in-place restart budget ({self._max_restarts}) spent"
            action = DiagnosisActionType.RELAUNCH_WORKER
        else:
            reason = "transient/user error; restarting in place"
            action = DiagnosisActionType.RESTART_WORKER
        logger.info("failure diagnosis: %s (%s; failures=%s restarts=%d)",
                    action, reason, failures, restart_count)
        if self.client is not None:
            try:
                self.client.report_diagnosis_data("failure", json.dumps({
                    "failures": failures, "restart_count": restart_count,
                    "action": action, "reason": reason}))
            except Exception as e:  # noqa: BLE001 - the action stands
                logger.debug("failure-diagnosis report failed: %s", e)
        return action


class HangingDetector:
    """Watches a worker's step progress; ``on_hang`` is called once a
    stall outlasts ``hang_timeout_s`` (and then once a stall).  Steps come
    from :meth:`record_step` or the mtime of ``heartbeat_file``; before the
    first step, ``compile_grace_s`` holds the alarm off.  The clock is the
    wall clock, which the file's mtime shares."""

    def __init__(self, hang_timeout_s: float = 1800.0,
                 compile_grace_s: float = 3600.0, on_hang=None,
                 heartbeat_file: str = "", check_interval_s: float = 30.0):
        self._timeout = hang_timeout_s
        self._grace = compile_grace_s
        self._on_hang = on_hang
        self._hb_file = heartbeat_file
        self._interval = check_interval_s
        self._last_step = -1
        self._last_progress = time.time()
        self._started = time.time()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def record_step(self, step: int) -> None:
        with self._lock:
            if step != self._last_step:
                self._last_step = step
                self._last_progress = time.time()

    def _file_mtime(self) -> Optional[float]:
        if not self._hb_file:
            return None
        try:
            return os.stat(self._hb_file).st_mtime
        except OSError:
            return None

    def is_hanging(self) -> bool:
        now = time.time()
        with self._lock:
            last_step = self._last_step
            last_progress = self._last_progress
        mtime = self._file_mtime()
        if mtime is not None:
            last_progress = max(last_progress, mtime)
        if last_step < 0:
            return (now - self._started > self._grace
                    and now - last_progress > self._timeout)
        return now - last_progress > self._timeout

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name="hang-detector",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            if self.is_hanging():
                logger.warning("hang detected: no step progress for >%.0fs",
                               self._timeout)
                if self._on_hang is not None:
                    try:
                        self._on_hang()
                    except Exception:  # noqa: BLE001
                        logger.exception("on_hang callback failed")
                with self._lock:  # one alarm a stall
                    self._last_progress = time.time()
