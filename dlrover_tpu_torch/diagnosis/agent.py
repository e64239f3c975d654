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
restart, counted against the budget.  ``HangingDetector`` and the step
heartbeat files come with ``constants.DIAGNOSIS_ITEM``.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Tuple

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
