"""Central logger — the port's own copy of ``dlrover_tpu/common/log.py``.

One process-wide logger with a consistent format; level from
``DLROVER_TPU_LOG_LEVEL``.  Sub-process roles prefix their records via
``set_role``.
"""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)

_ROLE = os.environ.get("DLROVER_TPU_ROLE", "")


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    level = os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    fmt = _FORMAT if not _ROLE else f"[{_ROLE}] {_FORMAT}"
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


logger = _build_logger()


def set_role(role: str) -> None:
    """Tag this process's log lines with its role (master/agent/worker-N)."""
    global _ROLE
    _ROLE = role
    for h in logger.handlers:
        h.setFormatter(logging.Formatter(f"[{role}] {_FORMAT}"))
