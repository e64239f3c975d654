"""Global tunables — the port's own copy of the control-plane knobs of
``dlrover_tpu/common/global_context.py`` ``Context`` (``get_context``,
``singleton_instance``, ``update``, ``to_dict``, the env overrides).

Each knob has the reference's name, default and environment variable
(``DLROVER_TPU_<UPPER_NAME>``).  Only the knobs that the port's master,
agent, launcher, master HA (``master/state.py``, ``master/standby.py``;
reference ``:92-107``) and the serving auto-scaler (``scale_interval``,
``:36``) read are here; the checkpoint's and live
resharding's come with the modules that read them.
"""

from __future__ import annotations

import os
import threading
from typing import Any

from dlrover_tpu_torch.common.constants import Defaults


class Context:
    _instance = None
    _lock = threading.Lock()

    def __init__(self) -> None:
        self.node_heartbeat_interval: float = Defaults.HEARTBEAT_INTERVAL
        self.node_heartbeat_timeout: float = Defaults.HEARTBEAT_TIMEOUT
        self.rdzv_timeout: float = Defaults.RDZV_TIMEOUT
        # While waiting for a world, an agent re-sends its join (same
        # attempt id: a no-op on a healthy master) this often, so that a
        # restarted master re-learns the membership.  It must exceed the
        # master's lastcall window (3 s).
        self.rdzv_rejoin_interval: float = 10.0
        self.straggler_threshold: float = 1.6
        self.hang_timeout_s: float = 1800.0
        self.train_speed_record_num: int = 50
        self.auto_tune: bool = False
        # The master-side auto-scalers' pass interval, seconds
        # (``master/job_auto_scaler.py``).
        self.scale_interval: float = Defaults.SCALE_INTERVAL
        # Master HA.  The standby declares the primary dead once the
        # journal and the lease file stop changing for ha_lease_s on the
        # standby's own clock (the two processes' clocks are never
        # compared); the primary bumps the lease every ha_lease_interval_s,
        # well under it.  The standby polls the journal every
        # ha_tail_poll_s, the primary snapshots every ha_snapshot_every
        # records, and a step baseline is journaled at most every
        # ha_speed_journal_s.
        self.ha_lease_s: float = 4.0
        self.ha_lease_interval_s: float = 1.0
        self.ha_tail_poll_s: float = 0.2
        self.ha_snapshot_every: int = 1000
        self.ha_speed_journal_s: float = 15.0
        self._apply_env_overrides()

    def _apply_env_overrides(self) -> None:
        for name, cur in list(vars(self).items()):
            if name.startswith("_"):
                continue
            env = os.environ.get(f"DLROVER_TPU_{name.upper()}")
            if env is None:
                continue
            if isinstance(cur, bool):
                setattr(self, name, env.lower() in ("1", "true", "yes"))
            elif isinstance(cur, int):
                setattr(self, name, int(env))
            elif isinstance(cur, float):
                setattr(self, name, float(env))
            else:
                setattr(self, name, env)

    def update(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if hasattr(self, k):
                setattr(self, k, v)

    def to_dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if not k.startswith("_")}

    @classmethod
    def singleton_instance(cls) -> "Context":
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance


def get_context() -> Context:
    return Context.singleton_instance()
