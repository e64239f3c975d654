"""User-facing flash checkpointer — the port's own counterpart of
``dlrover_tpu/checkpoint/checkpointer.py`` ``FlashCheckpointer``.

    ckpt = FlashCheckpointer("/ckpt/run1")
    ckpt.save(state, meta={"step": step})                # shm only (fast)
    ckpt.save(state, meta={"step": step}, storage=True)  # + async persist
    restored = ckpt.load(target=state)                   # warm shm else disk
    ckpt.wait()

``state`` is the train state of ``parallel.accelerate`` (``{"params",
"opt_state", "step"}``); ``load`` copies into its live tensors.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from dlrover_tpu_torch.checkpoint.engine import CheckpointEngine
from dlrover_tpu_torch.common.storage import CheckpointStorage


class FlashCheckpointer:
    def __init__(
        self,
        ckpt_dir: str,
        *,
        job_name: str = "",
        storage: Optional[CheckpointStorage] = None,
        # None = keep 3 steps; 0 = keep all; N > 0 = keep the newest N.
        max_to_keep: Optional[int] = None,
    ):
        self.engine = CheckpointEngine(ckpt_dir, job_name=job_name,
                                       storage=storage,
                                       max_to_keep=max_to_keep)

    def save(self, state: Any, meta: Optional[dict] = None,
             storage: bool = False) -> None:
        step = int((meta or {}).get("step", 0))
        if storage:
            self.engine.save_to_storage(step, state, meta)
        else:
            self.engine.save_to_memory(step, state, meta)

    def load(self, target: Any = None) -> Optional[Tuple[Any, dict]]:
        return self.engine.load(target)

    def wait(self, timeout: float = 600.0) -> bool:
        return self.engine.wait(timeout)

    def close(self) -> None:
        self.engine.close()
