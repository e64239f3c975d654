"""The inference chain — the port's own copy of
``dlrover_tpu/diagnosis/inference.py`` (``InferenceName``, ``Inference``,
``InferenceOperator``, ``InferenceChain``, ``Attribution``,
``coordinate_solutions``).  An :class:`Inference` is a hypothesis until an
operator gives it an attribution; the coordinator turns conclusions into
per-node actions: a hang restarts the node's workers, a node failure
relaunches the node.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import DiagnosisActionType
from dlrover_tpu_torch.common.log import logger


class InferenceName:
    TRAINING_HANG = "training_hang"
    NODE_FAILURE = "node_failure"
    STRAGGLER = "straggler"


@dataclasses.dataclass
class Inference:
    name: str
    attribution: str = ""  # "": an unresolved hypothesis
    configs: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def resolved(self) -> bool:
        return bool(self.attribution)


class InferenceOperator:
    def is_compatible(self, inference: Inference) -> bool:
        raise NotImplementedError

    def infer(self, inferences: List[Inference]) -> List[Inference]:
        raise NotImplementedError


class InferenceChain:
    """Runs the compatible operators over each hypothesis and keeps what
    they resolved; an operator that raises is logged and skipped."""

    def __init__(self, operators: List[InferenceOperator]):
        self._operators = operators

    def infer(self, hypotheses: List[Inference]) -> List[Inference]:
        results: List[Inference] = []
        for hyp in hypotheses:
            expanded = [hyp]
            for op in self._operators:
                if not op.is_compatible(hyp):
                    continue
                try:
                    expanded = op.infer(expanded)
                except Exception:  # noqa: BLE001
                    logger.exception("inference operator %s failed",
                                     type(op).__name__)
            results.extend(i for i in expanded if i.resolved)
        return results


class Attribution:
    HANG = "hang"
    FAILED = "failed"
    STRAGGLER = "straggler"
    HEALTHY = "healthy"


def coordinate_solutions(conclusions: List[Inference]
                         ) -> Dict[int, List[m.DiagnosisAction]]:
    """Conclusions -> actions by node id (``-1``: the whole job)."""
    actions: Dict[int, List[m.DiagnosisAction]] = {}
    for c in conclusions:
        node_id = int(c.configs.get("node_id", -1))
        if c.attribution == Attribution.HANG:
            act = m.DiagnosisAction(
                action_type=DiagnosisActionType.RESTART_WORKER,
                instance=str(node_id),
                reason=c.configs.get("reason", "training hang"))
        elif c.attribution == Attribution.FAILED:
            act = m.DiagnosisAction(
                action_type=DiagnosisActionType.RELAUNCH_WORKER,
                instance=str(node_id),
                reason=c.configs.get("reason", "node failure"))
        else:
            continue
        actions.setdefault(node_id, []).append(act)
    return actions
