"""Framework-wide constants — the port's own copy of
``dlrover_tpu/common/constants.py`` that the control plane reads
(``NodeType``, ``NodeStatus``, ``JobStage``, ``JobExitReason``,
``RendezvousName``, ``DiagnosisActionType``, ``GRPC``, ``Defaults``; the
env contract's ``NodeEnv`` is in ``common/env.py``), with the same names
and values, so that the two packages' control planes speak one
vocabulary.

The names at the end say where each part of the control plane that the
port does not have yet comes in (ROADMAP.md, Queue A); the options that
would reach one raise ``NotImplementedError`` naming it.  Items 3c.1-3c.4
(the node check, data sharding, the diagnosis manager, the trainer SDK)
are ported; ``HA_ITEM`` (3c.5) is next.
"""

from __future__ import annotations


class NodeType:
    MASTER = "master"
    WORKER = "worker"
    CHIEF = "chief"
    EVALUATOR = "evaluator"
    EMBEDDING = "embedding"
    GATEWAY = "gateway"


class NodeStatus:
    INITIAL = "initial"
    PENDING = "pending"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    DELETED = "deleted"
    FINISHED = "finished"
    BREAKDOWN = "breakdown"
    UNKNOWN = "unknown"

    TERMINAL = frozenset({SUCCEEDED, FAILED, DELETED, FINISHED, BREAKDOWN})




class JobStage:
    INIT = "init"
    PENDING = "pending"
    RUNNING = "running"
    SUSPENDED = "suspended"
    STOPPING = "stopping"
    STOPPED = "stopped"


class JobExitReason:
    SUCCEEDED = "succeeded"
    CODE_ERROR = "code_error"
    NODE_OOM = "node_oom"
    NODE_ERROR = "node_error"
    HANG_ERROR = "hang_error"
    RDZV_TIMEOUT = "rdzv_timeout"
    PENDING_TIMEOUT = "pending_timeout"
    UNKNOWN = "unknown"


class RendezvousName:
    TRAINING = "elastic-training"
    NETWORK_CHECK = "network-check"




class DiagnosisActionType:
    NONE = "no_action"
    RESTART_WORKER = "restart_worker"
    RELAUNCH_WORKER = "relaunch_worker"
    STOP_JOB = "stop_job"
    EVENT = "event"


class GRPC:
    """The largest control-plane message, in bytes (the transport's frame
    limit; the name is the reference's)."""

    MAX_MESSAGE_LENGTH = 256 * 1024 * 1024


class Defaults:
    HEARTBEAT_INTERVAL = 15
    HEARTBEAT_TIMEOUT = 300
    RDZV_TIMEOUT = 600


def _item(what: str) -> str:
    return f"{what} (see ROADMAP.md)"


HA_ITEM = _item(
    "Queue A item 3c.5 of the port (master/{state,standby}.py, the HA "
    "journal and the warm standby)")
#: The host-only layers of ROADMAP.md's Queue A, "the rest".
HOST_LAYERS = _item(
    "the host-only layers of the port (brain/, cells/, fleet/, "
    "scheduler/, obs/, reshard/: Queue A, the rest)")
CHAOS_LAYER = _item("the chaos layer of the port (chaos/: Queue A, the rest)")
MULTICARD_ITEM = _item("Queue A item 5 of the port (multi-card training)")
