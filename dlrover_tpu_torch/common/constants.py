"""Framework-wide constants — the port's own copy of
``dlrover_tpu/common/constants.py`` that the control plane reads
(``NodeType``, ``NodeStatus``, ``JobStage``, ``JobExitReason``,
``RendezvousName``, ``DiagnosisActionType``, ``GRPC``, ``Defaults``; the
env contract's ``NodeEnv`` is in ``common/env.py``), with the same names
and values, so that the two packages' control planes speak one
vocabulary.

The table at the end, ``QUEUE_A_ITEMS``, names each ROADMAP.md Queue A
item that the port does not have yet; every option that would reach one
raises ``NotImplementedError`` naming it through the table (the names
below it read it), so an item is named one way everywhere.  Items 3 (the
elastic job, master HA included) and 4 (serving: speculative decoding,
``serve_journaled``, the one-host fleet, the sharded gateway tier and
cross-cell spillover) are ported.  Item 5 (multi-card training) is split:
5a, the mesh (FSDP, DP x FSDP and planned placements, the sharded
checkpoint restored onto another mesh), and 5b, sequence parallelism
(ring and Ulysses attention) and the strategy search with its cache, are
ported; 5c-5e remain.
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
    SCALE_INTERVAL = 30


#: ROADMAP.md Queue A's items still to port, by key.
QUEUE_A_ITEMS = {
    "1": "Queue A item 1 of the port (the checkpoint slice's leftovers: "
         "object stores)",
    "5c": "Queue A item 5c of the port (quant_grads, offload_opt, the "
          "offload remat and 8-bit Adam over shards)",
    "5d": "Queue A item 5d of the port (tensor-parallel decode, Megatron "
          "compute for tp-placed weights, activation layouts and several "
          "cards a process)",
    "5e": "Queue A item 5e of the port (cross-node checkpoint replicas and "
          "the orbax layout)",
    "6": "Queue A item 6 of the port (model features: MoE, fp8, LoRA and "
         "the HF import)",
    "rest": "the host-only layers of the port (brain/, cells/, fleet/, "
            "scheduler/, obs/, reshard/: Queue A, the rest)",
    "chaos": "the chaos layer of the port (chaos/: Queue A, the rest)",
}


def item(key: str) -> str:
    """The refusal text of Queue A item ``key``."""
    return f"{QUEUE_A_ITEMS[key]} (see ROADMAP.md)"


OBJECT_STORE_ITEM = item("1")
QUANT_OFFLOAD_ITEM = item("5c")
TP_COMPUTE_ITEM = item("5d")
REPLICA_ITEM = item("5e")
MODEL_ITEM = item("6")
HOST_LAYERS = item("rest")
CHAOS_LAYER = item("chaos")
