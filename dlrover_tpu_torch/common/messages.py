"""Typed control-plane messages — the port's own copy of the training
messages of ``dlrover_tpu/common/messages.py`` (``Message``, ``serialize``,
``deserialize``, ``_encode``, ``_decode`` and every type that
``MasterServicer``'s table names for a training job, with their replies).

A message is a dataclass registered by class name.  On the wire it is
``{"__msg__": name, "f": {field: value}}`` in msgpack: :func:`serialize`
gives exactly the bytes of the reference's ``msgpack.packb(_encode(msg),
use_bin_type=True)`` — through the port's ``common/msgpack_lite.py``, as
the port depends on no ``msgpack`` — including the omission of an empty
``_WIRE_OPTIONAL`` field, so that each package decodes the other's bytes.
Only control data travels here; tensors ride the shm arena.

The master-HA types (``JournalFetch``, ``JournalChunk``: reference
``:1121``, ``:1134``) are here.  The serving (``Serve*``, ``Replica*``,
``KvSegment*``, ``Draft*``), fleet, cell, reshard, embedding and
observability types come with the slices that bring those layers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from dlrover_tpu_torch.common import msgpack_lite

_REGISTRY: Dict[str, type] = {}
_FIELD_CACHE: Dict[type, tuple] = {}


class Message:
    """Base of every wire message; subclasses are dataclasses.  A field
    named in ``_WIRE_OPTIONAL`` is left out of the encoding while it is
    empty (decoding fills the default)."""

    _WIRE_OPTIONAL: frozenset = frozenset()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        _REGISTRY[cls.__name__] = cls


def _fields_of(cls: type) -> tuple:
    entry = _FIELD_CACHE.get(cls)
    if entry is None:
        entry = (tuple(f.name for f in dataclasses.fields(cls)),
                 cls._WIRE_OPTIONAL)
        _FIELD_CACHE[cls] = entry
    return entry


_RECURSE = (Message, dict, list, tuple)


def _encode(obj: Any) -> Any:
    if isinstance(obj, Message):
        cls = type(obj)
        out = {}
        names, optional = _fields_of(cls)
        for name in names:
            v = getattr(obj, name)
            if not v and name in optional:
                continue
            out[name] = _encode(v) if isinstance(v, _RECURSE) else v
        return {"__msg__": cls.__name__, "f": out}
    if isinstance(obj, dict):
        for v in obj.values():
            if isinstance(v, _RECURSE):
                return {k: _encode(v) for k, v in obj.items()}
        return obj
    if isinstance(obj, (list, tuple)):
        for v in obj:
            if isinstance(v, _RECURSE):
                return [_encode(v) for v in obj]
        return obj if isinstance(obj, list) else list(obj)
    return obj


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if "__msg__" in obj:
            cls = _REGISTRY[obj["__msg__"]]
            return cls(**{k: _decode(v) if isinstance(v, (dict, list))
                          else v for k, v in obj["f"].items()})
        for v in obj.values():
            if isinstance(v, (dict, list)):
                return {k: _decode(v) for k, v in obj.items()}
        return obj
    if isinstance(obj, list):
        for v in obj:
            if isinstance(v, (dict, list)):
                return [_decode(v) for v in obj]
        return obj
    return obj


def serialize(msg: Message) -> bytes:
    return msgpack_lite.packb(_encode(msg))


def deserialize(data: bytes) -> Message:
    return _decode(msgpack_lite.unpackb(data, strict_map_key=False))


def _dict():
    return dataclasses.field(default_factory=dict)


def _list():
    return dataclasses.field(default_factory=list)


# -- generic replies ---------------------------------------------------------

@dataclasses.dataclass
class BaseResponse(Message):
    success: bool = True
    reason: str = ""


@dataclasses.dataclass
class Empty(Message):
    """Handler-less probe: the servicer answers it as unhandled."""


# -- node identity and lifecycle --------------------------------------------

@dataclasses.dataclass
class NodeMeta(Message):
    node_type: str = "worker"
    node_id: int = 0
    node_rank: int = -1
    host: str = ""
    agent_port: int = 0
    slice_id: str = ""
    host_id: str = ""
    tpu_chips: int = 0
    local_world_size: int = 1


@dataclasses.dataclass
class ReportNodeStatus(Message):
    node_id: int = 0
    node_type: str = "worker"
    status: str = ""
    exit_reason: str = ""
    restart_count: int = 0


@dataclasses.dataclass
class NodeFailure(Message):
    node_id: int = 0
    node_rank: int = -1
    error_data: str = ""
    level: str = "error"
    restart_count: int = 0


@dataclasses.dataclass
class Heartbeat(Message):
    node_id: int = 0
    timestamp: float = 0.0


@dataclasses.dataclass
class DiagnosisAction(Message):
    action_type: str = "no_action"
    instance: str = ""
    reason: str = ""
    payload: dict = _dict()


@dataclasses.dataclass
class HeartbeatResponse(Message):
    actions: List[DiagnosisAction] = _list()


# -- rendezvous

@dataclasses.dataclass
class JoinRendezvous(Message):
    node_id: int = 0
    node_rank: int = -1
    local_world_size: int = 1
    rdzv_name: str = "elastic-training"
    node_ip: str = ""
    slice_id: str = ""
    # One per join attempt: the master tells an RPC-retried duplicate
    # (same id: a no-op) from a re-join after a restart (a new id: the
    # stale membership is evicted).
    attempt_id: str = ""


@dataclasses.dataclass
class RendezvousRound(Message):
    round: int = 0


@dataclasses.dataclass
class CommWorldRequest(Message):
    node_id: int = 0
    rdzv_name: str = "elastic-training"


@dataclasses.dataclass
class CommWorld(Message):
    """The world of one completed round: node_rank -> meta dict; ``group``
    is the pair of the network-check rendezvous."""

    rdzv_name: str = "elastic-training"
    round: int = 0
    group: int = 0
    world: dict = _dict()
    coordinator: str = ""


@dataclasses.dataclass
class WaitingNodeNumRequest(Message):
    rdzv_name: str = "elastic-training"


@dataclasses.dataclass
class WaitingNodeNum(Message):
    waiting_num: int = 0


# -- the master's KV store

@dataclasses.dataclass
class KVStoreSet(Message):
    key: str = ""
    value: bytes = b""


@dataclasses.dataclass
class KVStoreGet(Message):
    key: str = ""


@dataclasses.dataclass
class KVStoreValue(Message):
    key: str = ""
    value: bytes = b""
    found: bool = False


@dataclasses.dataclass
class KVStoreMultiSet(Message):
    kvs: dict = _dict()


@dataclasses.dataclass
class KVStoreMultiGet(Message):
    keys: List[str] = _list()


@dataclasses.dataclass
class KVStoreMultiValue(Message):
    kvs: dict = _dict()


@dataclasses.dataclass
class KVStoreAdd(Message):
    key: str = ""
    delta: int = 1
    token: str = ""  # idempotency token: a retried add applies once


@dataclasses.dataclass
class KVStoreCount(Message):
    value: int = 0


@dataclasses.dataclass
class KVStoreScan(Message):
    prefix: str = ""


@dataclasses.dataclass
class KVStoreScanResult(Message):
    kvs: dict = _dict()


@dataclasses.dataclass
class KVStoreDelete(Message):
    key: str = ""
    token: str = ""  # a retried delete gets the first answer


# -- dynamic data sharding ----------------------------------------------------

@dataclasses.dataclass
class DatasetShardParams(Message):
    dataset_name: str = ""
    dataset_size: int = 0
    shard_size: int = 0
    batch_size: int = 0
    num_epochs: int = 1
    shuffle: bool = False
    task_type: str = "training"
    storage_type: str = "text"
    num_minibatches_per_shard: int = 0


@dataclasses.dataclass
class TaskRequest(Message):
    dataset_name: str = ""
    worker_id: int = 0
    token: str = ""


@dataclasses.dataclass
class Task(Message):
    task_id: int = -1
    task_type: str = "training"
    dataset_name: str = ""
    start: int = 0
    end: int = 0
    epoch: int = 0


@dataclasses.dataclass
class TaskResult(Message):
    dataset_name: str = ""
    task_id: int = -1
    worker_id: int = 0
    success: bool = True
    err_message: str = ""


@dataclasses.dataclass
class ShardCheckpointRequest(Message):
    dataset_name: str = ""


@dataclasses.dataclass
class ShardCheckpoint(Message):
    dataset_name: str = ""
    content: str = ""


# -- the pre-flight node check -------------------------------------------------

@dataclasses.dataclass
class NetworkCheckResult(Message):
    node_id: int = 0
    succeeded: bool = True
    elapsed: float = 0.0
    round: int = 0


@dataclasses.dataclass
class NetworkReadyRequest(Message):
    pass


@dataclasses.dataclass
class FaultNodeRequest(Message):
    pass


@dataclasses.dataclass
class FaultNodes(Message):
    nodes: List[int] = _list()
    reason: str = ""


@dataclasses.dataclass
class StragglerRequest(Message):
    pass


@dataclasses.dataclass
class Stragglers(Message):
    nodes: List[int] = _list()
    times: dict = _dict()
    complete: bool = False


# -- metrics

@dataclasses.dataclass
class GlobalStep(Message):
    node_id: int = 0
    step: int = 0
    timestamp: float = 0.0


@dataclasses.dataclass
class CkptPerf(Message):
    node_id: int = 0
    step: int = 0
    stall_ms: float = 0.0
    staged_mbps: float = 0.0
    persist_mbps: float = 0.0
    agg_persist_mbps: float = 0.0
    tensors_skipped: int = -1  # -1: not measured by this report


@dataclasses.dataclass
class UsedResource(Message):
    node_id: int = 0
    cpu_percent: float = 0.0
    memory_mb: float = 0.0
    tpu_duty_cycle: float = 0.0
    hbm_used_mb: float = 0.0


@dataclasses.dataclass
class ModelInfo(Message):
    num_params: int = 0
    flops_per_step: float = 0.0
    batch_size_per_step: int = 0
    extra: dict = _dict()


@dataclasses.dataclass
class DiagnosisReport(Message):
    node_id: int = 0
    data_type: str = ""
    content: str = ""
    timestamp: float = 0.0


# -- named barriers

@dataclasses.dataclass
class SyncJoin(Message):
    sync_name: str = ""
    node_id: int = 0
    node_rank: int = -1


@dataclasses.dataclass
class SyncFinish(Message):
    sync_name: str = ""


@dataclasses.dataclass
class SyncQuery(Message):
    sync_name: str = ""


@dataclasses.dataclass
class CheckpointSync(Message):
    """The cross-node step barrier before a checkpoint commit."""

    node_id: int = 0
    step: int = 0


# -- configuration and exit

@dataclasses.dataclass
class ElasticRunConfigRequest(Message):
    pass


@dataclasses.dataclass
class ElasticRunConfig(Message):
    configs: dict = _dict()


@dataclasses.dataclass
class ParallelConfigRequest(Message):
    node_id: int = 0


@dataclasses.dataclass
class ParallelConfig(Message):
    dataloader: dict = _dict()
    optimizer: dict = _dict()
    mesh: dict = _dict()
    restart: bool = False
    version: int = 0


@dataclasses.dataclass
class JobExitRequest(Message):
    node_id: int = 0
    reason: str = ""
    success: bool = True


# -- master HA ------------------------------------------------------------------
@dataclasses.dataclass
class JournalFetch(Message):
    """A standby's read of the primary's control-state WAL from byte
    ``offset``; ``offset=-1`` asks for the snapshot file."""

    offset: int = 0
    max_bytes: int = 1 << 20


@dataclasses.dataclass
class JournalChunk(Message):
    """Bytes of the primary's WAL from ``offset`` (the snapshot for
    ``offset=-1``).  ``eof``: nothing past ``offset`` now; ``found``:
    False when the primary keeps no journal; ``wal_size``/``wal_ino`` (of
    the file the bytes were read from) show a compaction to the mirror."""

    data: bytes = b""
    offset: int = 0
    eof: bool = True
    found: bool = True
    wal_size: int = -1
    wal_ino: int = 0
