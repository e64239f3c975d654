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
``:1121``, ``:1134``) are here, and the serving fleet's (``ServeSubmit``
through ``ServeFleetStats``, reference ``:665-970``).  The checkpoint
replica (``Replica*``), fleet, cell, reshard, embedding and observability
types come with the slices that bring those layers.
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


# ---------------------------------------------------------------------------
# Serving fleet (gateway <-> clients, gateway <-> replicas): the typed
# wire surface of ``dlrover_tpu_torch.serving``, byte for byte the JAX
# package's.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeSubmit(Message):
    """Client -> gateway: one inference request.  ``req_id`` doubles as
    the idempotency token (BoundedTokenCache dedupe): a retried submit
    of a completed request returns the cached result instead of
    decoding twice.

    Prefix-aware routing: ``prompt`` carries the FULL token
    sequence; ``prefix_len > 0`` declares its leading tokens a shared
    template whose fingerprint ``prefix_fp`` the gateway routes on
    (warm replicas first) and the replica prefix-caches.

    The same dataclass is the gateway -> replica grant: ``stage``
    selects the path (``full`` = prefill+decode on one replica;
    ``prefill`` = score the prompt and hand the KV segment back;
    ``decode`` = continue from the attached ``kv`` segment, packed by
    ``llama_infer.pack_kv_segment`` with an embedded CRC)."""

    req_id: str = ""
    prompt: List[int] = dataclasses.field(default_factory=list)
    max_new_tokens: int = 16
    deadline_s: float = 0.0  # 0 = no per-request deadline
    prefix_len: int = 0  # leading tokens shared with other requests
    prefix_fp: str = ""  # fingerprint of prompt[:prefix_len]
    stage: str = "full"  # full | prefill | decode (grant direction)
    kv: bytes = b""  # packed KV segment (relayed decode grants only)
    # Peer-to-peer KV handoff.  On a decode grant, a
    # non-empty ``kv_addr`` is a TICKET: the decode replica pulls the
    # segment bytes directly from the prefill replica's segment server
    # at that address (``KvSegmentFetch``), verifying ``kv_crc32`` /
    # ``kv_nbytes`` / ``kv_fp`` — the gateway never touched the bytes.
    # On a prefill grant, ``kv_relay=True`` orders the old
    # through-the-gateway payload path (the fallback after a failed
    # pull, and the compat mode for non-P2P replicas).
    kv_addr: str = ""
    kv_fp: str = ""
    kv_crc32: int = 0
    kv_nbytes: int = 0
    kv_relay: bool = False
    #: Distributed-trace context: ``{"tid": trace_id,
    #: "sid": parent span id}``.  Wire-optional — a trace-less submit
    #: (or an unsampled request's grant) encodes byte-identically to
    #: the pre-trace wire, keeping the msgpack fast path intact.
    trace: dict = dataclasses.field(default_factory=dict)
    #: Cross-cell spillover.  A saturated/dying cell's
    #: gateway forwards the submit to a sibling cell UNDER THE SAME
    #: req_id — the hop rides the existing req_id-keyed dedupe/journal
    #: contracts, so killing either side mid-hop still completes the
    #: request exactly once.  ``spill_from`` names the origin cell;
    #: ``spill_hops`` counts forwards so depth stays bounded (a request
    #: never ping-pongs between two saturated cells).  Both are
    #: wire-optional: a local submit encodes byte-identically to the
    #: pre-spillover wire.
    spill_from: str = ""
    spill_hops: int = 0

    _WIRE_OPTIONAL = frozenset({"trace", "spill_from", "spill_hops"})


@dataclasses.dataclass
class ServeAck(Message):
    """Gateway's immediate answer to a submit: ``accepted`` (queued),
    ``rejected`` with an explicit ``retry_after_s`` (bounded-queue
    backpressure: the client backs off instead of the queue growing
    without bound), or a terminal state from the dedupe cache —
    ``done`` (tokens included), ``failed``, or ``timeout`` (the req_id
    is the idempotency key; retry a failure under a fresh id)."""

    req_id: str = ""
    status: str = "accepted"  # accepted | done | rejected
    tokens: List[int] = dataclasses.field(default_factory=list)
    retry_after_s: float = 0.0
    reason: str = ""


@dataclasses.dataclass
class ServeStatusRequest(Message):
    req_id: str = ""


@dataclasses.dataclass
class ServeStatusReply(Message):
    """``state``: queued | running | done | failed | timeout | unknown.
    ``tokens`` carries the streamed-so-far prefix while running and the
    full completion once done."""

    req_id: str = ""
    state: str = "unknown"
    tokens: List[int] = dataclasses.field(default_factory=list)
    replica: str = ""
    reason: str = ""


@dataclasses.dataclass
class ServeReplicaRegister(Message):
    """``role``: ``unified`` replicas run the full
    prefill+decode path; ``prefill`` replicas only score prompts and
    export KV segments; ``decode`` replicas only continue from imported
    segments (missing field on old senders decodes to "" = unified).

    Speculative serving: ``spec`` advertises that this
    replica can run speculative decode rounds (a local draft model, or
    a server sized to accept a remote draft handle) — the gateway's
    grant scan prefers spec replicas for long-decode requests.  A
    ``draft``-role replica additionally announces ``draft_addr``, the
    address of its proposal server, which the gateway hands to spec
    targets in every poll reply."""

    replica_id: str = ""
    slots: int = 0
    role: str = "unified"  # unified | prefill | decode | draft
    spec: bool = False
    draft_addr: str = ""


@dataclasses.dataclass
class ServeReplicaDeregister(Message):
    replica_id: str = ""


@dataclasses.dataclass
class ServeReplicaPoll(Message):
    """Replica -> gateway heartbeat + work pull.  ``active`` lists every
    req_id the replica currently owns (pending + in-flight) so the
    gateway can reconcile lost grants; ``stats`` carries slot occupancy
    / queue depth / TTFT / tokens-per-second / speculative acceptance
    for the fleet gauges and the autoscaler."""

    replica_id: str = ""
    free_slots: int = 0
    active: List[str] = dataclasses.field(default_factory=list)
    stats: dict = dataclasses.field(default_factory=dict)
    #: Prefix-template fingerprints this replica holds warm:
    #: replaces the gateway's residency entry wholesale every poll, so
    #: the routing map self-corrects (LRU evictions, restarts).
    warm_prefixes: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeGrants(Message):
    """Gateway -> replica poll reply: new work, cancellations (deadline
    expiries — the replica drops them from its pending queue, or sheds
    the slot mid-decode via ``DecodeServer.abort``), the drain flag
    (stop admitting, finish in-flight, deregister), and ``known``
    (False = the gateway restarted and lost this replica — re-register)."""

    requests: List[ServeSubmit] = dataclasses.field(default_factory=list)
    cancel: List[str] = dataclasses.field(default_factory=list)
    drain: bool = False
    known: bool = True
    #: Current draft-proposal endpoint: the address of a
    #: live draft-role replica's proposal server, refreshed every poll
    #: so spec targets attach/detach their remote draft as draft
    #: replicas come and go ("" = no draft alive).
    draft_addr: str = ""


@dataclasses.dataclass
class ServeTokens(Message):
    """Replica -> gateway: streamed tokens for one in-flight request
    (batched per poll round — the burst size is the dispatch batching
    the decode paths buy throughput with)."""

    replica_id: str = ""
    req_id: str = ""
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeDone(Message):
    """Replica -> gateway: terminal completion report.  Idempotent: the
    gateway dedupes by req_id, so a journal replay after a replica kill
    (``replayed=True``) or a re-dispatch race can never complete a
    request twice."""

    replica_id: str = ""
    req_id: str = ""
    tokens: List[int] = dataclasses.field(default_factory=list)
    ok: bool = True
    reason: str = ""
    replayed: bool = False
    #: Per-request speculation telemetry: the accepted-
    #: tokens-per-round this request earned and the speculative rounds
    #: it rode.  Journaled with the completion, so a replay reports
    #: the SAME numbers the request earned live (0 = never speculated).
    tokens_per_round: float = 0.0
    spec_rounds: int = 0
    #: Trace context of a JOURNAL-REPLAYED completion: the
    #: replica ships the trace id the request earned when served live,
    #: so a replay landing at a fresh gateway (failover adoption) joins
    #: the ORIGINAL trace instead of orphaning a new one.  Empty on
    #: live completions (the gateway already holds the context) and
    #: omitted from the wire (byte compat).
    trace: dict = dataclasses.field(default_factory=dict)

    _WIRE_OPTIONAL = frozenset({"trace"})


@dataclasses.dataclass
class ServeKvReady(Message):
    """Prefill replica -> gateway: the prefill-grant's KV segment is
    ready (stage two of the disaggregated path).  ``payload``
    is ``llama_infer.pack_kv_segment`` bytes (CRC embedded);
    ``fp32_bytes`` is the segment's un-quantized size so the int8
    transfer saving is measurable at the gateway without unpacking.

    Peer-to-peer mode: ``payload`` stays EMPTY and the
    message carries only a ticket — ``addr`` of the prefill replica's
    segment server plus the segment's ``seg_fp``/``crc32``/``nbytes``
    — which the gateway holds and attaches to the decode grant; the
    decode replica pulls the bytes directly from the peer."""

    replica_id: str = ""
    req_id: str = ""
    payload: bytes = b""
    fp32_bytes: int = 0
    addr: str = ""  # non-empty = ticket mode (P2P)
    seg_fp: str = ""
    crc32: int = 0
    nbytes: int = 0
    #: Trace context, wire-optional (byte compat).
    trace: dict = dataclasses.field(default_factory=dict)

    _WIRE_OPTIONAL = frozenset({"trace"})


@dataclasses.dataclass
class KvSegmentFetch(Message):
    """Decode replica -> prefill replica's segment server:
    pull the published KV segment for ``req_id``.  ``seg_fp`` pins the
    exact segment the ticket promised — a re-prefilled request must
    never decode from a stale publication under the same req_id."""

    req_id: str = ""
    seg_fp: str = ""


@dataclasses.dataclass
class KvSegmentData(Message):
    found: bool = False
    reason: str = ""
    payload: bytes = b""
    crc32: int = 0


@dataclasses.dataclass
class DraftRoll(Message):
    """Spec target replica -> draft replica's proposal server: one
    speculative round's proposal fetch for every stream the
    target is speculating.  Each entry of ``streams`` is a dict —
    ``{"rid": str, "ctx": [ints emitted since the last roll], "open":
    [prompt tokens]}`` (``open`` only on the first roll of a stream, or
    after the draft evicted it) — the draft catches its per-stream
    cache up from exactly that delta, rolls ``k`` proposals, and ships
    them back CRC-wrapped (the KV-segment envelope idiom).  ``close``
    piggybacks finished/aborted stream ids for cache hygiene."""

    replica_id: str = ""
    k: int = 4
    sample: bool = False
    streams: List[dict] = dataclasses.field(default_factory=list)
    close: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DraftProposals(Message):
    """Proposal-server reply: ``payload`` is the CRC-wrapped msgpack
    proposal bundle (``serving.draft.pack_proposals``); ``found=False``
    carries the failure reason — the target degrades to plain decode,
    it never waits."""

    found: bool = False
    reason: str = ""
    payload: bytes = b""


@dataclasses.dataclass
class ServeKvReject(Message):
    """Decode replica -> gateway: the decode-grant's KV segment failed
    verification (torn in flight).  The
    gateway drops the payload and re-queues the request for a fresh
    prefill (bounded by ``max_attempts``); a torn segment is NEVER
    decoded from."""

    replica_id: str = ""
    req_id: str = ""
    reason: str = ""


@dataclasses.dataclass
class ServeDrainRequest(Message):
    """Operator/autoscaler -> gateway: drain one replica (scale-down)."""

    replica_id: str = ""


@dataclasses.dataclass
class ServeFleetStatsRequest(Message):
    pass


@dataclasses.dataclass
class ServeFleetStats(Message):
    stats: dict = dataclasses.field(default_factory=dict)
