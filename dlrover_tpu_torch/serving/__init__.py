"""The serving fleet of the port: the port's own copy of
``dlrover_tpu/serving/``, exporting the reference's names.

- :mod:`dlrover_tpu_torch.serving.gateway`: the typed-RPC front door
  (bounded admission with backpressure, prefix- and spec-aware
  least-loaded routing, the two-stage prefill/decode grants, deadlines,
  request-id dedupe, leases, requeue, drain, the ``serve_*`` gauges);
- :mod:`dlrover_tpu_torch.serving.replica`: the worker loop that feeds
  grants into a continuous-batching ``DecodeServer``, streams tokens,
  journals completions and replays them after a restart;
- :mod:`dlrover_tpu_torch.serving.autoscale`: the queue-depth and
  p95-TTFT replica-count policy with drain-aware scale-down;
- :mod:`dlrover_tpu_torch.serving.kvseg`: the peer-to-peer KV-segment
  plane (segment store and server, ticketed pulls);
- :mod:`dlrover_tpu_torch.serving.draft`: draft replicas, speculative
  proposals as a fleet service;
- :mod:`dlrover_tpu_torch.serving.tier`: the sharded gateway tier (a
  leased registry, consistent-hash ownership, fan-out replica links,
  failover resubmission, merged snapshots and tier-wide actuation);
- :mod:`dlrover_tpu_torch.serving.spillover`: cross-cell spillover (the
  spill policy and router, the global client, the global roll-up).

No module here imports torch at module level: the gateway, the tier and
the autoscaler are pure control plane, and only the replica's server and
the draft worker touch the model.
"""

from dlrover_tpu_torch.serving.autoscale import (  # noqa: F401
    PoolAutoScaler,
    ScalePolicy,
    ScaleState,
    ServeAutoScaler,
    decide,
    decide_pools,
)
from dlrover_tpu_torch.serving.draft import (  # noqa: F401
    DraftReplicaRunner,
    DraftServer,
    DraftUnavailable,
    DraftWorker,
    RemoteDraftClient,
    connect_remote_draft,
)
from dlrover_tpu_torch.serving.gateway import (  # noqa: F401
    Gateway,
    GatewayConfig,
    GatewayCore,
    LoopbackTransport,
    ServeClient,
)
from dlrover_tpu_torch.serving.kvseg import (  # noqa: F401
    KvPullError,
    KvSegmentServer,
    KvSegmentStore,
    pull_kv_segment,
)
from dlrover_tpu_torch.serving.replica import (  # noqa: F401
    ReplicaRunner,
    prefix_fingerprint,
)

from dlrover_tpu_torch.serving.spillover import (  # noqa: F401
    CellSpillRouter,
    GlobalClient,
    SpillDecision,
    SpilloverConfig,
    SpilloverPolicy,
    merge_global_snapshots,
)
from dlrover_tpu_torch.serving.tier import (  # noqa: F401
    GatewayTierNode,
    HashRing,
    LocalKv,
    MasterKv,
    RegistryServer,
    RpcKv,
    ServeRegistry,
    TierActuator,
    TierClient,
    TierReplicaLink,
    TierStats,
    merge_snapshots,
    pick_drain_victim_merged,
)
