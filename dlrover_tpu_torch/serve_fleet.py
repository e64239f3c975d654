"""The one-host serving fleet: drain-aware replicas behind one gateway or a
sharded gateway tier.

The port's counterpart of ``examples/llama_serve_fleet.py``, with the same
roles, flags and output lines.  One process (gateway,
replica threads sharing one copy of the weights, loopback driver)::

    python -m dlrover_tpu_torch.serve_fleet --replicas 2 --requests 12 \
        --device cpu

Process per role::

    python -m dlrover_tpu_torch.serve_fleet --role gateway --port 8710
    python -m dlrover_tpu_torch.serve_fleet --role replica \
        --gateway 127.0.0.1:8710 --replica_id r0 --journal_dir /tmp/j --spec
    python -m dlrover_tpu_torch.serve_fleet --role draft \
        --gateway 127.0.0.1:8710 --replica_id d0 --draft_seed -1
    python -m dlrover_tpu_torch.serve_fleet --role driver \
        --gateway 127.0.0.1:8710 --requests 12 --rps 20

``--config`` picks the model of ``serve.CONFIGS``: ``tiny`` (the default)
takes the reference's ``--n_layer``/``--d_model``/``--d_ff`` and runs in
fp32, so that greedy decode is the same whichever replica serves a request
and however the slots are batched; the others run in their own dtype
(bf16).  Weights are random, drawn from ``--seed``; every replica builds
the same ones.  The draft role's ``--draft_seed -1`` is the ceiling draft
(the target's own weights); otherwise the draft has the target's width at
``--draft_layers`` blocks from ``--draft_seed``.  The model roles run on
the card unless ``--device cpu`` is given; the gateway and the driver
touch no device and import no torch in the gateway.

Sharded tier (``examples/llama_serve_fleet.py:349-372``, ``:487-515``):
point every role at a shared registry (a ``serving.RegistryServer``, or a
master's KV store) instead of one gateway::

    python -m dlrover_tpu_torch.serve_fleet --role gateway \
        --registry 127.0.0.1:8700 --gateway_id g0 --metrics_port 0
    python -m dlrover_tpu_torch.serve_fleet --role replica \
        --registry 127.0.0.1:8700 --replica_id r0 --journal_dir /tmp/j
    python -m dlrover_tpu_torch.serve_fleet --role driver \
        --registry 127.0.0.1:8700 --requests 12 --rps 20

A tier gateway is a ``GatewayTierNode`` (leased in the registry under
``--job``, ``--lease_timeout`` its lease), a replica polls every live
gateway through a ``TierReplicaLink``, and the driver submits through a
``TierClient`` and prints ``DRIVER_RESUBMITTED n`` (failover resubmits).
``--metrics_port >= 0`` serves a tier gateway's Prometheus gauges
(``serve_*`` and ``tier_*``) on ``/metrics``.  A
replica's ``REPLICA_DONE`` line carries its RMSNorm kernel launches (the
wrapper's count plus the decode graph's recorded launches times its
replays) beside its eager forwards, ``graph_recorded`` and
``graph_replays``, and the longest gap between two of its gateway polls
(``max_poll_gap_s``, ending at the wall-clock ``max_poll_gap_at``).
``DLROVER_TPU_FAULTS`` raises ``NotImplementedError`` naming the chaos
layer's Queue A item.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

#: ``serve.CONFIGS``'s names (read here without importing torch).
CONFIG_NAMES = ("llama2_7b", "medium_800m", "small_300m", "tiny")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--role", default="all",
                   choices=("all", "gateway", "replica", "driver",
                            "draft"))
    p.add_argument("--port", type=int, default=0,
                   help="(gateway) listen port; 0 = ephemeral")
    p.add_argument("--gateway", default="",
                   help="(replica/driver/draft) gateway host:port")
    p.add_argument("--registry", default="",
                   help="shared registry host:port (a RegistryServer or "
                        "a master): the sharded gateway tier")
    p.add_argument("--job", default="fleet",
                   help="(tier) registry namespace")
    p.add_argument("--gateway_id", default="g0",
                   help="(tier gateway) this gateway's id on the ring")
    p.add_argument("--metrics_port", type=int, default=-1,
                   help="(tier gateway) /metrics port (-1 = off, 0 = "
                        "ephemeral)")
    p.add_argument("--kv_relay", action="store_true",
                   help="(gateway) force the prefill->decode KV segment "
                        "through the gateway instead of peer-to-peer "
                        "tickets")
    p.add_argument("--no_kv_p2p", action="store_true",
                   help="(replica) never publish KV segments "
                        "peer-to-peer (always relay the payload)")
    p.add_argument("--replica_id", default="r0")
    p.add_argument("--replica_role", default="unified",
                   choices=("unified", "prefill", "decode"),
                   help="(replica) prefill scores prompts and exports KV "
                        "segments; decode continues from imported ones")
    p.add_argument("--quant_kv", action="store_true",
                   help="(replica) int8 KV cache")
    p.add_argument("--paged", action="store_true",
                   help="(replica) paged KV: block pool and per-request "
                        "block tables")
    p.add_argument("--block_size", type=int, default=16,
                   help="(replica) tokens per KV block under --paged")
    p.add_argument("--pool_blocks", type=int, default=0,
                   help="(replica) KV pool size in blocks under --paged "
                        "(0 = slots * max_len / block_size)")
    p.add_argument("--prefix_cache_cap", type=int, default=4,
                   help="(replica) warm prefix templates retained")
    p.add_argument("--warm_prefix_len", type=int, default=0,
                   help="(replica) run the prefix-template path once for "
                        "this prefix length before registering")
    p.add_argument("--spec", action="store_true",
                   help="(replica) speculative serving: advertise spec "
                        "capability, attach the gateway-announced remote "
                        "draft, per-request adaptive k")
    p.add_argument("--draft_k", type=int, default=4,
                   help="(replica/draft) speculation width ceiling")
    p.add_argument("--spec_break_even", type=float, default=0.0,
                   help="(replica) accepted tokens a round below which a "
                        "stream rides plain (0 = 1 + 0.6 * draft_k)")
    p.add_argument("--spec_min_tokens", type=int, default=0,
                   help="(gateway) max_new_tokens at which the grant scan "
                        "prefers spec-capable replicas (0 = off)")
    p.add_argument("--draft_layers", type=int, default=1,
                   help="(draft) draft model depth")
    p.add_argument("--draft_seed", type=int, default=-1,
                   help="(draft) draft init seed; -1 = the target's seed "
                        "and shape (the ceiling draft)")
    p.add_argument("--draft_streams", type=int, default=32,
                   help="(draft) concurrent stream caches retained")
    p.add_argument("--draft_floor_ms", type=float, default=0.0,
                   help="(draft) per-roll latency floor")
    p.add_argument("--replicas", type=int, default=2,
                   help="(all) replica threads to run")
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max_len", type=int, default=96)
    p.add_argument("--config", default="tiny", choices=CONFIG_NAMES,
                   help="the model (serve.CONFIGS); tiny takes --n_layer, "
                        "--d_model and --d_ff")
    p.add_argument("--n_layer", type=int, default=2)
    p.add_argument("--d_model", type=int, default=64)
    p.add_argument("--d_ff", type=int, default=128)
    p.add_argument("--device", default="cuda",
                   help="(replica/draft/all) cuda (default) or cpu")
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--max_new_tokens", type=int, default=16)
    p.add_argument("--rps", type=float, default=50.0,
                   help="(driver) Poisson arrival rate")
    p.add_argument("--deadline_s", type=float, default=0.0)
    p.add_argument("--journal_dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--poll_interval", type=float, default=0.02)
    p.add_argument("--round_floor_ms", type=float, default=0.0,
                   help="(replica) per-round latency floor")
    p.add_argument("--queue_cap", type=int, default=256)
    p.add_argument("--lease_timeout", type=float, default=10.0,
                   help="(gateway) seconds without a poll before a "
                        "replica is presumed dead and its work "
                        "re-dispatched")
    p.add_argument("--timeout", type=float, default=120.0)
    return p.parse_args(argv)


def model_config(args, n_layer=None):
    """The ``LlamaConfig`` of ``--config`` (``n_layer`` overrides the
    depth)."""
    import dataclasses

    import torch

    from dlrover_tpu_torch.serve import CONFIGS

    if args.config == "tiny":
        cfg = CONFIGS["tiny"](n_layer=args.n_layer, d_model=args.d_model,
                              d_ff=args.d_ff, dtype=torch.float32)
    else:
        cfg = CONFIGS[args.config]()
    if n_layer is not None:
        cfg = dataclasses.replace(cfg, n_layer=n_layer)
    return cfg


def build_model(args, seed: int, n_layer=None):
    """``(params, cfg)``: seeded random weights on ``--device``."""
    import torch

    from dlrover_tpu_torch.common.device import resolve_device
    from dlrover_tpu_torch.models.llama import init_params

    dev = resolve_device(args.device)
    cfg = model_config(args, n_layer)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return init_params(cfg, gen, dev), cfg


def build_replica(args, transport, draft_connect=None, model=None):
    """One seeded replica: DecodeServer + ReplicaRunner (all replicas
    identical by construction).  ``model`` shares ``(params, cfg)``
    between replica threads; ``draft_connect`` overrides the remote-draft
    handle factory.  The server serves a short warm-up before it
    registers (on the card that captures its decode graph, in the calling
    thread)."""
    import numpy as np

    from dlrover_tpu_torch.models import llama_infer
    from dlrover_tpu_torch.serving import ReplicaRunner

    params, cfg = model or build_model(args, args.seed)
    role = getattr(args, "replica_role", "unified")
    spec = bool(getattr(args, "spec", False))
    srv = llama_infer.DecodeServer(
        params, cfg, slots=args.slots, max_len=args.max_len,
        prompt_buckets=(16, 32), seed=args.seed,
        quant_kv=getattr(args, "quant_kv", False),
        prefix_cache_cap=getattr(args, "prefix_cache_cap", 4),
        spec_remote=spec,
        draft_k=getattr(args, "draft_k", 4),
        adapt_k_per_request=spec,
        spec_break_even=getattr(args, "spec_break_even", 0.0),
        paged=getattr(args, "paged", False),
        block_size=getattr(args, "block_size", 16),
        pool_blocks=(getattr(args, "pool_blocks", 0) or None),
    )
    warm_p0 = getattr(args, "warm_prefix_len", 0)
    dummy = np.arange(1, 5, dtype=np.int32)
    warm_forwards = 0
    if role != "prefill":
        srv.serve([dummy], max_new_tokens=2)
        warm_forwards += eager_forwards(srv)
    if role in ("prefill", "decode"):
        srv.prefill_request("__warm", dummy, 2)
        payload, _ = srv.export_kv("__warm")
        if role == "decode":
            srv.import_kv("__warm", payload, dummy, 2)
            srv.serve_incremental(tick=lambda: bool(
                srv.pending_count() or srv.active_rids()
            ))
    if warm_p0 > 0 and role != "decode":
        # The template path engages only when the combined prompt
        # exceeds the largest bucket.
        n_warm = max(warm_p0, srv.buckets[-1]) + 9
        wp = np.arange(1, n_warm + 1, dtype=np.int32)
        if role == "prefill":
            srv.prefill_request("__warmp", wp, 2, prefix_len=warm_p0)
            srv.export_kv("__warmp")
        else:
            srv.submit("__warmp", wp, 2, prefix_len=warm_p0)
            srv.serve_incremental(tick=lambda: bool(
                srv.pending_count() or srv.active_rids()
            ))
        srv.clear_prefix_templates()
    journal = None
    if args.journal_dir:
        os.makedirs(args.journal_dir, exist_ok=True)
        journal = os.path.join(args.journal_dir, f"{args.replica_id}.jsonl")
    runner = ReplicaRunner(
        srv, transport, args.replica_id, journal_path=journal,
        poll_interval=args.poll_interval,
        round_floor_s=args.round_floor_ms / 1000.0,
        role=role,
        kv_p2p=not getattr(args, "no_kv_p2p", False),
        draft_connect=draft_connect,
    )
    #: Eager forwards of the unified warm-up serve (``replica_done``).
    runner.warmup_forwards = warm_forwards
    return runner


class PollGaps:
    """A replica transport that times the gaps between the starts of
    consecutive ``ServeReplicaPoll`` calls (the runner polls once a
    decode round; a call stalled on a dead gateway shows as a long gap)
    and passes every call on."""

    def __init__(self, inner):
        self.inner = inner
        self.max_gap_s = 0.0
        self.max_gap_at = 0.0  # wall-clock end of the longest gap
        self._last = None

    def call(self, msg, **kw):
        from dlrover_tpu_torch.common.messages import ServeReplicaPoll

        if isinstance(msg, ServeReplicaPoll):
            now = time.monotonic()
            if self._last is not None and now - self._last > self.max_gap_s:
                self.max_gap_s = now - self._last
                self.max_gap_at = time.time()
            self._last = now
        return self.inner.call(msg, **kw)


def eager_forwards(srv) -> int:
    """The forwards that one serve run of ``srv`` (its ``last_stats``)
    made eagerly: prefills, template prefills and the decode graph's
    warm-up; every other decode dispatch of K steps was one replay."""
    st = srv.last_stats
    return (st["forwards"] - srv.decode_chunk * st["graph_replays"]
            + st["graph_warmup_forwards"] + st["template_forwards"])


def replica_done(runner) -> str:
    """The ``REPLICA_DONE`` line of a replica that has run: its RMSNorm
    kernel launches (the wrapper's count of this process plus the decode
    graph's recorded launches times its replays) beside the eager
    forwards of its warm-up and its run, so that a caller can hold the
    launches against (2L+1) a forward."""
    from dlrover_tpu_torch.ops import rmsnorm as rms

    graph = runner.server.decode_graph
    recorded = graph.recorded.get("rmsnorm", 0)
    eager = getattr(runner, "warmup_forwards", 0)
    if runner.server.last_stats:
        eager += eager_forwards(runner.server)
    gaps = runner.transport
    gap = (f" max_poll_gap_s={gaps.max_gap_s:.3f} max_poll_gap_at="
           f"{gaps.max_gap_at:.3f}" if isinstance(gaps, PollGaps) else "")
    return (
        f"REPLICA_DONE id={runner.replica_id} served={runner.served} "
        f"replayed={runner.replayed} "
        f"rmsnorm_launches={rms.rmsnorm.launches + recorded * graph.replays}"
        f" eager_forwards={eager} graph_recorded={recorded} "
        f"graph_replays={graph.replays}{gap}"
    )


def driver_prompts(args):
    """The reference driver's request stream: ``serve_common.
    seeded_requests`` over the tiny model's vocabulary (256), seed + 1."""
    import numpy as np

    rng = np.random.RandomState(args.seed + 1)
    return [
        rng.randint(1, 256, size=(int(n),)).astype(np.int32)
        for n in rng.randint(4, 12, size=(args.requests,))
    ]


def drive(args, transport, core=None, client=None):
    """Submit the seeded request stream at Poisson arrivals, poll every
    result, print the summary line.  ``client`` overrides the
    transport-bound ServeClient (the tier driver passes a TierClient)."""
    import numpy as np

    from dlrover_tpu_torch.serving import ServeClient

    prompts = driver_prompts(args)
    arr_rng = np.random.RandomState(args.seed + 7)
    gaps = arr_rng.exponential(1.0 / max(args.rps, 1e-6),
                               size=args.requests)
    if client is None:
        client = ServeClient(transport)
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts):
        time.sleep(float(gaps[i]))
        ack = client.submit(
            f"req-{i}", prompt, args.max_new_tokens,
            deadline_s=args.deadline_s,
        )
        print(f"SUBMIT req-{i} status={ack.status}", flush=True)
    done = 0
    total_new = 0
    for i in range(args.requests):
        reply = client.result(f"req-{i}", timeout=args.timeout)
        n = len(reply.tokens)
        print(
            f"RESULT req-{i} state={reply.state} new_tokens={n} "
            f"replica={reply.replica}", flush=True,
        )
        if reply.state == "done":
            done += 1
            total_new += n
    dt = time.perf_counter() - t0
    extra = ""
    if core is not None:
        c = core.stats_snapshot()["counters"]
        extra = (f" redispatched={c['redispatched']} "
                 f"duplicates={c['duplicate_completions']}")
    print(
        f"FLEET_DONE requests={args.requests} completed={done} "
        f"new_tokens={total_new} tokens_per_sec={total_new / dt:.1f}"
        f"{extra}", flush=True,
    )
    return 0 if done == args.requests else 1


class _T:
    """RpcClient with the runner's best-effort budget."""

    def __init__(self, addr):
        from dlrover_tpu_torch.common.rpc import RpcClient

        self._c = RpcClient(addr, timeout=5.0)

    def call(self, msg, **kw):
        return self._c.call(msg, deadline=10.0, idempotent=True, **kw)


def tier_registry(args):
    """This process's own handle on the shared registry (the reader-side
    lease is per handle)."""
    from dlrover_tpu_torch.serving import RpcKv, ServeRegistry

    return ServeRegistry(RpcKv(args.registry), job=args.job,
                         lease_s=args.lease_timeout)


def run_gateway(args) -> int:
    from dlrover_tpu_torch.serving import (
        Gateway,
        GatewayConfig,
        GatewayTierNode,
    )

    cfg = GatewayConfig(
        queue_cap=args.queue_cap,
        lease_timeout_s=args.lease_timeout,
        kv_p2p=not args.kv_relay,
        spec_decode_min_tokens=args.spec_min_tokens,
    )
    if args.registry:
        node = GatewayTierNode(
            args.gateway_id, tier_registry(args), port=args.port,
            config=cfg, metrics_port=(
                args.metrics_port if args.metrics_port >= 0 else None))
        node.start()
        gw = node.gateway
        ready = f"GATEWAY_READY port={gw.port} id={args.gateway_id}"
        if node.metrics_port is not None:
            ready += f" metrics={node.metrics_port}"
    else:
        node = None
        gw = Gateway(port=args.port, config=cfg)
        gw.start()
        ready = f"GATEWAY_READY port={gw.port}"
    print(ready, flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.wait(2.0):
        snap = gw.core.stats_snapshot()
        print(
            "FLEET_STATS " + json.dumps({
                "queue": snap["queue_depth"],
                "alive": snap["replicas_alive"],
                "occupancy": round(snap["occupancy"], 3),
                "completed": snap["counters"]["completed"],
                "ttft_p95_ms": gw.ttft_ms.percentile(0.95),
            }), flush=True,
        )
    snap = gw.core.stats_snapshot()
    print("GATEWAY_DONE " + json.dumps({
        "counters": snap["counters"],
        "ttft_p50_ms": gw.ttft_ms.percentile(0.5),
        "latency_p50_ms": gw.latency_ms.percentile(0.5),
        "torch_imported": "torch" in sys.modules,
    }), flush=True)
    if node is not None:
        node.stop()
    else:
        gw.stop()
    return 0


def run_draft(args) -> int:
    """A draft replica: a proposal server registered as the ``draft``
    role; spec targets learn its address from the gateway's poll replies
    and pull per-round proposals directly."""
    from dlrover_tpu_torch.serving import (
        DraftReplicaRunner,
        DraftServer,
        DraftWorker,
    )

    if args.draft_seed < 0:
        dparams, dcfg = build_model(args, args.seed)
    else:
        dparams, dcfg = build_model(args, args.draft_seed,
                                    n_layer=args.draft_layers)
    worker = DraftWorker(
        dparams, dcfg, max_len=args.max_len,
        draft_k=args.draft_k, max_streams=args.draft_streams,
        seed=args.seed, worker_id=args.replica_id,
        round_floor_s=args.draft_floor_ms / 1000.0,
    )
    worker.warm()
    server = DraftServer(worker)
    runner = DraftReplicaRunner(
        server, _T(args.gateway), args.replica_id,
        poll_interval=max(args.poll_interval, 0.05),
    )
    signal.signal(signal.SIGTERM, lambda *_: runner.stop())
    print(f"DRAFT_READY id={args.replica_id} addr={server.addr}",
          flush=True)
    runner.run()
    print(
        f"DRAFT_DONE id={args.replica_id} rolls={worker.rolls} "
        f"proposed={worker.proposed_tokens}", flush=True,
    )
    return 0


def run_all(args) -> int:
    """One-process fleet: loopback gateway, replica threads sharing one
    copy of the weights, inline driver."""
    from dlrover_tpu_torch.serving import (
        Gateway,
        GatewayConfig,
        LoopbackTransport,
    )

    gw = Gateway(port=0, config=GatewayConfig(queue_cap=args.queue_cap))
    gw.start()
    transport = LoopbackTransport(gw.handle)
    model = build_model(args, args.seed)
    threads = []
    runners = []
    for i in range(args.replicas):
        rargs = argparse.Namespace(**vars(args))
        rargs.replica_id = f"r{i}"
        runner = build_replica(rargs, transport, model=model)
        runners.append(runner)
        th = threading.Thread(target=runner.run, daemon=True,
                              name=f"replica-{i}")
        th.start()
        threads.append(th)
    try:
        rc = drive(args, transport, core=gw.core)
    finally:
        for runner in runners:
            gw.core.drain(runner.replica_id)
        for th in threads:
            th.join(timeout=30)
        gw.stop()
    return rc


def main(argv=None) -> int:
    args = parse_args(argv)
    if os.environ.get("DLROVER_TPU_FAULTS"):
        from dlrover_tpu_torch.common.constants import CHAOS_LAYER

        raise NotImplementedError(
            f"fault injection (DLROVER_TPU_FAULTS) comes with {CHAOS_LAYER}")
    if args.registry and args.role in ("draft", "all"):
        raise ValueError(
            f"--registry takes the gateway, replica and driver roles; "
            f"--role {args.role} serves one gateway (as the reference's)")
    if args.metrics_port >= 0 and not args.registry:
        raise ValueError("--metrics_port serves a tier gateway's gauges: "
                         "it needs --registry (as the reference's)")
    from dlrover_tpu_torch.common import log

    log.set_role({"gateway": (f"gw-{args.gateway_id}" if args.registry
                              else "gateway"),
                  "replica": f"rep-{args.replica_id}",
                  "draft": f"draft-{args.replica_id}",
                  "driver": "driver"}.get(args.role, "fleet"))
    if args.role == "gateway":
        return run_gateway(args)
    if args.role == "draft":
        return run_draft(args)
    if args.role == "replica":
        if args.registry:
            from dlrover_tpu_torch.serving import TierReplicaLink

            transport = TierReplicaLink(tier_registry(args),
                                        args.replica_id)
        else:
            transport = _T(args.gateway)
        runner = build_replica(args, PollGaps(transport))
        print(f"REPLICA_READY id={args.replica_id}", flush=True)
        runner.run()
        print(replica_done(runner), flush=True)
        return 0
    if args.role == "driver":
        if args.registry:
            from dlrover_tpu_torch.serving import TierClient

            client = TierClient(tier_registry(args))
            rc = drive(args, None, client=client)
            print(f"DRIVER_RESUBMITTED {client.resubmitted}", flush=True)
            return rc
        from dlrover_tpu_torch.common.rpc import RpcClient

        return drive(args, RpcClient(args.gateway, timeout=10.0))
    return run_all(args)


if __name__ == "__main__":
    sys.exit(main())
