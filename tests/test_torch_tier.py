"""The port's sharded serving tier (``dlrover_tpu_torch/serving/tier.py``,
``common/hashring.py``, ``master/job_auto_scaler.py`` and the /metrics half
of ``agent/metrics.py``) against the JAX package's, with exact equality:

- ``ring_hash`` and ``HashRing.owner`` over 1,000 ids as members come and
  go;
- the registry's KV bytes and its ``gateways()``/``replicas()`` after one
  announce/heartbeat/remove/``gc_stale`` script under stepped clocks (also
  through ``MasterKv`` over a port ``LocalJobMaster``, and a
  ``GatewayTierNode``'s heartbeat pass), and ``RegistryServer.handle``'s
  replies and each ``RpcKv`` over the wire;
- ``merge_snapshots``, ``TierStats`` and ``pick_drain_victim_merged`` on
  hypothesis-drawn snapshots with histogram states;
- ``TierReplicaLink`` against scripted gateways (the reference's cases),
  ``TierClient`` failover over two in-process ``Gateway``s with a journaled
  replica, and ``TierActuator`` with ``ServingFleetAutoScaler``'s targets
  and drains under the reference tests' fake job manager;
- the rendered ``/metrics`` text of ``Gateway.register_gauges``.

Every clock is a stepped object passed in (or set as the module object's
attribute); no test sleeps to let a lease lapse.
"""

import copy
import json
import threading
import time
import types
import urllib.request

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.agent import metrics as jmet
from dlrover_tpu.common import hashring as jhr
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.master import job_auto_scaler as jjas
from dlrover_tpu.serving import autoscale as jauto
from dlrover_tpu.serving import gateway as jgw
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu.serving import tier as jtier
from dlrover_tpu_torch.agent import metrics as tmet
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import hashring as thr
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.master import job_auto_scaler as tjas
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.serving import autoscale as tauto
from dlrover_tpu_torch.serving import gateway as tgw
from dlrover_tpu_torch.serving import replica as trep
from dlrover_tpu_torch.serving import tier as ttier

from test_serving import FakeDecodeServer, expected_tokens  # noqa: I100

REF = types.SimpleNamespace(name="ref", tier=jtier, gw=jgw, msg=jmsg,
                            rep=jrep, hr=jhr, jas=jjas, met=jmet,
                            auto=jauto)
PORT = types.SimpleNamespace(name="port", tier=ttier, gw=tgw, msg=tmsg,
                             rep=trep, hr=thr, jas=tjas, met=tmet,
                             auto=tauto)
BOTH = (REF, PORT)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def wait_for(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


# -- the ring ----------------------------------------------------------------

IDS = [f"req-{i}" for i in range(1000)]
MEMBER_SETS = [("g0",), ("g0", "g1"), ("g0", "g1", "g2"),
               ("g0", "g1", "g2", "g3"), ("g0", "g2", "g3"), ("g2", "g3"),
               ("cellA", "cellB"), ()]


def test_ring_hash_equal():
    assert [thr.ring_hash(i) for i in IDS] == \
        [jhr.ring_hash(i) for i in IDS]
    # sha1's first 4 bytes, big-endian: a fixed value, not hash().
    assert thr.ring_hash("req-0") == jhr.ring_hash("req-0")
    assert ttier.ring_hash is thr.ring_hash and ttier.HashRing is thr.HashRing


@pytest.mark.parametrize("members", MEMBER_SETS,
                         ids=lambda m: "+".join(m) or "empty")
def test_ring_owner_equal_as_members_change(members):
    t, j = thr.HashRing(members), jhr.HashRing(members)
    assert t.gateway_ids == j.gateway_ids == t.member_ids
    assert [t.owner(i) for i in IDS] == [j.owner(i) for i in IDS]
    assert thr.HashRing(members, vnodes=8)._points == \
        jhr.HashRing(members, vnodes=8)._points


def test_ring_death_moves_only_the_dead_range():
    full, less = thr.HashRing(("g0", "g1", "g2")), thr.HashRing(("g0", "g2"))
    for i in IDS:
        if full.owner(i) != "g1":
            assert less.owner(i) == full.owner(i)


# -- the registry ------------------------------------------------------------

def _kv_dump(kv) -> dict:
    return dict(sorted(kv.scan("").items()))


def registry_script(pkg, kv, dump=_kv_dump) -> list:
    """One announce / heartbeat / remove / gc_stale script with a writer
    and a reader handle on stepped clocks (the writer's skewed by 100 s:
    the lease is judged on the reader's clock)."""
    T = pkg.tier
    wclock, rclock = Clock(1100.0), Clock(1000.0)
    writer = T.ServeRegistry(kv, job="jobA", lease_s=5.0, clock=wclock)
    reader = T.ServeRegistry(kv, job="jobA", lease_s=5.0, clock=rclock)
    other = T.ServeRegistry(kv, job="jobB", lease_s=5.0, clock=rclock)
    out = []

    def rec(tag):
        out.append((tag, dump(kv), reader.gateways(), reader.replicas(),
                    other.gateways()))

    writer.announce_gateway("g0", "h:1")
    writer.announce_gateway("g1", "h:2")
    writer.announce_replica("r0", slots=4, role="prefill", kv_addr="h:9")
    writer.announce_replica("r1", 2)
    other.announce_gateway("g9", "h:99")
    rec("announced")
    writer.announce_replica("r1", 8, role="decode")  # re-register in place
    for _ in range(3):
        rclock.advance(4.0)
        wclock.advance(4.0)
        writer.announce_gateway("g0", "h:1")  # only g0 heartbeats
        writer.announce_replica("r0", 4, "prefill", "h:9")
        rec("heartbeat")
        out.append(("gc", reader.gc_stale()))
    kv.set("serve/jobA/gw/bad", b"\xff{not json")
    rec("undecodable")
    out.append(("gc", sorted(reader.gc_stale())))
    writer.remove_gateway("g0")
    writer.remove_replica("r0")
    rec("removed")
    rclock.advance(5.1)
    rec("lapsed")
    out.append(("gc", sorted(reader.gc_stale()), sorted(other.gc_stale())))
    rec("end")
    out.append(("keys", writer.gw_key("g0"), writer.rep_key("r0")))
    return out


def test_registry_bytes_and_views_equal():
    got = registry_script(PORT, ttier.LocalKv())
    want = registry_script(REF, jtier.LocalKv())
    assert got == want
    # The entries are the reference's json.dumps({"addr", "ts"}) bytes.
    assert got[0][1]["serve/jobA/gw/g0"] == \
        json.dumps({"addr": "h:1", "ts": 1100.0}).encode()


def test_master_kv_over_a_port_master_equals_local_kv():
    mst = LocalJobMaster(0, job_name="tierkv")
    mst.prepare()
    mc = MasterClient(mst.addr, 0)
    try:
        got = registry_script(PORT, ttier.MasterKv(mc),
                              dump=lambda kv: dict(sorted(
                                  kv.scan("serve/").items())))
        want = registry_script(REF, jtier.LocalKv())
        assert got == want
        kv = ttier.MasterKv(mc)
        kv.set("x/k", b"v")
        assert kv.get("x/k") == b"v" and kv.delete("x/k")
        assert kv.get("x/k") is None and not kv.delete("x/k")
    finally:
        mc.close()
        mst.stop()


def _registry_messages(M):
    return [
        M.KVStoreSet(key="serve/j/gw/g0", value=b'{"addr": "h:1"}'),
        M.KVStoreSet(key="serve/j/rep/r0", value=b"\x00\x01"),
        M.KVStoreSet(key="other/k", value=b"v"),
        M.KVStoreGet(key="serve/j/gw/g0"),
        M.KVStoreGet(key="missing"),
        M.KVStoreScan(prefix="serve/j/"),
        M.KVStoreScan(prefix="nothing/"),
        M.KVStoreDelete(key="serve/j/gw/g0", token="tok"),
        M.KVStoreDelete(key="serve/j/gw/g0", token="tok"),  # a retry
        M.KVStoreDelete(key="serve/j/gw/g0", token="tok2"),
        M.KVStoreDelete(key="serve/j/rep/r0", token=""),
        M.KVStoreAdd(key="n", delta=1),  # not a registry message
        M.KVStoreScan(prefix=""),
    ]


def test_registry_server_replies_equal():
    t, j = ttier.RegistryServer(0), jtier.RegistryServer(0)
    try:
        for tm, jm in zip(_registry_messages(tmsg), _registry_messages(jmsg)):
            got, want = t.handle(tm), j.handle(jm)
            assert tmsg.serialize(got) == jmsg.serialize(want), (tm, got)
    finally:
        t.stop()
        j.stop()


def test_rpc_kv_over_the_wire_equal():
    """Each package's RpcKv against its own RegistryServer (the port's
    transport is its own TCP framing, which the reference's gRPC server
    does not speak)."""
    outs = []
    for pkg in BOTH:
        srv = pkg.tier.RegistryServer(0)
        kv = pkg.tier.RpcKv(f"127.0.0.1:{srv.addr.rsplit(':', 1)[1]}")
        try:
            reg = pkg.tier.ServeRegistry(kv, job="wire", lease_s=30.0,
                                         clock=Clock())
            reg.announce_gateway("g0", "h:1")
            reg.announce_replica("r0", slots=2)
            seen = (reg.gateways(), reg.replicas())
            reg.remove_gateway("g0")
            outs.append((seen, reg.gateways(), kv.scan("serve/"),
                         kv.get("serve/wire/rep/r0"), kv.get("nothing"),
                         kv.delete("serve/wire/rep/r0"),
                         kv.delete("serve/wire/rep/r0")))
        finally:
            kv.close()
            srv.stop()
    assert outs[0] == outs[1]
    assert outs[0][0][0] == {"g0": "h:1"} and outs[0][5] is True


class _Once:
    """A ``_stop`` stand-in whose ``wait`` lets one heartbeat pass run."""

    def __init__(self):
        self.n = 0

    def wait(self, _t):
        self.n += 1
        return self.n > 1

    def set(self):
        pass


def tier_node_script(pkg) -> list:
    clock = Clock()
    kv = pkg.tier.LocalKv()
    registry = pkg.tier.ServeRegistry(kv, job="node", lease_s=1.0,
                                      clock=clock)
    kv.set("serve/node/gw/dead", b'{"addr": "h:9", "ts": 1.0}')
    node = pkg.tier.GatewayTierNode(
        "g0", registry, heartbeat_s=3600.0, addr="h:1",
        config=pkg.gw.GatewayConfig(trace_sample=0.0), clock=clock)
    out = []
    node.start()
    try:
        out.append(_kv_dump(kv))
        assert node.core.stats_snapshot()["gateway_id"] == "g0"
        # Heartbeat passes with the node's clock (the registry's and the
        # gateway's) stepped: a sweep runs at most once a lease, and the
        # dead peer is stale on this handle's clock once a lease has gone
        # by without its value changing.
        stop = node._stop
        for dt in (0.5, 0.7, 0.2, 1.5, 0.3, 1.2):
            clock.advance(dt)
            node._stop = _Once()
            node._heartbeat_loop()
            out.append((_kv_dump(kv), registry.gateways(), node._last_gc))
        node._stop = stop
    finally:
        node.stop()
    out.append(_kv_dump(kv))
    return out


def test_tier_node_heartbeat_and_gc_equal():
    got, want = tier_node_script(PORT), tier_node_script(REF)
    assert got == want
    assert "serve/node/gw/dead" in got[2][0]
    assert "serve/node/gw/dead" not in got[-2][0] and got[-1] == {}


# -- merged snapshots --------------------------------------------------------

BOUNDS = list(jmet.Histogram.DEFAULT_BUCKETS_MS)
ROLES = ("unified", "prefill", "decode", "draft")


def _hist_state(counts):
    return {"bounds": list(BOUNDS), "counts": counts,
            "total": sum(counts), "sum": float(7 * sum(counts))}


replica_st = st.fixed_dictionaries({
    "slots": st.integers(0, 8),
    "assigned": st.integers(0, 8),
    "draining": st.booleans(),
    "role": st.sampled_from(ROLES),
    "spec": st.booleans(),
    "stats": st.fixed_dictionaries(
        {"tokens_per_round": st.sampled_from([0.0, 1.5, 3.25, 4.0])}),
})
snap_st = st.fixed_dictionaries({
    "queue_depth": st.integers(0, 20),
    "in_flight": st.integers(0, 20),
    "queue_prefill": st.integers(0, 5),
    "queue_kv_ready": st.integers(0, 5),
    "counters": st.dictionaries(
        st.sampled_from(["submitted", "accepted", "completed",
                         "spill_ingress", "failed"]),
        st.integers(0, 50), max_size=5),
    "pools": st.dictionaries(
        st.sampled_from(ROLES),
        st.fixed_dictionaries({"queue_depth": st.integers(0, 9)}),
        max_size=4),
    "replicas": st.dictionaries(st.sampled_from(["r0", "r1", "r2", "r3"]),
                                replica_st, max_size=4),
    "ttft_p95_ms": st.sampled_from([0.0, 20.0, 500.0]),
    "latency_p95_ms": st.sampled_from([0.0, 50.0]),
    "gateway_id": st.sampled_from(["g0", "g1", "g2"]),
}, optional={
    "ttft_hist": st.lists(st.integers(0, 4), min_size=len(BOUNDS) + 1,
                          max_size=len(BOUNDS) + 1).map(_hist_state),
    "latency_hist": st.lists(st.integers(0, 4), min_size=len(BOUNDS) + 1,
                             max_size=len(BOUNDS) + 1).map(_hist_state),
})


@settings(max_examples=150, deadline=None)
@given(snaps=st.lists(st.one_of(snap_st, st.just({})), max_size=4))
def test_merge_snapshots_equal(snaps):
    got = ttier.merge_snapshots(copy.deepcopy(snaps))
    want = jtier.merge_snapshots(copy.deepcopy(snaps))
    assert got == want
    for role in (None,) + ROLES:
        assert ttier.pick_drain_victim_merged(got, role) == \
            jtier.pick_drain_victim_merged(want, role)

    def dead():
        raise RuntimeError("gateway down")

    fetch = [(lambda s=s: copy.deepcopy(s)) for s in snaps]
    assert ttier.TierStats(fetch + [dead]).snapshot() == \
        jtier.TierStats(fetch + [dead]).snapshot()


def test_merge_snapshots_of_real_cores_equal():
    """Two cores sharing one replica, split queues and grants (the
    reference's ``make_pair``), each package on its own cores."""
    out = []
    for pkg in BOTH:
        G = pkg.gw
        a = G.GatewayCore(G.GatewayConfig(trace_sample=0.0), clock=Clock())
        b = G.GatewayCore(G.GatewayConfig(trace_sample=0.0), clock=Clock())
        for core in (a, b):
            core.register("r0", 4)
        a.register("r1", 4)
        for i in range(3):
            a.submit(f"a{i}", [1], 4)
        b.submit("b0", [1], 4)
        a.poll("r0", 1, [])
        b.poll("r0", 1, [])
        a.drain("r1")
        out.append(pkg.tier.merge_snapshots(
            [a.stats_snapshot(), b.stats_snapshot()]))
    assert out[0] == out[1]
    assert out[0]["queue_depth"] == 2 and out[0]["replicas_alive"] == 1


# -- the replica link against scripted gateways ------------------------------

def full_handle(core, M):
    """The client + replica dispatch of ``Gateway.handle`` over a bare
    core."""
    def handle(msg):
        if isinstance(msg, M.ServeSubmit):
            return core.submit(msg.req_id, msg.prompt, msg.max_new_tokens,
                               msg.deadline_s, msg.prefix_len,
                               msg.prefix_fp)
        if isinstance(msg, M.ServeStatusRequest):
            return core.status(msg.req_id)
        if isinstance(msg, M.ServeFleetStatsRequest):
            return M.ServeFleetStats(stats=core.stats_snapshot())
        if isinstance(msg, M.ServeReplicaRegister):
            core.register(msg.replica_id, msg.slots, msg.role)
        elif isinstance(msg, M.ServeReplicaDeregister):
            core.deregister(msg.replica_id)
        elif isinstance(msg, M.ServeReplicaPoll):
            return core.poll(msg.replica_id, msg.free_slots, msg.active,
                             msg.stats, msg.warm_prefixes)
        elif isinstance(msg, M.ServeTokens):
            core.stream(msg.replica_id, msg.req_id, msg.tokens)
        elif isinstance(msg, M.ServeDone):
            core.complete(msg.replica_id, msg.req_id, msg.tokens, msg.ok,
                          msg.reason, msg.replayed)
        elif isinstance(msg, M.ServeKvReady):
            core.kv_ready(msg.replica_id, msg.req_id, msg.payload,
                          msg.fp32_bytes, msg.addr, msg.seg_fp, msg.crc32,
                          msg.nbytes)
        elif isinstance(msg, M.ServeKvReject):
            core.kv_reject(msg.replica_id, msg.req_id, msg.reason)
        elif isinstance(msg, M.ServeDrainRequest):
            return M.BaseResponse(success=core.drain(msg.replica_id))
        return None

    return handle


class Tier:
    """N gateways of one package on a LocalKv registry, loopback
    transports keyed by fake addresses (the reference tests' ``_Tier``).
    ``gateways`` maps an id to a core, or to a ``Gateway`` whose
    ``handle`` the transport calls."""

    def __init__(self, pkg, n=2, lease_s=5.0, gateways=None, **core_kw):
        self.pkg = pkg
        self.M = pkg.msg
        self.kv = pkg.tier.LocalKv()
        self.clock = Clock()
        self.registry = pkg.tier.ServeRegistry(self.kv, job="j",
                                               lease_s=lease_s,
                                               clock=self.clock)
        core_kw.setdefault("trace_sample", 0.0)
        self.cores, self.addr_map = {}, {}
        gws = gateways or {
            f"g{i}": pkg.gw.GatewayCore(pkg.gw.GatewayConfig(**core_kw),
                                        clock=Clock())
            for i in range(n)}
        for gid, gw in gws.items():
            core = getattr(gw, "core", gw)
            handle = gw.handle if gw is not core else full_handle(core,
                                                                  self.M)
            self.cores[gid] = core
            self.addr_map[f"addr-{gid}"] = pkg.gw.LoopbackTransport(handle)
            self.registry.announce_gateway(gid, f"addr-{gid}")
        self.ring = pkg.hr.HashRing(list(self.cores))

    def connect(self, addr):
        tier = self

        class Proxy:
            def call(self, msg, **kw):
                return tier.addr_map[addr].call(msg, **kw)

        return Proxy()

    def kill(self, gid):
        self.registry.remove_gateway(gid)

        class Dead:
            def call(self, msg, **kw):
                raise RuntimeError(f"gateway {gid} is dead")

        self.addr_map[f"addr-{gid}"] = Dead()

    def link(self, rid):
        return self.pkg.tier.TierReplicaLink(self.registry, rid,
                                             connect=self.connect,
                                             refresh_s=0.0)

    def client(self):
        return self.pkg.tier.TierClient(self.registry, connect=self.connect,
                                        poll_interval=0.002, refresh_s=0.0)

    def wire(self, x):
        return self.M.serialize(x) if isinstance(x, self.M.Message) else x


def _ids(grants):
    return [g.req_id for g in grants.requests]


def link_free_slots_never_double_granted(tier):
    M = tier.M
    for i in range(8):
        tier.cores[tier.ring.owner(f"q{i}")].submit(f"q{i}", [1], 4)
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=3))
    grants = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=3,
                                          active=[]))
    assert len(grants.requests) == 3
    return [tier.wire(grants), dict(link._granted_by)]


def link_drain_requires_every_gateway(tier):
    M = tier.M
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=2))
    tier.cores["g0"].drain("r0")
    first = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=2,
                                         active=[]))
    tier.cores["g1"].drain("r0")
    second = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=2,
                                          active=[]))
    assert first.drain is False and second.drain is True
    return [tier.wire(first), tier.wire(second)]


def link_known_false_reregisters_at_that_gateway_only(tier):
    M = tier.M
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=2))
    g1_rids = [f"w{i}" for i in range(40)
               if tier.ring.owner(f"w{i}") == "g1"][:1]
    tier.cores["g1"].submit(g1_rids[0], [1], 4)
    a = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=1,
                                     active=[]))
    tier.cores["g0"]._replicas.clear()  # g0 "restarts"
    b = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=0,
                                     active=g1_rids))
    assert "r0" in tier.cores["g0"].stats_snapshot()["replicas"]
    assert tier.cores["g1"].counters["redispatched"] == 0
    return [tier.wire(a), tier.wire(b),
            sorted(tier.cores["g0"].stats_snapshot()["replicas"])]


def link_reports_route_to_granting_gateway(tier):
    M = tier.M
    rid = next(f"q{i}" for i in range(40) if tier.ring.owner(f"q{i}") == "g1")
    tier.cores["g1"].submit(rid, [1, 2], 2)
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=2))
    grants = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=2,
                                          active=[]))
    reply = link.call(M.ServeDone(replica_id="r0", req_id=rid, tokens=[7, 8],
                                  ok=True))
    done = {g: c.counters["completed"] for g, c in tier.cores.items()}
    assert _ids(grants) == [rid] and done == {"g0": 0, "g1": 1}
    return [_ids(grants), tier.wire(reply), done]


def link_report_falls_back_to_ring_owner(tier):
    M = tier.M
    rid = next(f"q{i}" for i in range(40) if tier.ring.owner(f"q{i}") == "g0")
    tier.cores["g0"].submit(rid, [1, 2], 2)
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=2))
    link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=2, active=[]))
    tier.kill("g0")
    tier.cores["g1"].submit(rid, [1, 2], 2)
    link.call(M.ServeDone(replica_id="r0", req_id=rid, tokens=[7, 8],
                          ok=True))
    assert tier.cores["g1"].counters["completed"] == 1
    return [rid, tier.cores["g1"].status(rid).tokens]


def link_routes_pruned_on_every_terminal_report(tier):
    M = tier.M
    core = tier.cores["g0"]
    core.register("p0", 4, role="prefill")
    core.register("d0", 4, role="decode")
    core.submit("k0", [1, 2], 2)
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=4,
                                     role="prefill"))
    grants = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=4,
                                          active=[]))
    seen = [_ids(grants), sorted(link._granted_by)]
    link.call(M.ServeKvReady(replica_id="r0", req_id="k0", payload=b"seg"))
    seen.append(sorted(link._granted_by))
    core.submit("k1", [1], 2, deadline_s=5.0)
    link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=4, active=[]))
    seen.append(sorted(link._granted_by))
    cancel = M.ServeGrants(cancel=["k1"], known=True)

    class CancelOnce:
        def __init__(self, inner):
            self.inner, self.sent = inner, False

        def call(self, msg, **kw):
            if isinstance(msg, M.ServeReplicaPoll) and not self.sent:
                self.sent = True
                return cancel
            return self.inner.call(msg, **kw)

    link._set._transports["g0"] = CancelOnce(link._set._transports["g0"])
    link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=0, active=[]))
    seen.append(sorted(link._granted_by))
    assert seen[1] == ["k0"] and seen[2] == [] and "k1" in seen[3] and \
        seen[4] == []
    return seen


def link_no_live_gateway_poll_is_calm(tier):
    M = tier.M
    link = tier.link("r0")
    link.call(M.ServeReplicaRegister(replica_id="r0", slots=2))
    tier.kill("g0")
    reply = link.call(M.ServeReplicaPoll(replica_id="r0", free_slots=2,
                                         active=[]))
    assert reply.requests == [] and reply.known
    return [tier.wire(reply)]


LINK_CASES = {
    "free_slots_never_double_granted":
        (link_free_slots_never_double_granted, 2),
    "drain_requires_every_gateway": (link_drain_requires_every_gateway, 2),
    "known_false_reregisters_at_that_gateway_only":
        (link_known_false_reregisters_at_that_gateway_only, 2),
    "reports_route_to_granting_gateway":
        (link_reports_route_to_granting_gateway, 2),
    "report_falls_back_to_ring_owner":
        (link_report_falls_back_to_ring_owner, 2),
    "routes_pruned_on_every_terminal_report":
        (link_routes_pruned_on_every_terminal_report, 1),
    "no_live_gateway_poll_is_calm": (link_no_live_gateway_poll_is_calm, 1),
}


@pytest.mark.parametrize("case", sorted(LINK_CASES))
def test_replica_link_equal(case):
    fn, n = LINK_CASES[case]
    assert fn(Tier(PORT, n)) == fn(Tier(REF, n))


def test_replica_link_register_broadcasts_and_deregisters():
    out = []
    for pkg in BOTH:
        tier = Tier(pkg, 3)
        M = tier.M
        link = tier.link("r0")
        link.call(M.ServeReplicaRegister(replica_id="r0", slots=2,
                                         role="decode"))
        reps = tier.registry.replicas()
        at = {g: sorted(c.stats_snapshot()["replicas"])
              for g, c in tier.cores.items()}
        other = link.call(M.ServeFleetStatsRequest())
        link.call(M.ServeReplicaDeregister(replica_id="r0"))
        out.append([reps, at, sorted(other.stats), tier.registry.replicas(),
                    {g: sorted(c.stats_snapshot()["replicas"])
                     for g, c in tier.cores.items()}])
    assert out[0] == out[1]
    assert out[0][1] == {"g0": ["r0"], "g1": ["r0"], "g2": ["r0"]}


# -- the tier client's failover over two in-process Gateways ----------------

def failover_script(pkg, tmp) -> dict:
    """Requests owned by g0 complete at a journaled replica, g0 dies
    before the client reads them, the ring re-forms onto g1 and the
    client resubmits: the replica's journal answers."""
    gws = {g: pkg.gw.Gateway(port=0, config=pkg.gw.GatewayConfig(
        trace_sample=0.0)) for g in ("g0", "g1")}
    tier = Tier(pkg, gateways=gws, lease_s=2.0)
    runner = pkg.rep.ReplicaRunner(
        FakeDecodeServer(slots=4), tier.link("r0"), "r0",
        journal_path=str(tmp / f"{pkg.name}.jsonl"), poll_interval=0.001,
        kv_p2p=False)
    th = threading.Thread(target=runner.run, daemon=True)
    th.start()
    cli = tier.client()
    try:
        g0_rids = [f"f{i}" for i in range(60)
                   if tier.ring.owner(f"f{i}") == "g0"][:4]
        g1_rids = [f"f{i}" for i in range(60)
                   if tier.ring.owner(f"f{i}") == "g1"][:2]
        acks = [cli.submit(r, [5, 6], 4).status for r in g0_rids + g1_rids]
        assert wait_for(lambda: tier.cores["g0"].counters["completed"]
                        == len(g0_rids) and tier.cores["g1"].counters[
                            "completed"] == len(g1_rids))
        served = runner.served
        tier.kill("g0")
        results = {r: cli.result(r, timeout=20) for r in g0_rids + g1_rids}
        assert wait_for(lambda: runner.replayed >= len(g0_rids))
        again = [cli.submit(r, [5, 6], 4) for r in g0_rids]
        return {
            "acks": acks,
            "results": {r: (v.state, v.tokens) for r, v in results.items()},
            "resubmitted": cli.resubmitted,
            "decoded_after_kill": runner.served - served,
            "g1_completed": tier.cores["g1"].counters["completed"],
            "again": [(a.status, a.tokens) for a in again],
            "g1_dedupe_hits": tier.cores["g1"].counters["dedupe_hits"],
        }
    finally:
        for core in tier.cores.values():
            core.drain("r0")
        th.join(timeout=20)
        cli.close()
        for gw in gws.values():
            gw.stop(0.0)


def test_tier_client_failover_equal(tmp_path):
    got, want = failover_script(PORT, tmp_path), failover_script(REF, tmp_path)
    assert got == want
    assert got["resubmitted"] >= 4 and got["decoded_after_kill"] == 0
    assert all(v == ("done", expected_tokens([5, 6], 4))
               for v in got["results"].values())
    assert got["g1_dedupe_hits"] == 4


# -- tier actuation and the serving auto-scaler ------------------------------

class Group:
    min_count = 1
    max_count = 4
    count = 2


class Args:
    workers = Group()
    node_unit = 1
    distribution_strategy = "serving"


class JM:
    """The reference tests' fake job manager."""

    def __init__(self, live):
        self.targets = []
        self.live = live

    def scale_workers_to(self, n):
        self.targets.append(n)
        return n - self.live

    def alive_workers(self):
        return [object()] * self.live

    def pending_workers(self):
        return []


def actuator_script(pkg) -> list:
    G = pkg.gw
    clock = Clock()
    a = G.GatewayCore(G.GatewayConfig(trace_sample=0.0), clock=clock)
    b = G.GatewayCore(G.GatewayConfig(trace_sample=0.0), clock=clock)
    for core in (a, b):
        core.register("r0", 2)
        core.register("r1", 2)
    act = pkg.tier.TierActuator(cores=[a, b])
    jm = JM(live=2)
    sc = pkg.jas.ServingFleetAutoScaler(
        Args(), jm, act, policy=pkg.auto.ScalePolicy(
            min_replicas=1, max_replicas=3, up_patience=1, down_patience=1,
            queue_high_per_replica=2.0),
        interval=999)
    out = []

    def rec(tag, delta):
        snap = act.stats_snapshot()
        out.append((tag, delta, list(jm.targets), sc._pending_drain,
                    {r: v["draining"] for r, v in snap["replicas"].items()},
                    snap["replicas_alive"], act.pick_drain_victim()))

    # Pressure at both gateways: either alone is under the threshold.
    for i in range(3):
        a.submit(f"p{i}", [1], 4)
        b.submit(f"q{i}", [1], 4)
    rec("pressure", sc.scale_once())
    # Grants spread over both gateways; everything finishes.
    for core in (a, b):
        g0 = core.poll("r0", 2, [])
        g1 = core.poll("r1", 1, [])
        for rep, grants in (("r0", g0), ("r1", g1)):
            for g in grants.requests:
                core.complete(rep, g.req_id, [1, 2])
        out.append(("grants", _ids(g0), _ids(g1)))
    # Idle: drain-first scale-down, broadcast to both gateways.
    rec("idle", sc.scale_once())
    rec("held", sc.scale_once())  # the victim still registered
    victim = sc._pending_drain[0]
    for core in (a, b):
        core.deregister(victim)
    rec("left", sc.scale_once())  # the worker is not reaped yet
    jm.live = 1
    rec("reaped", sc.scale_once())
    out.append(("drain_unknown", act.drain("nobody")))
    return out


def test_tier_actuator_and_serving_autoscaler_equal():
    got, want = actuator_script(PORT), actuator_script(REF)
    assert got == want
    by_tag = {r[0]: r for r in got}
    assert by_tag["pressure"][2] == [3]
    victim, target = by_tag["idle"][3]
    assert target == 1 and by_tag["idle"][4][victim] is True
    assert by_tag["held"][2] == [3] and by_tag["left"][2] == [3]
    assert by_tag["reaped"][2] == [3, 1] and by_tag["reaped"][3] is None


def test_tier_actuator_over_the_wire():
    """The registry backend: ServeDrainRequest and ServeFleetStatsRequest
    to started gateways found through the registry."""
    out = []
    for pkg in BOTH:
        registry = pkg.tier.ServeRegistry(pkg.tier.LocalKv(), job="act",
                                          lease_s=1e6, clock=Clock())
        gws = []
        try:
            for gid in ("g0", "g1"):
                gw = pkg.gw.Gateway(port=0, config=pkg.gw.GatewayConfig(
                    trace_sample=0.0))
                gw.start()
                gw.core.register("r0", 4)
                gw.core.register("r1", 4)
                registry.announce_gateway(gid, f"127.0.0.1:{gw.port}")
                gws.append(gw)
            gws[0].core.submit("a", [1], 4)
            gws[0].core.poll("r1", 1, [])
            act = pkg.tier.TierActuator(registry=registry)
            snap = act.stats_snapshot()
            victim = act.pick_drain_victim()
            ok = act.drain(victim)
            out.append((snap["gateways"], snap["replicas_alive"],
                        snap["in_flight"], victim, ok,
                        [g.core.stats_snapshot()["replicas"][victim][
                            "draining"] for g in gws]))
            act.close()
        finally:
            for gw in gws:
                gw.stop(0.0)
    assert out[0] == out[1] == (2, 2, 1, "r0", True, [True, True])


def test_new_job_auto_scaler_serving_family():
    core = tgw.GatewayCore(tgw.GatewayConfig())
    sc = tjas.new_job_auto_scaler(Args(), JM(1), None,
                                  serving_gateway=core)
    ref = jjas.new_job_auto_scaler(Args(), JM(1), None,
                                   serving_gateway=jgw.GatewayCore(
                                       jgw.GatewayConfig()))
    assert type(sc).__name__ == type(ref).__name__ == \
        "ServingFleetAutoScaler"
    assert sc._policy.min_replicas == ref._policy.min_replicas == 1
    assert sc._policy.max_replicas == ref._policy.max_replicas == 4
    assert sc._interval == ref._interval == 30
    sc.start_auto_scaling()
    sc.stop_auto_scaling()
    sc._thread.join(timeout=5)
    for strategy in ("allreduce", "embedding", "offline", "unknown"):
        args = types.SimpleNamespace(workers=Group(),
                                     distribution_strategy=strategy)
        with pytest.raises(NotImplementedError, match="host-only layers"):
            tjas.new_job_auto_scaler(args, JM(1), None)
    with pytest.raises(NotImplementedError, match="training auto-scaler"):
        tjas.new_job_auto_scaler(Args(), JM(1), None)


# -- the /metrics text -------------------------------------------------------

def gauges_script(pkg) -> str:
    clock = Clock()
    gw = pkg.gw.Gateway(port=0, config=pkg.gw.GatewayConfig(
        trace_sample=0.0, queue_cap=3), clock=clock)
    try:
        core = gw.core
        core.register("r0", 2)
        core.register("p0", 2, role="prefill")
        for i in range(4):
            core.submit(f"q{i}", [1, 2], 4)
        grants = core.poll("r0", 2, [])
        clock.advance(0.25)
        core.stream("r0", grants.requests[0].req_id, [3])
        clock.advance(0.5)
        core.complete("r0", grants.requests[0].req_id, [3, 4])
        core.submit("q0", [1, 2], 4)  # answered from the dedupe cache
        registry = pkg.met.MetricsRegistry()
        gw.register_gauges(registry)
        registry.set("pinned", 2.5)
        registry.gauge("broken", lambda: 1 / 0)
        return registry.render()
    finally:
        gw.stop(0.0)


def test_gateway_gauges_render_equal():
    got, want = gauges_script(PORT), gauges_script(REF)
    assert got == want
    lines = dict(ln.split(" ") for ln in got.splitlines()
                 if not ln.startswith("#"))
    assert lines["dlrover_tpu_serve_completed"] == "1.0"
    assert lines["dlrover_tpu_serve_dedupe_hits"] == "1.0"
    assert lines["dlrover_tpu_serve_rejected"] == "1.0"
    assert "dlrover_tpu_broken" not in lines


def test_metrics_server_serves_the_registry():
    reg = tmet.MetricsRegistry()
    h = tmet.Histogram()
    for v in (3, 30, 300):
        h.observe(v)
    h.register_gauges(reg, "x")
    srv = tmet.MetricsServer(reg, 0)
    srv.start()
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read()
        assert body.decode() == reg.render()
        assert "dlrover_tpu_x_p95_ms 500.0" in body.decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/other",
                                   timeout=10)
    finally:
        srv.stop()
