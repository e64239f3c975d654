"""The port's master (``dlrover_tpu_torch/master/``) and transport
(``common/rpc.py``), mirroring ``tests/test_master.py``'s
``TestRendezvous``, ``TestKVSyncMetrics`` and ``TestSpeedMonitor``: an
in-process ``LocalJobMaster`` on a free port, driven by ``MasterClient``s
over the port's own framing.

The differential test sends one seeded sequence of requests to the
reference's ``MasterServicer`` and to the port's, called in process, and
holds the replies' bytes equal.  Time: the sequence's requests carry fixed
timestamps (``Heartbeat``, ``GlobalStep``), and none of its replies
carries a clock (no diagnosis pass runs, so a heartbeat is answered
``HeartbeatResponse(actions=[])``; a step or a checkpoint perf report
``BaseResponse``), so nothing is frozen or left out.  The transport is held to the reference's contract: a
master restarted on the same port is reached through the retry, a timeout
is retried only for idempotent calls, and a payload that does not decode is
answered as a failed ``BaseResponse``."""

import random
import socket
import struct
import threading
import time

import pytest
import torch

from dlrover_tpu.common import messages as R
from dlrover_tpu.master.master import LocalJobMaster as RMaster
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common import rpc
from dlrover_tpu_torch.common.constants import NodeStatus, RendezvousName
from dlrover_tpu_torch.master import main as master_main
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.master.rendezvous import (
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.speed_monitor import SpeedMonitor
from dlrover_tpu_torch.master.topology import (
    DpTopologySorter,
    NodeTopologyMeta,
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: The rendezvous's lastcall window in these tests (the default is 3 s;
#: a round below max_nodes completes once it has passed).
LASTCALL_S = 0.3


def _fast(mst):
    for mgr in mst.rdzv_managers.values():
        mgr._waiting_timeout = LASTCALL_S
    return mst


@pytest.fixture()
def master():
    mst = _fast(LocalJobMaster(0, job_name="test-job", min_nodes=2,
                               max_nodes=4))
    mst.prepare()
    yield mst
    mst.stop()


def make_client(master, node_id):
    c = MasterClient(master.addr, node_id)
    c.register_node(node_rank=node_id, host="127.0.0.1",
                    agent_port=9000 + node_id, local_world_size=2,
                    slice_id=f"slice-{node_id % 2}")
    return c


def _world(client, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        _, _, world, _ = client.get_comm_world()
        if world:
            return world
        time.sleep(0.2)
    return {}


class TestRendezvous:
    def test_rejoin_evicts_stale_world(self, master):
        mgr = master.rdzv_managers[RendezvousName.TRAINING]
        c0, c1 = make_client(master, 0), make_client(master, 1)
        c0.join_rendezvous(node_rank=0, local_world_size=1)
        c1.join_rendezvous(node_rank=1, local_world_size=1)
        assert len(_world(c0)) == 2
        c1.join_rendezvous(node_rank=1, local_world_size=1,
                           attempt_id="same-attempt")
        c1.join_rendezvous(node_rank=1, local_world_size=1,
                           attempt_id="same-attempt")
        c0.join_rendezvous(node_rank=0, local_world_size=1)
        assert len(_world(c0)) == 2
        assert mgr.num_nodes_waiting() == 0  # the duplicate did not evict
        c1b = MasterClient(master.addr, 1)
        c1b.join_rendezvous(node_rank=1, local_world_size=1)
        _, _, world1b, _ = c1b.get_comm_world()
        assert world1b == {}  # the stale round is not handed out
        assert mgr.num_nodes_waiting() > 0
        c0.join_rendezvous(node_rank=0, local_world_size=1)
        assert len(_world(c1b)) == 2
        for c in (c0, c1, c1b):
            c.close()

    def test_two_node_rendezvous(self, master):
        c0, c1 = make_client(master, 0), make_client(master, 1)
        c0.join_rendezvous(node_rank=0, local_world_size=2)
        c1.join_rendezvous(node_rank=1, local_world_size=2)
        world = _world(c0)
        assert len(world) == 2
        assert world[0]["process_id_base"] == 0
        assert world[1]["process_id_base"] == 2
        _, _, _, coord = c0.get_comm_world()
        assert coord == "127.0.0.1:9000"  # the rank-0 node's port
        _, _, world1, _ = c1.get_comm_world()
        assert set(world1) == {0, 1}
        assert master.rdzv_managers[
            RendezvousName.TRAINING].num_nodes_waiting() == 0
        c0.close(); c1.close()

    def test_waiting_node_triggers_membership_change(self, master):
        c0, c1 = make_client(master, 0), make_client(master, 1)
        c0.join_rendezvous(0, 1)
        c1.join_rendezvous(1, 1)
        assert _world(c0)
        assert c0.num_nodes_waiting() == 0
        c2 = make_client(master, 2)
        c2.join_rendezvous(2, 1)
        assert c0.num_nodes_waiting() == 1
        for c in (c0, c1, c2):
            c.close()

    def test_node_unit_rounding(self):
        mst = _fast(LocalJobMaster(0, min_nodes=2, max_nodes=8,
                                   node_unit=2))
        mst.prepare()
        try:
            clients = [make_client(mst, i) for i in range(3)]
            for i, c in enumerate(clients):
                c.join_rendezvous(i, 1)
            assert len(_world(clients[0])) == 2  # 3 nodes, unit 2
            assert mst.rdzv_managers[
                RendezvousName.TRAINING].num_nodes_waiting() == 1
            for c in clients:
                c.close()
        finally:
            mst.stop()


class TestKVSyncMetrics:
    def test_kv_store(self, master):
        c0, c1 = make_client(master, 0), make_client(master, 1)
        c0.kv_store_set("addr/0", b"1.2.3.4:99")
        assert c1.kv_store_wait_get("addr/0", timeout=5) == b"1.2.3.4:99"
        assert c1.kv_store_get("missing") is None
        assert c0.kv_store_add("cnt", 2) == 2
        assert c1.kv_store_add("cnt", 3) == 5
        c0.kv_store_multi_set({"a": b"1", "b": b"2"})
        assert c1.kv_store_multi_get(["a", "b", "zz"]) == {"a": b"1",
                                                           "b": b"2"}
        assert c1.kv_store_scan("a") == {"a": b"1", "addr/0": b"1.2.3.4:99"}
        assert c0.kv_store_delete("a") and not c1.kv_store_delete("a")
        c0.close(); c1.close()

    def test_named_barrier(self, master):
        c0, c1 = make_client(master, 0), make_client(master, 1)
        c0.join_rendezvous(0, 1); c1.join_rendezvous(1, 1)
        assert _world(c0)
        results = {}

        def join(c, key):
            results[key] = c.barrier("before-reshard", timeout=20)

        t0 = threading.Thread(target=join, args=(c0, 0))
        t0.start()
        time.sleep(0.3)
        join(c1, 1)
        t0.join(timeout=25)
        assert results == {0: True, 1: True}
        # The checkpoint barrier opens once every node reported the step.
        assert not c0.sync_checkpoint(4)
        assert c1.sync_checkpoint(4)
        c0.close(); c1.close()

    def test_speed_and_heartbeat(self, master):
        c = make_client(master, 0)
        base = time.time()
        for s in range(1, 6):
            c.report_global_step(s, base + s * 0.1)
        assert master.speed_monitor.completed_global_step == 5
        assert master.speed_monitor.running_speed() > 0
        assert c.report_heartbeat() == []
        node = master.job_manager.get_node(0)
        assert node is not None and node.status == NodeStatus.RUNNING
        c.report_ckpt_perf(5, 12.5, staged_mbps=100.0)
        assert master.speed_monitor.ckpt_stall_last_ms == 12.5
        c.close()

    def test_job_exit_and_silent_nodes_end_the_job(self, master):
        c = make_client(master, 0)
        master.job_manager._ctx.node_heartbeat_timeout = 0.0
        master.job_manager.get_node(0).heartbeat_time = time.time() - 1
        master.job_manager._check_heartbeats()
        assert master.job_manager.get_node(0).status == NodeStatus.FAILED
        assert master.job_manager.all_workers_exited()
        master.job_manager._ctx.node_heartbeat_timeout = 300.0
        c.report_job_exit(True, "done")
        assert master._stop_event.is_set() and master._exit_code == 0
        c.close()


class TestSpeedMonitor:
    def test_goodput_accounting(self):
        sm = SpeedMonitor()
        t0 = time.time() - 10
        sm.collect_global_step(1, t0)
        sm.collect_global_step(5, t0 + 2)
        sm._downtime_total = 3.0
        assert 0.5 < sm.goodput() < 0.8
        assert not sm.hang_detected(timeout=3600)
        assert sm.hang_detected(timeout=5)


def test_topology_and_network_check_match_the_reference():
    from dlrover_tpu.master import rendezvous as rr
    from dlrover_tpu.master import topology as rt

    nodes = {i: (i, i, 4, f"sl-{'ab'[i % 2]}", f"h{i % 3}")
             for i in range(7)}
    got = DpTopologySorter().sort(
        {k: NodeTopologyMeta(*v) for k, v in nodes.items()})
    want = rt.DpTopologySorter().sort(
        {k: rt.NodeTopologyMeta(*v) for k, v in nodes.items()})
    assert [n.node_id for n in got] == [n.node_id for n in want]
    mgrs = (NetworkCheckRendezvousManager(),
            rr.NetworkCheckRendezvousManager())
    out = []
    for mgr in mgrs:
        mgr.update_rdzv_params(4, 4)
        for i in range(4):
            mgr.join(i, i, 1, host=f"h{i}", coordinator_port=9000 + i)
        worlds = [mgr.get_comm_world(i) for i in range(4)]
        for nid, t in [(0, 1.0), (1, 1.1), (2, 0.9), (3, 5.0)]:
            mgr.report_result(nid, True, t)
        strag = mgr.get_stragglers()
        mgr.next_check_round()
        with mgr._lock:
            groups = mgr._group_nodes_locked()
        out.append((worlds, strag, groups, mgr.check_fault_node(),
                    mgr.network_ready(), mgr.results_complete()))
    assert out[0] == out[1]
    assert out[0][1][1] == [3]


# -- the differential test ----------------------------------------------------

def _sequence(seed: int) -> list:
    """One seeded sequence of requests a training job sends, as
    ``(type name, fields)``."""
    rng = random.Random(seed)
    seq = []
    for nid in (0, 1):
        seq.append(("NodeMeta", dict(node_id=nid, node_rank=nid,
                                     host="127.0.0.1",
                                     agent_port=9100 + nid,
                                     local_world_size=2,
                                     slice_id=f"s{nid}")))
    seq += [("Heartbeat", dict(node_id=0, timestamp=1700000000.25)),
            ("WaitingNodeNumRequest", {}),
            ("JoinRendezvous", dict(node_id=0, node_rank=0,
                                    local_world_size=2, attempt_id="a0")),
            ("CommWorldRequest", dict(node_id=0)),
            ("JoinRendezvous", dict(node_id=1, node_rank=1,
                                    local_world_size=2, attempt_id="a1")),
            ("JoinRendezvous", dict(node_id=1, node_rank=1,
                                    local_world_size=2, attempt_id="a1")),
            ("CommWorldRequest", dict(node_id=0)),
            ("CommWorldRequest", dict(node_id=1)),
            ("WaitingNodeNumRequest", {})]
    keys = [f"k{i}" for i in range(5)]
    for i in range(12):
        k = rng.choice(keys)
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 40)))
        seq += [("KVStoreSet", dict(key=k, value=v)),
                ("KVStoreGet", dict(key=rng.choice(keys + ["nope"]))),
                ("KVStoreAdd", dict(key=f"c{i % 2}",
                                    delta=rng.randrange(-3, 9),
                                    token=f"t{rng.randrange(4)}"))]
    seq += [("KVStoreMultiSet", dict(kvs={"m1": b"1", "m2": b""})),
            ("KVStoreMultiGet", dict(keys=["m1", "m2", "k0", "x"])),
            ("KVStoreScan", dict(prefix="k")),
            ("KVStoreDelete", dict(key="k1", token="d1")),
            ("KVStoreDelete", dict(key="k1", token="d1")),
            ("KVStoreDelete", dict(key="k1", token="d2")),
            ("SyncJoin", dict(sync_name="s", node_id=0)),
            ("SyncQuery", dict(sync_name="s")),
            ("SyncJoin", dict(sync_name="s", node_id=1)),
            ("SyncQuery", dict(sync_name="s")),
            ("SyncFinish", dict(sync_name="t")),
            ("SyncQuery", dict(sync_name="t")),
            ("CheckpointSync", dict(node_id=0, step=4)),
            ("CheckpointSync", dict(node_id=1, step=4)),
            ("GlobalStep", dict(node_id=0, step=3,
                                timestamp=1700000001.5)),
            ("CkptPerf", dict(node_id=0, step=4, stall_ms=12.5,
                              staged_mbps=900.0)),
            ("ReportNodeStatus", dict(node_id=1, status="running")),
            ("NodeFailure", dict(node_id=1, error_data="x")),
            ("ElasticRunConfigRequest", {}),
            ("ParallelConfigRequest", dict(node_id=0)),
            ("Heartbeat", dict(node_id=1, timestamp=1700000002.0)),
            ("UsedResource", dict(node_id=0, cpu_percent=3.0)),
            ("ModelInfo", dict(num_params=7, extra={"a": 1})),
            ("DiagnosisReport", dict(node_id=0, data_type="d")),
            ("Empty", {}),
            ("JobExitRequest", dict(node_id=0, reason="done"))]
    return seq


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_servicer_answers_with_the_references_bytes(seed):
    ref = RMaster(0, job_name="diff", min_nodes=2, max_nodes=2)
    port = LocalJobMaster(0, job_name="diff", min_nodes=2, max_nodes=2)
    try:
        for name, fields in _sequence(seed):
            want = ref.servicer(R._REGISTRY[name](**fields))
            got = port.servicer(m._REGISTRY[name](**fields))
            want = want if want is not None else R.BaseResponse()
            got = got if got is not None else m.BaseResponse()
            assert m.serialize(got) == R.serialize(want), (name, got, want)
        assert port._stop_event.is_set() and ref._stop_event.is_set()
    finally:
        port._server.stop()
        ref._server.stop(0)


# -- the transport

def test_a_bad_payload_is_a_failed_response_and_the_server_stays_up(master):
    with socket.create_connection(("127.0.0.1", master.port)) as sk:
        for payload in (b"\xc1", b"garbage", R.serialize(R.ServeAck())):
            rpc._send_frame(sk, payload)
            resp = m.deserialize(rpc._recv_frame(sk))
            assert isinstance(resp, m.BaseResponse) and not resp.success
        sk.sendall(struct.pack(">I", 1 << 31))  # over the frame limit
        assert sk.recv(1) == b""  # that connection is closed
    c = make_client(master, 0)
    assert c.report_heartbeat() == []
    c.close()


def test_retry_reaches_a_master_restarted_on_the_same_port():
    first = LocalJobMaster(0, job_name="restart")
    first.prepare()
    port = first.port
    c = MasterClient(first.addr, 0)
    c.kv_store_set("a", b"1")
    first.stop()
    box = {}

    def relaunch():
        time.sleep(1.0)
        box["m"] = LocalJobMaster(port, job_name="restart")
        box["m"].prepare()

    t = threading.Thread(target=relaunch)
    t.start()
    try:
        # Refused while the port is closed: UNAVAILABLE, retried.
        assert c.kv_store_get("a") is None  # a new master, a blank store
        c.register_node(node_rank=0)
        assert box["m"].job_manager.get_node(0) is not None
    finally:
        t.join()
        c.close()
        box["m"].stop()


def _slow_server(delay: float):
    calls = []

    def handler(msg):
        calls.append(type(msg).__name__)
        time.sleep(delay)
        return m.BaseResponse(reason="late")

    srv = rpc.RpcServer(0, handler, host="127.0.0.1")
    srv.start()
    return srv, calls


def test_a_timeout_is_retried_only_when_idempotent():
    srv, calls = _slow_server(0.6)
    try:
        c = rpc.RpcClient(f"127.0.0.1:{srv.port}")
        with pytest.raises(rpc.RpcError) as err:
            c.call(m.Heartbeat(), timeout=0.2, deadline=5.0)
        assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
        assert calls == ["Heartbeat"]
        with pytest.raises(rpc.RpcError) as err:
            c.call(m.KVStoreGet(key="a"), timeout=0.2, retries=3,
                   backoff=0.05, deadline=5.0, idempotent=True)
        assert err.value.code() == rpc.StatusCode.DEADLINE_EXCEEDED
        time.sleep(1.0)
        assert calls.count("KVStoreGet") == 3
        resp = c.call(m.KVStoreGet(key="a"), timeout=2.0)
        assert resp.reason == "late"
        c.close()
    finally:
        srv.stop()


def test_a_refused_connection_is_unavailable_after_the_budget():
    port = rpc.find_free_port()
    c = rpc.RpcClient(f"127.0.0.1:{port}")
    t0 = time.monotonic()
    with pytest.raises(rpc.RpcError) as err:
        c.call(m.Empty(), retries=3, backoff=0.05, deadline=2.0)
    assert err.value.code() == rpc.StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 2.0
    assert not rpc.addr_connectable(f"127.0.0.1:{port}", timeout=0.3)
    assert not rpc.addr_connectable("no-port", timeout=0.3)


def test_master_main_serves_and_refuses_later_flags(tmp_path):
    args = master_main.parse_args(["--port_file", str(tmp_path / "p")])
    assert args.platform == "local" and args.port == 0
    for flags, match in ([["--brain_addr", "h:1"], "Brain"],
                         [["--cell_id", "c0"], "multi-cell"],
                         [["--platform", "gke"], "gke"]):
        with pytest.raises(NotImplementedError, match=match):
            master_main.run(master_main.parse_args(flags))
    with pytest.raises(NotImplementedError, match="Brain"):
        LocalJobMaster(0, resource_optimizer=object())
    # Master HA's flags are taken, not refused.
    args = master_main.parse_args(["--standby", "--state_dir", "d",
                                   "--primary_addr", "127.0.0.1:1"])
    master_main.refuse_later_options(args)
    assert args.standby and args.state_dir == "d"


# -- constants, knobs, the token cache ---------------------------------------

@pytest.mark.parametrize("name", ["NodeType", "NodeStatus", "JobStage",
                                  "JobExitReason", "RendezvousName",
                                  "DiagnosisActionType", "GRPC",
                                  "Defaults"])
def test_constants_are_the_references(name):
    from dlrover_tpu.common import constants as rc
    from dlrover_tpu_torch.common import constants as pc

    def values(cls):
        return {k: v for k, v in vars(cls).items() if not k.startswith("_")}

    got, want = values(getattr(pc, name)), values(getattr(rc, name))
    assert got and all(want[k] == v for k, v in got.items()), name


def test_context_knobs_have_the_references_defaults_and_env(monkeypatch):
    from dlrover_tpu.common.global_context import Context as RContext
    from dlrover_tpu_torch.common.global_context import Context

    got = Context().to_dict()
    want = RContext().to_dict()
    assert got and {k: want[k] for k in got} == got
    monkeypatch.setenv("DLROVER_TPU_NODE_HEARTBEAT_TIMEOUT", "8")
    monkeypatch.setenv("DLROVER_TPU_AUTO_TUNE", "yes")
    monkeypatch.setenv("DLROVER_TPU_TRAIN_SPEED_RECORD_NUM", "9")
    got, want = Context().to_dict(), RContext().to_dict()
    assert {k: want[k] for k in got} == got
    assert got["node_heartbeat_timeout"] == 8 and got["auto_tune"] is True


def test_token_cache_is_fifo_bounded_like_the_references():
    from dlrover_tpu.common.token_cache import BoundedTokenCache as R
    from dlrover_tpu_torch.common.token_cache import BoundedTokenCache

    caches = (BoundedTokenCache(capacity=3), R(capacity=3))
    for c in caches:
        for i in range(5):
            c.put(f"t{i}", i)
        c.put("", 99)
    for tok in ("t0", "t1", "t2", "t4", "", "x"):
        assert caches[0].get(tok) == caches[1].get(tok)
    assert len(caches[0]) == len(caches[1]) == 3
