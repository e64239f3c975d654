"""The master's diagnosis in the port (``dlrover_tpu_torch/diagnosis/
{data,inference,operators,manager}.py``) against the reference's
(``dlrover_tpu/diagnosis/...``), both fed the same records under one
stepped clock (each module's ``time`` replaced):

- the data store's TTL and latest record a node;
- the hang operator: a global hang from the speed monitor, the compile
  grace before the first step, a node whose step reports stalled;
- failure classification, the runtime straggler;
- the inference chain and ``coordinate_solutions``;
- the manager: a failure to a relaunch, the broadcast's scoped fan-out,
  redelivery after delivery, stale expiry, a private payload a node, the
  whole-job fan-out and its cooldown.

Then end to end in the port: a global hang reaches every alive node's
heartbeat answer as ``RESTART_WORKER``, and the agent that gets it stops
its stopped (SIGSTOPped) worker and restarts it."""

import dataclasses
import json
import os
import shutil
import signal
import sys
import tempfile
import threading
import time

import pytest

from dlrover_tpu.common import messages as R
from dlrover_tpu.diagnosis import data as rdata
from dlrover_tpu.diagnosis import inference as rinf
from dlrover_tpu.diagnosis import manager as rman
from dlrover_tpu.diagnosis import operators as rops
from dlrover_tpu.master import speed_monitor as rspeed
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common import multi_process as port_mp
from dlrover_tpu_torch.common.global_context import get_context
from dlrover_tpu_torch.diagnosis import data as tdata
from dlrover_tpu_torch.diagnosis import inference as tinf
from dlrover_tpu_torch.diagnosis import manager as tman
from dlrover_tpu_torch.diagnosis import operators as tops
from dlrover_tpu_torch.master import speed_monitor as tspeed

T0 = 1_700_000_000.0


class _Clock:
    """Stands in for ``time`` in the diagnosis and speed-monitor modules
    of both packages."""

    def __init__(self):
        self.now = T0

    def time(self):
        return self.now

    monotonic = time


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    for mod in (tdata, tops, tman, tspeed, rdata, rops, rman, rspeed):
        monkeypatch.setattr(mod, "time", c)
    return c


def _infs(out):
    return [(i.name, i.attribution, dict(i.configs)) for i in out]


def _acts(actions):
    """Actions as plain data (the payload's clock stamp included)."""
    if isinstance(actions, dict):
        return {k: _acts(v) for k, v in actions.items()}
    return [dataclasses.asdict(a) for a in actions]


def test_data_store_ttl_and_latest(clock):
    port, ref = tdata.DiagnosisDataManager(ttl_s=50.0), \
        rdata.DiagnosisDataManager(ttl_s=50.0)
    for i, (nid, dt) in enumerate([(0, 0), (1, 10), (0, 20), (2, 30),
                                   (1, 45)]):
        for dm in (port, ref):
            dm.store_data(nid, "step_metrics", f"r{i}", timestamp=T0 + dt)
    for now in (T0 + 46, T0 + 65, T0 + 90, T0 + 200):
        clock.now = now
        assert [dataclasses.astuple(r) for r in port.get_data(
            "step_metrics")] == [dataclasses.astuple(r) for r in
                                 ref.get_data("step_metrics")]
        assert {k: dataclasses.astuple(v) for k, v in port.latest_per_node(
            "step_metrics").items()} == {
            k: dataclasses.astuple(v)
            for k, v in ref.latest_per_node("step_metrics").items()}
    cap = tdata.DiagnosisDataManager(max_per_type=3)
    for i in range(5):
        cap.store_data(0, "t", str(i))
    assert [r.content for r in cap.get_data("t")] == ["2", "3", "4"]


def _hang_ops(clock, steps, reports, hang_timeout=100.0, grace=3600.0):
    """The port's and the reference's hang operators over the same global
    steps (``(step, age)``) and node step reports (``(node, age)``)."""
    ops = []
    for dmod, omod, smod in ((tdata, tops, tspeed), (rdata, rops, rspeed)):
        dm, sm = dmod.DiagnosisDataManager(ttl_s=1e6), smod.SpeedMonitor()
        for step, age in steps:
            sm.collect_global_step(step, timestamp=clock.now - age)
        for nid, age in reports:
            dm.store_data(nid, "step_metrics", json.dumps({"step": 1}),
                          timestamp=clock.now - age)
        ops.append(omod.CheckTrainingHangOperator(
            dm, sm, hang_timeout_s=hang_timeout, compile_grace_s=grace))
    return ops


@pytest.mark.parametrize("case", [
    "global_hang", "compile_grace", "after_grace", "per_node_stall",
    "healthy", "one_node"])
def test_hang_operator_matches_the_reference(clock, case):
    steps, reports, advance = {
        "global_hang": ([(10, 150)], [], 0),
        "compile_grace": ([], [], 0),
        "after_grace": ([], [(0, 0), (1, 0)], 4000),
        "per_node_stall": ([(5, 0)], [(0, 0), (1, 500), (2, 30)], 0),
        "healthy": ([(5, 10)], [(0, 1), (1, 2)], 0),
        "one_node": ([(5, 10)], [(3, 900)], 0),
    }[case]
    port, ref = _hang_ops(clock, steps, reports)
    clock.now += advance
    hyp = [tinf.Inference(tinf.InferenceName.TRAINING_HANG)]
    got = _infs(port.infer(hyp))
    assert got == _infs(ref.infer([rinf.Inference(
        rinf.InferenceName.TRAINING_HANG)]))
    want_nodes = {"global_hang": ["-1"], "per_node_stall": ["1"]}.get(
        case, [])
    assert [c["node_id"] for _, _, c in got] == want_nodes


FAILURES = ["TPU initialization failed on host", "KeyError: 'foo'",
            "ICI link down", "CUDA error: an illegal memory access",
            "killed: Out of memory (oom-killer)", "worker failure "
            "(restart 1/3): [(0, -9)]", "coordination service heartbeat"]


def test_failure_classification_matches_the_reference(clock):
    port, ref = tdata.DiagnosisDataManager(), rdata.DiagnosisDataManager()
    for i, text in enumerate(FAILURES):
        port.store_data(i, "failure", text)
        ref.store_data(i, "failure", text)
    got = _infs(tops.CheckFailureNodeOperator(port).infer([]))
    assert got == _infs(rops.CheckFailureNodeOperator(ref).infer([]))
    assert [a for _, a, _ in got].count("failed") == 4


@pytest.mark.parametrize("p50s", [
    [0.1, 0.1, 0.35], [0.2, 0.5], [0.1, 0.12, 0.11, 0.3, 0.05], [0.3]])
def test_straggler_operator_matches_the_reference(clock, p50s):
    port, ref = tdata.DiagnosisDataManager(), rdata.DiagnosisDataManager()
    for nid, v in enumerate(p50s):
        payload = json.dumps({"metrics": {"step_p50_s": v,
                                          "optime_collective_frac": 0.1}})
        for dm in (port, ref):
            dm.store_data(nid, "op_metrics", payload,
                          timestamp=clock.now - nid)
    for dm in (port, ref):  # a stale report and a malformed one
        dm.store_data(9, "op_metrics", json.dumps({"step_p50_s": 9.0}),
                      timestamp=clock.now - 1000)
        dm.store_data(8, "op_metrics", "[1, 2]")
    got = _infs(tops.CheckStragglerOperator(port).infer([]))
    assert got == _infs(rops.CheckStragglerOperator(ref).infer([]))


def test_chain_and_coordinator_match_the_reference(clock):
    class Boom(tinf.InferenceOperator):
        def is_compatible(self, inference):
            return True

        def infer(self, inferences):
            raise RuntimeError("boom")

    conclusions = [("training_hang", "hang", {"node_id": "1",
                                              "reason": "stalled"}),
                   ("node_failure", "failed", {"node_id": "2"}),
                   ("node_failure", "healthy", {"node_id": "3"}),
                   ("training_hang", "hang", {"node_id": "-1"})]
    got = tinf.coordinate_solutions(
        [tinf.Inference(*c) for c in conclusions])
    want = rinf.coordinate_solutions(
        [rinf.Inference(*c) for c in conclusions])
    assert _acts(got) == _acts(want) and sorted(got) == [-1, 1, 2]
    dm = tdata.DiagnosisDataManager()
    dm.store_data(4, "failure", "hardware fault")
    chain = tinf.InferenceChain([Boom(), tops.CheckFailureNodeOperator(dm)])
    out = chain.infer([tinf.Inference(tinf.InferenceName.NODE_FAILURE)])
    assert _infs(out)[0][:2] == ("node_failure", "failed")


def _managers(**kw):
    return (tman.DiagnosisManager(tspeed.SpeedMonitor(), **kw),
            rman.DiagnosisManager(rspeed.SpeedMonitor(), **kw))


def test_manager_failure_to_relaunch_matches_the_reference(clock):
    port, ref = _managers()
    port.report_failure(m.NodeFailure(node_id=4, error_data="ICI link down"))
    ref.report_failure(R.NodeFailure(node_id=4, error_data="ICI link down"))
    port.collect_data(m.DiagnosisReport(node_id=1, data_type="failure",
                                        content="KeyError", timestamp=T0))
    ref.collect_data(R.DiagnosisReport(node_id=1, data_type="failure",
                                       content="KeyError", timestamp=T0))
    for _ in range(2):  # a second pass queues nothing new
        assert _acts(port.diagnose_once()) == _acts(ref.diagnose_once())
    got = port.pop_actions(4)
    assert _acts(got) == _acts(ref.pop_actions(4))
    assert [a.action_type for a in got] == ["relaunch_worker"]
    assert port.pop_actions(4) == [] == ref.pop_actions(4)
    assert port.pop_actions(1) == [] == ref.pop_actions(1)
    # Within the cooldown (the data TTL) the still-stored record does not
    # act again.
    clock.now += 100
    port.diagnose_once(), ref.diagnose_once()
    assert port.pop_actions(4) == [] == ref.pop_actions(4)


def test_broadcast_fanout_redelivery_expiry_and_privacy(clock):
    port, ref = _managers()
    for mgr in (port, ref):
        assert mgr.enqueue_broadcast("restart_worker", "peer 2 failed",
                                     [0, 1]) == 2
        assert mgr.enqueue_broadcast("restart_worker", "peer 2 failed",
                                     [0]) == 0  # already pending
    a0, a1 = port.pop_actions(0), port.pop_actions(1)
    assert _acts(a0) == _acts(ref.pop_actions(0))
    assert _acts(a1) == _acts(ref.pop_actions(1))
    assert a0[0] is not a1[0] and "delivered" not in a0[0].payload
    assert port.pop_actions(5) == [] == ref.pop_actions(5)  # a later joiner
    for mgr in (port, ref):  # the same incident again after delivery
        assert mgr.enqueue_broadcast("restart_worker", "peer 2 failed",
                                     [0]) == 1
    clock.now += port.BROADCAST_TTL_S + 1
    assert port.pop_actions(0) == [] == ref.pop_actions(0)  # stale
    for mgr in (port, ref):  # an expired entry does not mask a new one
        mgr.enqueue_broadcast("restart_worker", "old", [3])
    clock.now += port.BROADCAST_TTL_S + 1
    for mgr in (port, ref):
        assert mgr.enqueue_broadcast("restart_worker", "old", [3]) == 1
    assert _acts(port.pop_actions(3)) == _acts(ref.pop_actions(3))


def test_whole_job_hang_fans_out_with_a_cooldown(clock):
    alive = []
    port, ref = _managers(hang_timeout_s=50.0, alive_nodes_fn=lambda: alive)
    for mgr in (port, ref):
        mgr.speed_monitor.collect_global_step(10, timestamp=T0 - 100)
    assert _acts(port.diagnose_once()) == _acts(ref.diagnose_once())
    assert port.pop_actions(0) == [] == ref.pop_actions(0)  # none alive
    alive[:] = [0, 1]
    assert _acts(port.diagnose_once()) == _acts(ref.diagnose_once())
    for nid in (0, 1):
        got = port.pop_actions(nid)
        assert _acts(got) == _acts(ref.pop_actions(nid))
        assert [a.action_type for a in got] == ["restart_worker"]
    assert port.pop_actions(9) == [] == ref.pop_actions(9)
    port.diagnose_once(), ref.diagnose_once()  # inside the cooldown
    assert port.pop_actions(0) == [] == ref.pop_actions(0)


def test_hanging_detector_matches_the_reference(clock, monkeypatch,
                                               tmp_path):
    """The agent-side detector: the compile grace before the first step,
    a stall after it, progress from a heartbeat file's mtime."""
    from dlrover_tpu.diagnosis import agent as ragent
    from dlrover_tpu_torch.diagnosis import agent as tagent

    for mod in (tagent, ragent):
        monkeypatch.setattr(mod, "time", clock)
    hb = tmp_path / "hb"
    dets = {name: mod.HangingDetector(hang_timeout_s=100,
                                      compile_grace_s=300,
                                      heartbeat_file=str(hb))
            for name, mod in (("port", tagent), ("ref", ragent))}
    seen = []
    for dt, step, touch in [(50, None, False), (200, None, False),
                            (100, None, False), (10, 1, False),
                            (90, None, False), (20, None, False),
                            (10, None, True), (150, 2, False),
                            (120, None, False)]:
        clock.now += dt
        if touch:
            hb.write_text("x")
            os.utime(hb, (clock.now, clock.now))
        for d in dets.values():
            if step is not None:
                d.record_step(step)
        seen.append(tuple(d.is_hanging() for d in dets.values()))
    assert all(a == b for a, b in seen), seen
    assert [a for a, _ in seen] == [False, False, True, False, False, True,
                                    False, False, True]


# -- end to end: a hang restarts an agent's worker ----------------------------

_WORKER = r"""
import os, sys, time
marker = sys.argv[1]
if os.path.exists(marker):
    sys.exit(0)
open(marker, "w").close()
time.sleep(600)
"""


def test_global_hang_restarts_the_agents_stopped_worker(tmp_path,
                                                        monkeypatch):
    from dlrover_tpu_torch.agent import training as T
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import LocalJobMaster

    sock = tempfile.mkdtemp(prefix="dlsock")
    monkeypatch.setenv("DLROVER_TPU_SOCK_DIR", sock)
    monkeypatch.setattr(port_mp, "_SOCK_DIR", sock)
    ctx = get_context()
    monkeypatch.setattr(ctx, "node_heartbeat_interval", 0.2)
    master = LocalJobMaster(0, job_name=f"hang{os.getpid()}")
    master.prepare()
    marker = tmp_path / "started"
    agent = T.ElasticTrainingAgent(
        T.ElasticLaunchConfig(monitor_interval=0.2,
                              job_name=master.job_name),
        [sys.executable, "-c", _WORKER, str(marker)], master.addr)
    box = {}
    thread = threading.Thread(target=lambda: box.update(rc=agent.run()))
    thread.start()
    client = MasterClient(master.addr, 7)
    first = None
    try:
        deadline = time.time() + 60
        while not (marker.exists() and agent._workers):
            assert time.time() < deadline and thread.is_alive()
            time.sleep(0.05)
        first = agent._workers[0].proc
        os.kill(first.pid, signal.SIGSTOP)  # the worker hangs
        client.report_global_step(5, timestamp=time.time() - 4000)
        t0 = time.monotonic()
        actions = master.diagnosis_manager.diagnose_once()
        assert [a.action_type for a in actions[-1]] == ["restart_worker"]
        thread.join(timeout=60)
        assert box.get("rc") == 0
        assert first.returncode in (-signal.SIGTERM, -signal.SIGKILL)
        assert time.monotonic() - t0 < 30
    finally:
        if first is not None and first.poll() is None:
            first.kill()
        client.close()
        thread.join(timeout=30)
        master.request_stop(True, "test")
        master.stop()
        shutil.rmtree(sock, ignore_errors=True)
