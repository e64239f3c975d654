"""Master HA in the port (``dlrover_tpu_torch/master/{state,standby,
statecheck}.py``, the journal hooks of the managers, the master client's
failover and the launcher's ``--standby`` supervision) against the
reference's (``dlrover_tpu/master/...``), in the classes of the reference's
``tests/test_ha.py``.

Parity: one sequence of manager calls, journaled by both packages with
fsync off, gives byte-equal WAL and snapshot files.  The records carry a
wall time, so the ``time`` attribute of both ``master/state.py`` modules is
replaced by a stepped clock object (never the global ``time`` module,
which other threads of the test process share).  Each package reads,
replays and checks the other's directory.

Discipline (these run in parallel under ``pytest -n 6 --dist loadfile``):
no fixed sleep synchronises anything: a lease expires by stepping the
standby module's clock, and a wait polls a condition under a 30 s deadline;
ports are bound as port 0; every master, standby, tail and thread a test
starts is stopped in a ``finally``; every child runs in a session of its
own with ``OMP_NUM_THREADS=1`` and is reaped.
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import pytest
import torch

from dlrover_tpu.common import messages as RM
from dlrover_tpu.master import dataset_splitter as rsplit
from dlrover_tpu.master import kv_store as rkv
from dlrover_tpu.master import node_manager as rnode
from dlrover_tpu.master import rendezvous as rrdzv
from dlrover_tpu.master import speed_monitor as rspeed
from dlrover_tpu.master import state as rstate
from dlrover_tpu.master import statecheck as rcheck
from dlrover_tpu.master import sync_service as rsync
from dlrover_tpu.master import task_manager as rtask
from dlrover_tpu_torch import run as trun
from dlrover_tpu_torch.agent import master_client as tmc
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.rpc import RpcClient, RpcServer
from dlrover_tpu_torch.master import dataset_splitter as tsplit
from dlrover_tpu_torch.master import kv_store as tkv
from dlrover_tpu_torch.master import node_manager as tnode
from dlrover_tpu_torch.master import rendezvous as trdzv
from dlrover_tpu_torch.master import speed_monitor as tspeed
from dlrover_tpu_torch.master import standby as tstandby
from dlrover_tpu_torch.master import state as tstate
from dlrover_tpu_torch.master import statecheck as tcheck
from dlrover_tpu_torch.master import sync_service as tsync
from dlrover_tpu_torch.master import task_manager as ttask
from dlrover_tpu_torch.master.master import LocalJobMaster
from dlrover_tpu_torch.master.standby import RpcJournalSource, StandbyMaster
from dlrover_tpu_torch.master.state import (
    ControlStateJournal,
    JournalTail,
    read_addr,
    read_lease,
    read_state_dir,
    recover_into,
    write_addr,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 30.0
TRAINING = RendezvousName.TRAINING


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_append_floor(monkeypatch):
    # The reference's journal reads a modelled write floor from the env.
    monkeypatch.delenv("DLROVER_TPU_JOURNAL_APPEND_FLOOR_MS", raising=False)


class Clock:
    """A stand-in for a module's ``time``: it reads ``now`` and moves on
    by ``step`` at every read; ``advance`` moves it by hand."""

    def __init__(self, start: float = 1.7e9, step: float = 0.0):
        self.now = start
        self.step = step

    def _read(self) -> float:
        self.now += self.step
        return self.now

    time = monotonic = perf_counter = _read

    def advance(self, seconds: float) -> None:
        self.now += seconds

    def sleep(self, seconds: float) -> None:
        self.now += seconds


def wait_for(cond, what: str, timeout: float = DEADLINE_S):
    deadline = time.monotonic() + timeout
    while True:
        got = cond()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"gave up after {timeout:.0f} s waiting "
                                 f"for {what}")
        time.sleep(0.02)


# -- the two packages' manager sets ---------------------------------------------

PKG = {
    "port": types.SimpleNamespace(
        state=tstate, kv=tkv, task=ttask, rdzv=trdzv, node=tnode,
        speed=tspeed, sync=tsync, split=tsplit, msgs=m, check=tcheck),
    "ref": types.SimpleNamespace(
        state=rstate, kv=rkv, task=rtask, rdzv=rrdzv, node=rnode,
        speed=rspeed, sync=rsync, split=rsplit, msgs=RM, check=rcheck),
}


def managers(pkg):
    """The port's manager set (the reference's without reshard and cell)."""
    return pkg.state.MasterState(
        kv_store=pkg.kv.KVStoreService(), task_manager=pkg.task.TaskManager(),
        rdzv_managers={
            TRAINING: pkg.rdzv.ElasticTrainingRendezvousManager(),
            RendezvousName.NETWORK_CHECK:
                pkg.rdzv.NetworkCheckRendezvousManager()},
        job_manager=pkg.node.LocalJobManager(),
        speed_monitor=pkg.speed.SpeedMonitor(),
        sync_service=pkg.sync.SyncService())


PARAMS = dict(dataset_name="ds", dataset_size=50, shard_size=10,
              num_epochs=1, shuffle=False, storage_type="table")


def drive_a(st, pkg):
    """A call of every journaled mutation of every ported manager
    (untokened grants: the reference cannot snapshot a tokened one)."""
    kv, tm = st.kv_store, st.task_manager
    kv.set("boot/k", b"v0")
    assert kv.add("ctr", 3, token="t-add") == 3
    assert kv.add("ctr", 3, token="t-add") == 3  # a retry: no record
    kv.multi_set({"a": b"1", "zz/b": b"22"})
    assert kv.delete("a", token="t-del")
    kv.clear("zz/")
    tm.new_dataset(pkg.split.new_dataset_splitter(**PARAMS), params=PARAMS)
    g0, _ = tm.get_task("ds", 0), tm.get_task("ds", 1)
    tm.report_task_result("ds", g0[0], True)
    assert tm.recover_worker_tasks(1) == 1
    assert tm.restore_dataset("ds", tm.checkpoint_dataset("ds"))
    rdzv = st.rdzv_managers[TRAINING]
    rdzv.update_rdzv_params(2, 2)
    rdzv.join(0, 0, 1, host="h0", coordinator_port=9000, attempt_id="a0")
    rdzv.join(1, 1, 1, host="h1", coordinator_port=9001, attempt_id="a1")
    assert len(rdzv.get_comm_world(0)[2]) == 2
    rdzv.sync_ckpt_nodes(0, 2)
    check = st.rdzv_managers[RendezvousName.NETWORK_CHECK]
    check.join(3, 0, 1, host="h3", attempt_id="c3")
    check.remove_alive_node(3)
    st.job_manager.register_node_meta(pkg.msgs.NodeMeta(
        node_type="worker", node_id=0, node_rank=0, host="h0",
        agent_port=9000, local_world_size=1))
    st.job_manager.update_node_status(0, "worker", "succeeded")
    st.speed_monitor.collect_global_step(17, 123.0)
    ss = st.sync_service
    ss.set_world([0, 1])
    ss.join_sync("fence", 0)
    ss.finish_sync("forced")
    ss.join_sync("gone", 1)
    ss.remove_sync("gone")


def drive_b(st, pkg):
    st.kv_store.set("after", b"x")
    assert st.task_manager.get_task("ds", 2, token="tok-b") is not None


def journaled(pkg, state_dir, monkeypatch, calls=(drive_a,),
              snapshot=False):
    """``state_dir`` journaled by ``pkg`` for ``calls`` under a stepped
    clock; the manager set (its journal closed)."""
    monkeypatch.setattr(pkg.state, "time", Clock(step=0.25))
    st = managers(pkg)
    j = pkg.state.ControlStateJournal(str(state_dir), fsync=False,
                                      snapshot_every=10_000)
    st.bind(j)
    for call in calls:
        call(st, pkg)
    if snapshot:
        j.snapshot(st.capture)
    j.close()
    return st


def files(state_dir):
    return {n: (state_dir / n).read_bytes()
            for n in ("wal.log", "snap.bin") if (state_dir / n).exists()}


# -- parity: the journal's bytes, read both ways ----------------------------------

class TestJournalBytes:
    def test_wal_and_snapshot_bytes_equal_the_references(self, tmp_path,
                                                         monkeypatch):
        dirs = {k: tmp_path / k for k in PKG}
        walls = {}
        for k, pkg in PKG.items():
            monkeypatch.setattr(pkg.state, "time", Clock(step=0.25))
            st = managers(pkg)
            j = pkg.state.ControlStateJournal(str(dirs[k]), fsync=False,
                                              snapshot_every=10_000)
            st.bind(j)
            drive_a(st, pkg)
            walls[k] = (dirs[k] / "wal.log").read_bytes()
            j.snapshot(st.capture)
            drive_b(st, pkg)
            j.close()
        assert walls["port"] == walls["ref"]
        got, want = files(dirs["port"]), files(dirs["ref"])
        assert set(got) == {"wal.log", "snap.bin"}
        assert got == want
        kinds = {r["k"] for r in rstate.read_state_dir(
            str(dirs["ref"])).records}
        assert kinds == {"kv.set", "task.grant"}

    @pytest.mark.parametrize("writer,reader", [("port", "ref"),
                                               ("ref", "port")])
    def test_each_package_reads_replays_and_checks_the_others_dir(
            self, tmp_path, monkeypatch, writer, reader):
        wpkg, rpkg = PKG[writer], PKG[reader]
        d = tmp_path / writer
        src = journaled(wpkg, d, monkeypatch, snapshot=True,
                        calls=(drive_a,))
        extra = wpkg.state.ControlStateJournal(str(d), fsync=False)
        src.bind(extra)
        src.kv_store.set("tail/k", b"in the wal")
        extra.close()
        ours, theirs = (rpkg.state.read_state_dir(str(d)),
                        wpkg.state.read_state_dir(str(d)))
        assert ours.records == theirs.records
        assert ours.snapshot == theirs.snapshot
        assert (ours.snap_seq, ours.torn_tail_bytes) == (
            theirs.snap_seq, 0)
        fresh = managers(rpkg)
        _, divs = rpkg.state.recover_into(fresh, ours)
        assert divs == []
        assert fresh.capture() == src.capture()
        report = rpkg.check.check_state_dir(str(d))
        assert report["clean"], report["damage"]
        mine = wpkg.check.check_state_dir(str(d))
        for key in ("records", "snapshot_seq", "kinds", "generations",
                    "last_seq", "torn_tail_bytes"):
            assert report[key] == mine[key], key

    @pytest.mark.parametrize("writer", list(PKG))
    def test_a_torn_tail_is_truncated_in_both_packages(self, tmp_path,
                                                       monkeypatch, writer):
        d = tmp_path / "w"
        journaled(PKG[writer], d, monkeypatch)
        wal = d / "wal.log"
        whole = wal.read_bytes()
        last = PKG[writer].state.read_state_dir(str(d)).records[-1]
        wal.write_bytes(whole[:-7])  # the last frame, cut short
        for k, pkg in PKG.items():
            c = pkg.state.read_state_dir(str(d))
            assert c.torn_tail_bytes > 0 and not c.damage
            assert c.records[-1]["s"] == last["s"] - 1
            copy = tmp_path / f"reopen-{k}"
            shutil.copytree(d, copy)
            j = pkg.state.ControlStateJournal(str(copy), fsync=False)
            assert j.generation == 2
            j.close()
            again = pkg.state.read_state_dir(str(copy))
            assert again.torn_tail_bytes == 0
            assert [r["k"] for r in again.records][-2:] == ["sync.join",
                                                            "ha.owner"]
            assert pkg.check.check_state_dir(str(copy))["clean"]
        assert (tmp_path / "reopen-port" / "wal.log").stat().st_size == \
            (tmp_path / "reopen-ref" / "wal.log").stat().st_size


# -- framing and recovery ---------------------------------------------------------

class TestJournalFraming:
    def test_append_read_roundtrip(self, tmp_path):
        j = ControlStateJournal(str(tmp_path), fsync=False,
                                snapshot_every=10_000)
        for i in range(5):
            j.append("kv.set", {"key": f"k{i}", "value": b"v" * i})
        j.close()
        contents = read_state_dir(str(tmp_path))
        assert [r["k"] for r in contents.records] == \
            ["ha.owner"] + ["kv.set"] * 5
        seqs = [r["s"] for r in contents.records]
        assert seqs == sorted(set(seqs))
        assert contents.records[-1]["d"]["value"] == b"v" * 4
        assert not contents.damage and contents.torn_tail_bytes == 0
        assert j.appends == 6 and j.append_bytes == \
            os.path.getsize(tmp_path / "wal.log") - 8

    def test_torn_tail_truncated_on_reopen(self, tmp_path):
        j = ControlStateJournal(str(tmp_path), fsync=False)
        j.append("kv.set", {"key": "good", "value": b"x"})
        j.close()
        with open(tmp_path / "wal.log", "ab") as f:
            f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefhalf a frame")
        contents = read_state_dir(str(tmp_path))
        assert contents.torn_tail_bytes > 0
        assert [r["k"] for r in contents.records] == ["ha.owner", "kv.set"]
        j2 = ControlStateJournal(str(tmp_path), fsync=False)
        assert j2.generation == 2
        j2.append("kv.set", {"key": "after", "value": b"y"})
        j2.close()
        again = read_state_dir(str(tmp_path))
        assert again.torn_tail_bytes == 0
        assert [r["k"] for r in again.records] == [
            "ha.owner", "kv.set", "ha.owner", "kv.set"]

    def test_mid_file_corruption_is_damage(self, tmp_path):
        j = ControlStateJournal(str(tmp_path), fsync=False)
        j.append("kv.set", {"key": "a", "value": b"1"})
        j.append("kv.set", {"key": "b", "value": b"2"})
        j.close()
        blob = bytearray((tmp_path / "wal.log").read_bytes())
        blob[20] ^= 0xFF  # inside the first frame
        (tmp_path / "wal.log").write_bytes(bytes(blob))
        report = tcheck.check_state_dir(str(tmp_path))
        assert report["records"] < 3 and not report["clean"]

    def test_a_crash_mid_append_loses_exactly_the_unacked_record(
            self, tmp_path):
        """The chaos site that crashes inside an append belongs to the
        chaos layer; the torn half-frame it leaves is made here by
        cutting the WAL inside its last frame."""
        j = ControlStateJournal(str(tmp_path), fsync=True)
        j.append("node.status", {"node_id": 1, "status": "running"})
        before = os.path.getsize(tmp_path / "wal.log")
        j.append("kv.set", {"key": "doomed", "value": b"x"})
        j.close()
        after = os.path.getsize(tmp_path / "wal.log")
        with open(tmp_path / "wal.log", "r+b") as f:
            f.truncate(before + (after - before) // 2)
        contents = read_state_dir(str(tmp_path))
        assert contents.torn_tail_bytes == (after - before) // 2
        assert [r["k"] for r in contents.records] == ["ha.owner",
                                                      "node.status"]
        assert tcheck.check_state_dir(str(tmp_path))["clean"]
        ControlStateJournal(str(tmp_path)).close()
        assert os.path.getsize(tmp_path / "wal.log") > before
        assert read_state_dir(str(tmp_path)).torn_tail_bytes == 0


class TestSnapshotCompaction:
    def _journal_with_state(self, tmp_path):
        state = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False,
                                snapshot_every=10_000)
        state.bind(j)
        state.kv_store.set("k", b"v")
        for i in range(8):
            state.kv_store.add("ctr", 1, token=f"t{i}")
        return state, j

    def test_snapshot_compacts_wal_and_recovers(self, tmp_path):
        state, j = self._journal_with_state(tmp_path)
        size_before = os.path.getsize(tmp_path / "wal.log")
        assert j.snapshot(state.capture) == j.seq
        assert os.path.getsize(tmp_path / "wal.log") < size_before
        state.kv_store.set("k2", b"v2")
        j.close()
        contents = read_state_dir(str(tmp_path))
        assert contents.snapshot is not None
        assert [r["k"] for r in contents.records] == ["kv.set"]
        fresh = tcheck._fresh_state()
        recover_into(fresh, contents)
        assert fresh.kv_store.get("k") == b"v"
        assert fresh.kv_store.get("k2") == b"v2"
        assert fresh.kv_store.get("ctr") == b"8"

    def test_overlapping_replay_is_idempotent(self, tmp_path):
        state, j = self._journal_with_state(tmp_path)
        snap = state.capture()
        j.close()
        fresh = tcheck._fresh_state()
        fresh.restore(snap)
        assert fresh.replay(read_state_dir(str(tmp_path)).records) == []
        assert fresh.kv_store.get("ctr") == b"8"

    def test_snapshot_due_thresholds(self, tmp_path):
        state = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False,
                                snapshot_every=5)
        state.bind(j)
        assert not j.snapshot_due()
        for i in range(5):
            state.kv_store.set(f"k{i}", b"v")
        assert j.snapshot_due()
        assert j.maybe_snapshot(state.capture)
        assert not j.snapshot_due()
        j.close()

    def test_a_tokened_grant_snapshots_and_replays(self, tmp_path):
        """The retried-fetch cache holds ``(task_id, Shard, epoch)``: the
        reference's msgpack refuses the ``Shard`` (ROADMAP Queue C), the
        port's snapshot carries it as plain data and restores the tuple,
        so that a fetch retried across a failover gets its first task."""
        for pkg in PKG.values():
            st = managers(pkg)
            st.task_manager.new_dataset(
                pkg.split.new_dataset_splitter(**PARAMS), params=PARAMS)
            st.task_manager.get_task("ds", 0, token="tok")
            d = tmp_path / pkg.state.__name__
            j = pkg.state.ControlStateJournal(str(d), fsync=False)
            if pkg is PKG["ref"]:
                with pytest.raises(TypeError, match="Shard"):
                    j.snapshot(st.capture)
                j.close()
                continue
            j.snapshot(st.capture)
            j.close()
            fresh = managers(pkg)
            recover_into(fresh, read_state_dir(str(d)))
            first = st.task_manager.get_task("ds", 0, token="tok")
            assert fresh.task_manager.get_task("ds", 0, token="tok") == first
            assert fresh.capture() == st.capture()
            assert tcheck.check_state_dir(str(d))["clean"]


class TestJournalTail:
    def test_gap_detected_when_compaction_outran_tail(self, tmp_path):
        state = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        state.bind(j)
        tail = JournalTail(str(tmp_path))
        try:
            state.kv_store.set("a", b"1")
            tail.poll()
            assert not tail.gap
            state.kv_store.set("lost-from-wal", b"2")
            j.snapshot(state.capture)
            state.kv_store.set("c", b"3")
            recs = tail.poll()
            assert [r["d"]["key"] for r in recs if r["k"] == "kv.set"] == \
                ["c"]
            assert tail.gap
        finally:
            tail.close()
            j.close()

    def test_standby_rebootstrap_recovers_gap_records(self, tmp_path):
        master = _mk_primary(tmp_path)
        client = MasterClient(master.addr, 0)
        sb = None
        try:
            sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                               lease_s=30.0, tail_poll_s=5.0)
            client.kv_store_set("gap/key", b"in-snapshot-only")
            master._ha_journal.snapshot(master._ha_state.capture)
            client.kv_store_set("tail/key", b"post-compaction")
            sb._tail.poll()
            assert sb._tail.gap
            sb.rebootstrap()
            assert not sb._tail.gap
            assert sb.state.kv_store.get("gap/key") == b"in-snapshot-only"
            assert sb.state.kv_store.get("tail/key") == b"post-compaction"
        finally:
            if sb is not None:
                sb.stop()
            client.close()
            master.stop()

    def test_incremental_poll_and_compaction_survival(self, tmp_path):
        state = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        state.bind(j)
        tail = JournalTail(str(tmp_path))
        try:
            state.kv_store.set("a", b"1")
            assert [r["k"] for r in tail.poll()] == ["ha.owner", "kv.set"]
            assert tail.poll() == []
            state.kv_store.set("b", b"2")
            assert [r["d"]["key"] for r in tail.poll()] == ["b"]
            j.snapshot(state.capture)
            state.kv_store.set("c", b"3")
            assert [r["d"]["key"] for r in tail.poll()
                    if r["k"] == "kv.set"] == ["c"]
        finally:
            tail.close()
            j.close()


# -- replay: every record kind a ported manager writes -----------------------------

def _requeue(st):
    tm = st.task_manager
    tm.new_dataset(tsplit.new_dataset_splitter(**PARAMS), params=PARAMS)
    got = tm.get_task("ds", 0)
    tm._datasets["ds"]._doing[got[0]].start_time -= 1e6
    assert tm.reassign_once() == {"ds": [got[0]]}


KIND_DRIVERS = {
    "kv.set": lambda st: st.kv_store.set("k", b"v"),
    "kv.multi_set": lambda st: st.kv_store.multi_set({"a": b"1"}),
    "kv.add": lambda st: st.kv_store.add("n", 2, token="t"),
    "kv.delete": lambda st: (st.kv_store.set("d", b"1"),
                             st.kv_store.delete("d", token="t")),
    "kv.clear": lambda st: (st.kv_store.set("p/x", b"1"),
                            st.kv_store.clear("p/")),
    "task.dataset": lambda st: st.task_manager.new_dataset(
        tsplit.new_dataset_splitter(**PARAMS), params=PARAMS),
    "task.grant": lambda st: (KIND_DRIVERS["task.dataset"](st),
                              st.task_manager.get_task("ds", 0, token="g")),
    "task.report": lambda st: (KIND_DRIVERS["task.dataset"](st),
                               st.task_manager.report_task_result(
                                   "ds", st.task_manager.get_task(
                                       "ds", 0)[0], False)),
    "task.recover": lambda st: (KIND_DRIVERS["task.dataset"](st),
                                st.task_manager.get_task("ds", 4),
                                st.task_manager.recover_worker_tasks(4)),
    "task.requeue": _requeue,
    "task.restore": lambda st: (KIND_DRIVERS["task.dataset"](st),
                                st.task_manager.get_task("ds", 0),
                                st.task_manager.restore_dataset(
                                    "ds", st.task_manager.checkpoint_dataset(
                                        "ds"))),
    "rdzv.join": lambda st: st.rdzv_managers[TRAINING].join(
        5, 0, 2, host="h5", attempt_id="x"),
    "rdzv.remove": lambda st: (KIND_DRIVERS["rdzv.join"](st),
                               st.rdzv_managers[TRAINING].remove_alive_node(
                                   5)),
    "rdzv.world": lambda st: (KIND_DRIVERS["rdzv.join"](st),
                              st.rdzv_managers[TRAINING].get_comm_world(5)),
    "rdzv.ckpt_vote": lambda st: st.rdzv_managers[TRAINING].sync_ckpt_nodes(
        5, 3),
    "node.meta": lambda st: st.job_manager.register_node_meta(m.NodeMeta(
        node_id=3, node_rank=3, host="h3", agent_port=9003)),
    "node.status": lambda st: st.job_manager.update_node_status(
        3, "worker", "failed", "oom"),
    "speed.step": lambda st: st.speed_monitor.collect_global_step(17, 123.0),
    "sync.world": lambda st: st.sync_service.set_world([0, 1]),
    "sync.join": lambda st: st.sync_service.join_sync("s", 0),
    "sync.finished": lambda st: st.sync_service.finish_sync("s"),
    "sync.remove": lambda st: (st.sync_service.join_sync("s", 0),
                               st.sync_service.remove_sync("s")),
}


class TestReplay:
    @pytest.mark.parametrize("kind", sorted(KIND_DRIVERS))
    def test_every_record_kind_replays_to_the_same_state(self, tmp_path,
                                                         kind):
        st = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        st.bind(j)
        KIND_DRIVERS[kind](st)
        j.close()
        records = read_state_dir(str(tmp_path)).records
        assert kind in {r["k"] for r in records}
        fresh = tcheck._fresh_state()
        assert fresh.replay(records) == []
        assert tcheck._canon(fresh.capture()) == tcheck._canon(st.capture())
        # The reference replays the port's records to the same state.
        ref = managers(PKG["ref"])
        assert ref.replay(rstate.read_state_dir(str(tmp_path)).records) \
            == []
        if kind != "task.grant":  # the reference keeps the Shard object
            assert tcheck._canon(ref.capture()) == \
                tcheck._canon(st.capture())

    def test_rendezvous_world_replays_as_state(self, tmp_path):
        st = tcheck._fresh_state()
        mgr = st.rdzv_managers[TRAINING]
        mgr.update_rdzv_params(2, 2, waiting_timeout=0.01)
        j = ControlStateJournal(str(tmp_path), fsync=False)
        st.bind(j)
        mgr.join(0, 0, 2, host="h0", coordinator_port=9000)
        mgr.join(1, 1, 2, host="h1", coordinator_port=9001)
        round_, _, world, coord = mgr.get_comm_world(0)
        assert len(world) == 2 and coord
        j.close()
        fresh = tcheck._fresh_state()
        assert not fresh.replay(read_state_dir(str(tmp_path)).records)
        fmgr = fresh.rdzv_managers[TRAINING]
        r2, _, w2, c2 = fmgr.get_comm_world(0)
        assert (r2, w2, c2) == (round_, world, coord)
        assert fmgr.current_world_nodes() == mgr.current_world_nodes()

    def test_task_grant_divergence_is_reported(self, tmp_path):
        st = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        st.bind(j)
        params = dict(dataset_name="d", dataset_size=30, shard_size=10)
        st.task_manager.new_dataset(tsplit.new_dataset_splitter(**params),
                                    params=params)
        st.task_manager.get_task("d", 0, token="tok-a")
        j.close()
        records = read_state_dir(str(tmp_path)).records
        for rec in records:
            if rec["k"] == "task.grant":
                rec["d"]["task_id"] = 7
        divs = tcheck._fresh_state().replay(records)
        assert any("journal promised 7" in d for d in divs)

    def test_node_membership_and_speed_replay(self, tmp_path):
        st = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        st.bind(j)
        st.job_manager.register_node_meta(m.NodeMeta(
            node_type="worker", node_id=3, node_rank=3, host="h3",
            agent_port=9003, local_world_size=4))
        st.speed_monitor.collect_global_step(17, 123.0)
        st.speed_monitor.collect_global_step(18, 124.0)  # throttled
        j.close()
        records = read_state_dir(str(tmp_path)).records
        assert [r["k"] for r in records].count("speed.step") == 1
        fresh = tcheck._fresh_state()
        assert not fresh.replay(records)
        node = fresh.job_manager.get_node(3)
        assert node is not None and node.host == "h3"
        assert fresh.speed_monitor.completed_global_step == 17

    def test_reference_reshard_records_are_divergences(self, tmp_path):
        """The port has no reshard manager yet: a reference journal's
        reshard epoch is reported, not dropped in silence."""
        state = rcheck._fresh_state()
        j = rstate.ControlStateJournal(str(tmp_path), fsync=False)
        state.bind(j)
        state.reshard_manager.announce(4, {"dp": 4}, expected_reports=2,
                                       deadline_s=60.0)
        j.close()
        report = tcheck.check_state_dir(str(tmp_path))
        assert not report["clean"]
        assert any("reshard.announce" in d for d in report["divergences"])


# -- the warm standby, in process -------------------------------------------------

def _mk_primary(state_dir, **kw):
    master = LocalJobMaster(0, job_name="ha-unit", state_dir=str(state_dir),
                            **kw)
    master.prepare()
    return master


def _silence(master):
    """An unclean death: no answers, no lease, and no ``ha.shutdown``."""
    master._server.stop()
    master._ha_keeper.stop()
    master._ha_journal.close()


@pytest.fixture
def standby_clock(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(tstandby, "time", clock)
    return clock


def _expire(sb, clock):
    """Step the standby's clock past its lease, a poll at a time, until it
    takes over (the first poll may still see the last lease bump)."""
    def step():
        clock.advance(2 * sb.lease_s)
        return sb.poll()

    assert wait_for(step, "the takeover") is True


class _OneShot:
    """A mirror's transport: one attempt a fetch, so that a dead primary
    costs no retry budget."""

    def __init__(self, addr: str):
        self.rpc = RpcClient(addr)

    def call(self, msg):
        return self.rpc.call(msg, retries=1, deadline=5.0)


class TestStandbyTakeover:
    def test_state_survives_takeover_exactly_once(self, tmp_path,
                                                  standby_clock):
        master = _mk_primary(tmp_path, min_nodes=2, max_nodes=2)
        client = MasterClient(master.addr, 0)
        sb = c2 = None
        try:
            client.kv_store_set("boot/k", b"v")
            assert client.kv_store_add("ctr", 3) == 3
            client.report_dataset_shard_params(dataset_name="ds",
                                               dataset_size=50,
                                               shard_size=10)
            t0, t1 = client.get_task("ds"), client.get_task("ds")
            client.report_task_result("ds", t0.task_id, True)
            sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                               lease_s=1.0, min_nodes=2, max_nodes=2)
            client.kv_store_set("live/k", b"tailed")
            assert sb.poll() is None  # tails the new record
            assert sb.state.kv_store.get("live/k") == b"tailed"
            _silence(master)
            _expire(sb, standby_clock)
            assert sb.took_over()
            c2 = MasterClient(sb.addr, 0)
            assert c2.kv_store_get("boot/k") == b"v"
            assert c2.kv_store_get("live/k") == b"tailed"
            assert c2.kv_store_get("ctr") == b"3"
            # t1 is doing on the standby: neither lost nor granted again.
            c2.report_task_result("ds", t1.task_id, True)
            granted = set()
            while True:
                t = c2.get_task("ds")
                if t.task_id < 0:
                    break
                granted.add(t.task_id)
                c2.report_task_result("ds", t.task_id, True)
            assert granted == {2, 3, 4}
            assert sb.master.task_manager.dataset_completed("ds")
            assert tcheck.check_state_dir(str(tmp_path))["clean"]
        finally:
            for c in (client, c2):
                if c is not None:
                    c.close()
            if sb is not None:
                sb.stop()
            master.stop()

    def test_standby_holds_while_primary_leases(self, tmp_path,
                                                standby_clock):
        master = _mk_primary(tmp_path)
        master._ha_keeper.stop()  # the test bumps the lease itself
        sb = None
        try:
            sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                               lease_s=1.0)
            for _ in range(6):  # three lease periods, a bump in each half
                master._ha_journal.write_lease()
                standby_clock.advance(0.6)
                assert sb.poll() is None
            assert not sb.took_over()
        finally:
            if sb is not None:
                sb.stop()
            master.stop()

    def test_split_brain_guard_probes_primary(self, tmp_path, standby_clock):
        """The journal is silent but the primary still answers TCP: a
        stalled file system is not a dead primary."""
        master = _mk_primary(tmp_path)
        sb = None
        try:
            master._ha_keeper.stop()
            sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                               lease_s=1.0)
            for _ in range(3):
                standby_clock.advance(5.0)
                assert sb.poll() is None
            assert not sb.took_over()
        finally:
            if sb is not None:
                sb.stop()
            master.stop()

    def test_takeover_publishes_addr_and_next_generation(self, tmp_path,
                                                         monkeypatch):
        """The watch loop itself, on a clock that moves on at each read."""
        monkeypatch.setattr(tstandby, "time", Clock(step=0.5))
        master = _mk_primary(tmp_path)
        primary_addr = master.addr
        assert read_addr(str(tmp_path)) == primary_addr
        sb = StandbyMaster(str(tmp_path), primary_addr=primary_addr,
                           lease_s=1.0, tail_poll_s=0.01)
        watcher = threading.Thread(target=sb.watch, daemon=True)
        watcher.start()
        try:
            _silence(master)
            assert sb.wait_takeover(DEADLINE_S)
            watcher.join(DEADLINE_S)
            assert not watcher.is_alive()
            assert read_addr(str(tmp_path)) == sb.addr != primary_addr
            assert sb.master._ha_journal.generation == 2
            lease0 = read_lease(str(tmp_path))
            wait_for(lambda: read_lease(str(tmp_path)) != lease0,
                     "the new leader's keeper to bump the lease")
            kinds = [r["k"] for r in read_state_dir(str(tmp_path)).records]
            assert kinds.count("ha.owner") == 2 and "ha.takeover" in kinds
        finally:
            sb.stop()
            watcher.join(DEADLINE_S)
            master.stop()

    def test_rpc_mirror_survives_primary_compaction(self, tmp_path):
        primary_dir, mirror_dir = tmp_path / "primary", tmp_path / "mirror"
        master = _mk_primary(primary_dir)
        client = MasterClient(master.addr, 0)
        tail = None
        try:
            client.kv_store_set("a", b"1")
            source = RpcJournalSource(client._client, str(mirror_dir))
            source.sync()
            tail = JournalTail(str(mirror_dir))
            assert any(r["k"] == "kv.set" for r in tail.poll())
            master._ha_journal.snapshot(master._ha_state.capture)
            client.kv_store_set("b", b"2")
            assert source.sync() > 0
            assert [r["d"]["key"] for r in tail.poll()
                    if r["k"] == "kv.set"] == ["b"]
            contents = read_state_dir(str(mirror_dir))
            assert contents.snapshot is not None
            fresh = tcheck._fresh_state()
            recover_into(fresh, contents)
            assert fresh.kv_store.get("a") == b"1"
            assert fresh.kv_store.get("b") == b"2"
        finally:
            if tail is not None:
                tail.close()
            client.close()
            master.stop()

    def test_clean_primary_shutdown_stands_down(self, tmp_path):
        master = _mk_primary(tmp_path)
        sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                           lease_s=30.0, tail_poll_s=0.01)
        done = {}
        watcher = threading.Thread(
            target=lambda: done.setdefault("takeover", sb.watch()),
            daemon=True)
        watcher.start()
        try:
            master.request_stop(True, "job finished")
            master.stop()
            watcher.join(DEADLINE_S)
            assert not watcher.is_alive()
            assert done["takeover"] is False and not sb.took_over()
        finally:
            sb.stop()
            watcher.join(DEADLINE_S)
            master.stop()

    def test_standby_started_after_a_clean_shutdown_stands_down(
            self, tmp_path):
        """A launcher may start a fresh standby just as the promoted
        leader ends the job: the finished job is not taken over."""
        master = _mk_primary(tmp_path)
        master.request_stop(True, "job finished")
        master.stop()
        sb = StandbyMaster(str(tmp_path), primary_addr=master.addr,
                           lease_s=0.0)
        try:
            assert sb.poll() is False and sb.watch() is False
            assert not sb.took_over()
            assert read_state_dir(str(tmp_path)).records[-1]["k"] == \
                "ha.shutdown"
        finally:
            sb.stop()

    def test_rpc_journal_source_mirror(self, tmp_path, standby_clock):
        primary_dir, mirror_dir = tmp_path / "primary", tmp_path / "mirror"
        master = _mk_primary(primary_dir)
        client = MasterClient(master.addr, 0)
        transport = _OneShot(master.addr)
        sb = c2 = None
        try:
            client.kv_store_set("mirrored", b"yes")
            source = RpcJournalSource(transport, str(mirror_dir))
            assert source.sync() > 0
            sb = StandbyMaster(str(mirror_dir), primary_addr=master.addr,
                               lease_s=1.0, rpc_source=source)
            client.kv_store_set("mirrored2", b"also")
            assert sb.poll() is None  # one sync pulls the new frame
            assert sb.state.kv_store.get("mirrored2") == b"also"
            _silence(master)
            _expire(sb, standby_clock)
            c2 = MasterClient(sb.addr, 0)
            assert c2.kv_store_get("mirrored") == b"yes"
            assert c2.kv_store_get("mirrored2") == b"also"
        finally:
            transport.rpc.close()
            for c in (client, c2):
                if c is not None:
                    c.close()
            if sb is not None:
                sb.stop()
            master.stop()


# -- the master client's failover, over the port's TCP RPC --------------------------

class TestClientFailover:
    def test_rpc_client_rehomes_via_provider(self):
        served = {"a": 0, "b": 0}

        def handler_for(name):
            def handler(msg):
                served[name] += 1
                return m.BaseResponse(success=True, reason=name)
            return handler

        srv_a, srv_b = RpcServer(0, handler_for("a")), \
            RpcServer(0, handler_for("b"))
        srv_a.start()
        srv_b.start()
        target = {"addr": f"127.0.0.1:{srv_a.port}"}
        cli = RpcClient(target["addr"], addr_provider=lambda: target["addr"])
        try:
            assert cli.call(m.Empty()).reason == "a"
            srv_a.stop()
            target["addr"] = f"127.0.0.1:{srv_b.port}"
            reply = cli.call(m.Empty(), idempotent=True, retries=10,
                             backoff=0.1, deadline=DEADLINE_S)
            assert reply.reason == "b" and cli.addr == target["addr"]
            assert served == {"a": 1, "b": 1}
        finally:
            cli.close()
            srv_a.stop()
            srv_b.stop()

    def test_master_client_follows_state_dir_addr(self, tmp_path):
        master_a = LocalJobMaster(0, job_name="fa")
        master_b = LocalJobMaster(0, job_name="fb")
        master_a.prepare()
        master_b.prepare()
        cli = None
        try:
            write_addr(str(tmp_path), master_a.addr)
            cli = MasterClient(master_a.addr, 0, state_dir=str(tmp_path))
            assert cli.kv_store_get("x") is None
            master_a._server.stop()
            write_addr(str(tmp_path), master_b.addr)
            master_b.kv_store.set("x", b"from-b")
            assert cli.kv_store_get("x") == b"from-b"
            assert cli.master_addr == master_b.addr
        finally:
            if cli is not None:
                cli.close()
            master_a.stop()
            master_b.stop()

    def test_master_client_moves_to_the_standby_addr(self, monkeypatch):
        master_a = LocalJobMaster(0, job_name="fa")
        master_b = LocalJobMaster(0, job_name="fb")
        master_a.prepare()
        master_b.prepare()
        cli = None
        try:
            monkeypatch.setenv("DLROVER_TPU_MASTER_STANDBY_ADDR",
                               master_b.addr)
            monkeypatch.delenv("DLROVER_TPU_MASTER_STATE_DIR",
                               raising=False)
            cli = MasterClient(master_a.addr, 0)  # the env's standby
            master_b.kv_store.set("y", b"from-standby")
            assert cli.kv_store_get("y") is None
            master_a._server.stop()
            assert cli.kv_store_get("y") == b"from-standby"
            assert cli.master_addr == master_b.addr
        finally:
            if cli is not None:
                cli.close()
            master_a.stop()
            master_b.stop()

    def test_journal_fetch_serves_the_wal_and_the_snapshot(self, tmp_path):
        master = _mk_primary(tmp_path)
        cli = MasterClient(master.addr, 0)
        plain = LocalJobMaster(0, job_name="no-journal")
        plain.prepare()
        other = MasterClient(plain.addr, 0)
        try:
            cli.kv_store_set("k", b"v")
            chunk = cli.journal_fetch(0)
            assert chunk.found and chunk.offset == 0
            assert chunk.data == (tmp_path / "wal.log").read_bytes()
            assert chunk.wal_size == len(chunk.data) and chunk.wal_ino
            assert cli.journal_fetch(len(chunk.data)).eof
            assert cli.journal_fetch(-1).data == b""  # no snapshot yet
            master._ha_journal.snapshot(master._ha_state.capture)
            assert cli.journal_fetch(-1).data == \
                (tmp_path / "snap.bin").read_bytes()
            assert other.journal_fetch(0).found is False
        finally:
            cli.close()
            other.close()
            plain.stop()
            master.stop()

    def test_singleton_invalidation_on_env_change(self, monkeypatch):
        tmc.reset_master_client()
        try:
            monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "127.0.0.1:1111")
            c1 = tmc.build_master_client()
            assert c1.master_addr == "127.0.0.1:1111"
            assert tmc.build_master_client() is c1
            monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "127.0.0.1:2222")
            c2 = tmc.build_master_client()
            assert c2 is not c1 and c2.master_addr == "127.0.0.1:2222"
            tmc.invalidate_master_client()
            c3 = tmc.build_master_client()
            assert c3 is not c2 and c3.master_addr == "127.0.0.1:2222"
        finally:
            tmc.reset_master_client()

    def test_explicit_addr_singleton_unchanged(self, monkeypatch):
        tmc.reset_master_client()
        try:
            monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "127.0.0.1:1111")
            c1 = tmc.build_master_client("127.0.0.1:3333")
            monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "127.0.0.1:2222")
            assert tmc.build_master_client("127.0.0.1:3333") is c1
            assert tmc.build_master_client() is c1
            assert c1.master_addr == "127.0.0.1:3333"
        finally:
            tmc.reset_master_client()


# -- statecheck's command line ------------------------------------------------------

def _cli(module, *argv):
    return subprocess.run(
        [sys.executable, "-m", module, *map(str, argv)], cwd=REPO,
        capture_output=True, text=True, timeout=60, start_new_session=True,
        env=dict(os.environ, OMP_NUM_THREADS="1"))


class TestStatecheckCli:
    def _populate(self, tmp_path):
        state = tcheck._fresh_state()
        j = ControlStateJournal(str(tmp_path), fsync=False)
        state.bind(j)
        state.kv_store.set("k", b"v")
        j.close()

    def test_clean_dir_exit_0(self, tmp_path):
        self._populate(tmp_path)
        proc = _cli("dlrover_tpu_torch.master.statecheck", tmp_path, "--json")
        assert proc.returncode == 0, proc.stderr[-2000:]
        report = json.loads(proc.stdout)
        assert report["clean"] and report["records"] == 2

    def test_damaged_dir_exit_1(self, tmp_path):
        self._populate(tmp_path)
        blob = bytearray((tmp_path / "wal.log").read_bytes())
        blob[14] ^= 0xFF
        (tmp_path / "wal.log").write_bytes(bytes(blob))
        proc = _cli("dlrover_tpu_torch.master.statecheck", tmp_path)
        assert proc.returncode == 1 and "DAMAGED" in proc.stdout

    def test_usage_exit_2(self, tmp_path):
        assert tcheck.main([str(tmp_path / "missing")]) == 2
        assert tcheck.main([]) == 2

    @pytest.mark.parametrize("writer,cli", [
        ("port", "dlrover_tpu.master.statecheck"),
        ("ref", "dlrover_tpu_torch.master.statecheck")])
    def test_each_cli_checks_the_others_dir(self, tmp_path, monkeypatch,
                                            writer, cli):
        journaled(PKG[writer], tmp_path, monkeypatch, snapshot=True)
        proc = _cli(cli, tmp_path, "--json")
        assert proc.returncode == 0, proc.stdout[-2000:]
        report = json.loads(proc.stdout)
        assert report["clean"] and report["snapshot"]


# -- restored task clocks ---------------------------------------------------------

class TestRestoreRearm:
    def test_restored_doing_task_not_instantly_reassigned(self,
                                                          monkeypatch):
        clock = Clock()
        monkeypatch.setattr(ttask, "time", clock)
        ds = ttask.DatasetManager(tsplit.TableDatasetSplitter("d", 30, 10),
                                  task_timeout=0.3)
        got = ds.get_task(worker_id=5)
        ds._doing[got[0]].start_time -= 10.0
        ds2 = ttask.DatasetManager(tsplit.TableDatasetSplitter("d", 30, 10),
                                   task_timeout=0.3)
        ds2.restore(ds.checkpoint(), keep_doing=True)
        assert ds2._doing[got[0]].worker_id == 5
        assert ds2.reassign_timeout_tasks() == []
        clock.advance(0.35)
        assert ds2.reassign_timeout_tasks() == [got[0]]

    def test_restart_restore_requeues_doing_immediately(self):
        ds = ttask.DatasetManager(tsplit.TableDatasetSplitter("d", 30, 10))
        got = ds.get_task(worker_id=5)
        ds2 = ttask.DatasetManager(tsplit.TableDatasetSplitter("d", 30, 10))
        ds2.restore(ds.checkpoint())
        assert not ds2._doing
        assert ds2.get_task(worker_id=9)[0] == got[0]

    def test_legacy_checkpoint_without_doing_key(self):
        ds = ttask.DatasetManager(tsplit.TableDatasetSplitter("d", 20, 10))
        ds.restore(json.dumps({
            "dataset_name": "d",
            "todo": [[0, {"name": "d-e1-0", "start": 0, "end": 10,
                          "record_indices": None}]],
            "epoch": 1, "task_id_seq": 2}))
        assert len(ds._todo) == 1 and not ds._doing

    def test_rearm_doing_on_task_manager(self):
        tm = ttask.TaskManager(task_timeout=100.0)
        params = dict(dataset_name="d", dataset_size=20, shard_size=10)
        tm.new_dataset(tsplit.new_dataset_splitter(**params), params=params)
        got = tm.get_task("d", 1, token="t")
        tm._datasets["d"]._doing[got[0]].start_time -= 1e6
        tm.rearm_doing()
        assert time.monotonic() - \
            tm._datasets["d"]._doing[got[0]].start_time < 5.0


# -- the launcher's --standby supervision, with fake processes ------------------------

class _FakeProc:
    _next_pid = 90_000

    def __init__(self, rc=None, on_poll=None):
        self.rc = rc
        self.on_poll = on_poll
        _FakeProc._next_pid += 1
        self.pid = _FakeProc._next_pid

    def poll(self):
        if self.on_poll is not None:
            self.on_poll, hook = None, self.on_poll
            hook()
        return self.rc


def _args():
    import argparse

    return argparse.Namespace(nnodes="1", job_name="ha-sup", node_unit=1)


def _supervise(tmp_path, monkeypatch, primary, standby, max_restarts=3,
               replacement=None):
    spawned = []

    def fake_launch_standby(args, state_dir, primary_addr):
        spawned.append(primary_addr)
        return replacement or _FakeProc(), "127.0.0.1:3000"

    monkeypatch.setattr(trun, "_launch_standby_master", fake_launch_standby)
    primary_holder, standby_holder = [primary], [standby]
    stop = threading.Event()
    thread = trun._supervise_ha_masters(_args(), str(tmp_path),
                                        primary_holder, standby_holder,
                                        stop, max_restarts=max_restarts)
    return spawned, primary_holder, standby_holder, stop, thread


class TestSuperviseHaMasters:
    def test_promote_and_respawn_on_primary_crash(self, tmp_path,
                                                  monkeypatch):
        write_addr(str(tmp_path), "127.0.0.1:1000")  # the dying primary
        # The standby takes over while the supervisor waits for it.
        standby = _FakeProc(on_poll=lambda: write_addr(str(tmp_path),
                                                       "127.0.0.1:2000"))
        replacement = _FakeProc()
        spawned, primary_h, standby_h, stop, thread = _supervise(
            tmp_path, monkeypatch, _FakeProc(rc=-9), standby,
            replacement=replacement)
        try:
            wait_for(lambda: spawned, "a fresh standby")
        finally:
            stop.set()
            thread.join(DEADLINE_S)
        assert not thread.is_alive()
        assert primary_h[0] is standby and standby_h[0] is replacement
        assert spawned == ["127.0.0.1:2000"]

    def test_dead_standby_respawned_while_primary_lives(self, tmp_path,
                                                        monkeypatch):
        write_addr(str(tmp_path), "127.0.0.1:1000")
        spawned, primary_h, standby_h, stop, thread = _supervise(
            tmp_path, monkeypatch, _FakeProc(), _FakeProc(rc=1))
        try:
            wait_for(lambda: spawned, "a respawned standby")
        finally:
            stop.set()
            thread.join(DEADLINE_S)
        assert spawned == ["127.0.0.1:1000"]
        assert standby_h[0].poll() is None

    def test_restart_budget_is_respected(self, tmp_path, monkeypatch):
        write_addr(str(tmp_path), "127.0.0.1:1000")
        spawned, _, _, stop, thread = _supervise(
            tmp_path, monkeypatch, _FakeProc(), _FakeProc(rc=1),
            max_restarts=2, replacement=_FakeProc(rc=1))
        try:
            thread.join(DEADLINE_S)
            assert not thread.is_alive()
        finally:
            stop.set()
            thread.join(DEADLINE_S)
        assert len(spawned) == 2

    @pytest.mark.parametrize("rc,standby_rc", [(0, None), (-9, 1)])
    def test_clean_exit_or_a_lost_standby_ends_supervision(
            self, tmp_path, monkeypatch, rc, standby_rc):
        """A clean exit of the primary ends the job's supervision; a
        primary crash with the standby dead too leaves nothing to
        promote."""
        write_addr(str(tmp_path), "127.0.0.1:1000")
        spawned, primary_h, _, stop, thread = _supervise(
            tmp_path, monkeypatch, _FakeProc(rc=rc), _FakeProc(standby_rc))
        try:
            thread.join(DEADLINE_S)
            assert not thread.is_alive()
        finally:
            stop.set()
            thread.join(DEADLINE_S)
        assert spawned == [] and primary_h[0].rc == rc


# -- the sync barriers across a failover -------------------------------------------

class TestSyncServiceJournal:
    def _recover(self, tmp_path):
        fresh = tcheck._fresh_state()
        recover_into(fresh, read_state_dir(str(tmp_path)))
        return fresh.sync_service

    def _journal(self, tmp_path):
        j = ControlStateJournal(str(tmp_path), fsync=False)
        state = tcheck._fresh_state()
        state.bind(j)
        return state, j

    def test_mid_barrier_joins_survive_failover(self, tmp_path):
        state, j = self._journal(tmp_path)
        state.sync_service.set_world([0, 1])
        state.sync_service.join_sync("ckpt-fence", 0)
        j.close()
        s2 = self._recover(tmp_path)
        assert not s2.sync_finished("ckpt-fence")
        s2.join_sync("ckpt-fence", 1)
        assert s2.sync_finished("ckpt-fence")

    def test_finished_latch_and_force_open_replay(self, tmp_path):
        state, j = self._journal(tmp_path)
        ss = state.sync_service
        ss.set_world([0, 1])
        ss.join_sync("all", 0)
        ss.join_sync("all", 1)
        ss.finish_sync("forced")
        ss.join_sync("gone", 0)
        ss.remove_sync("gone")
        j.close()
        s2 = self._recover(tmp_path)
        assert s2.sync_finished("all") and s2.sync_finished("forced")
        assert not s2.sync_finished("gone")

    def test_snapshot_carries_sync_state(self, tmp_path):
        state, j = self._journal(tmp_path)
        state.sync_service.set_world([3, 4])
        state.sync_service.join_sync("warm", 3)
        j.snapshot(state.capture)
        j.close()
        s2 = self._recover(tmp_path)
        assert not s2.sync_finished("warm")
        s2.join_sync("warm", 4)
        assert s2.sync_finished("warm")

    def test_world_journaled_only_on_change(self, tmp_path):
        state, j = self._journal(tmp_path)
        seq0 = j.seq
        state.sync_service.set_world([0, 1])
        assert j.seq == seq0 + 1
        for _ in range(5):
            state.sync_service.set_world([1, 0])
        assert j.seq == seq0 + 1
        j.close()


def test_dataclass_fields_of_the_journaled_types_are_the_references():
    """``node.meta`` replays as ``NodeMeta(**fields)`` and the rendezvous
    records carry ``NodeTopologyMeta`` fields: both packages' types must
    agree field for field."""
    from dlrover_tpu.master.topology import NodeTopologyMeta as RT
    from dlrover_tpu_torch.master.topology import NodeTopologyMeta as PT

    def names(cls):
        return [f.name for f in dataclasses.fields(cls)]

    assert names(m.NodeMeta) == names(RM.NodeMeta)
    assert names(PT) == names(RT)
