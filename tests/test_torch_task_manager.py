"""Dynamic data sharding in the port (``dlrover_tpu_torch/master/
{dataset_splitter,task_manager}.py``, the servicer's task messages,
``data/sharding.py``) against the reference's
(``dlrover_tpu/master/{dataset_splitter,task_manager}.py``,
``dlrover_tpu/master/servicer.py``):

- each splitter carves the reference's shards (the text splitter's
  shuffle makes the same ``random.Random`` calls);
- one seeded sequence of task-manager calls (new datasets, fetches with
  repeated tokens, results, a dead worker's recovery, the timeout
  reassign under a stepped clock, requeues, restores) gives equal tasks in
  both packages, equal checkpoint strings byte for byte, and equal
  snapshots;
- the port's servicer answers one sequence of task, node-check and
  diagnosis messages with the reference servicer's bytes;
- ``IndexShardingClient`` iterates a dataset's indices from a port master
  over the port's RPC, and a worker's failure requeues its shards.

Everything is exact: no tolerance."""

import dataclasses
import random
import types

import pytest

from dlrover_tpu.common import messages as R
from dlrover_tpu.master import dataset_splitter as rsplit
from dlrover_tpu.master import task_manager as rtm
from dlrover_tpu.master.master import LocalJobMaster as RMaster
from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common import messages as m
from dlrover_tpu_torch.data.sharding import IndexShardingClient
from dlrover_tpu_torch.master import dataset_splitter as tsplit
from dlrover_tpu_torch.master import task_manager as ttm
from dlrover_tpu_torch.master.event_callback import TaskRescheduleCallback
from dlrover_tpu_torch.master.master import LocalJobMaster


def _shards(shards):
    return [dataclasses.asdict(s) for s in shards]


SPLITS = [
    dict(dataset_name="t", dataset_size=23, shard_size=5, num_epochs=2),
    dict(dataset_name="t", dataset_size=20, shard_size=4, num_epochs=1,
         storage_type="table"),
    dict(dataset_name="x", dataset_size=17, shard_size=4, num_epochs=3,
         storage_type="text"),
    dict(dataset_name="x", dataset_size=29, shard_size=6, num_epochs=3,
         shuffle=True, storage_type="text"),
    dict(dataset_name="s", dataset_size=-1, shard_size=7,
         storage_type="stream"),
]


@pytest.mark.parametrize("kw", SPLITS, ids=lambda kw: "-".join(
    str(v) for v in kw.values()))
def test_splitters_carve_the_references_shards(kw):
    port, ref = tsplit.new_dataset_splitter(**kw), \
        rsplit.new_dataset_splitter(**kw)
    assert type(port).__name__ == type(ref).__name__
    for _ in range(4):
        assert port.epoch_finished() == ref.epoch_finished()
        assert _shards(port.create_shards()) == _shards(ref.create_shards())
        assert port.epoch == ref.epoch


@pytest.mark.parametrize("seed", [0, 1])
def test_text_splitter_seed_is_the_references(seed):
    port = tsplit.TextDatasetSplitter("d", 40, 7, num_epochs=2,
                                      shuffle=True, seed=seed)
    ref = rsplit.TextDatasetSplitter("d", 40, 7, num_epochs=2, shuffle=True,
                                     seed=seed)
    for _ in range(2):
        assert _shards(port.create_shards()) == _shards(ref.create_shards())


class _Clock:
    """Stands in for each module's ``time``."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    time = monotonic


def _plain(got):
    """A task as plain data: (task id, shard fields, epoch)."""
    if got is None:
        return None
    tid, shard, epoch = got
    return tid, dataclasses.asdict(shard), epoch


def _state(tm):
    st = tm.dump_state()
    st["fetch_tokens"] = [[t, _plain(r)] for t, r in st["fetch_tokens"]]
    return st


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_task_manager_sequence_equals_the_references(seed, monkeypatch):
    clock = _Clock()
    for mod in (ttm, rtm):
        monkeypatch.setattr(mod, "time", clock)
    rng = random.Random(seed)
    port, ref = ttm.TaskManager(task_timeout=50.0), \
        rtm.TaskManager(task_timeout=50.0)
    names = []
    for kw in SPLITS[:4]:
        kw = dict(kw, dataset_name=f"{kw['dataset_name']}{len(names)}")
        kw.setdefault("shuffle", False)
        kw.setdefault("storage_type", "table")
        names.append(kw["dataset_name"])
        port.new_dataset(tsplit.new_dataset_splitter(**kw), params=kw)
        ref.new_dataset(rsplit.new_dataset_splitter(**kw), params=kw)
    held = []
    for i in range(160):
        op = rng.random()
        ds = rng.choice(names + ["nope"])
        clock.now += rng.choice([0.5, 5.0, 20.0])
        if op < 0.45:
            worker = rng.randrange(3)
            token = f"tok{rng.randrange(12)}" if rng.random() < 0.5 else ""
            got = port.get_task(ds, worker, token=token)
            assert _plain(got) == _plain(ref.get_task(ds, worker,
                                                      token=token)), i
            if got is not None:
                held.append((ds, got[0]))
        elif op < 0.75 and held:
            ds, tid = held.pop(rng.randrange(len(held)))
            ok = rng.random() < 0.8
            port.report_task_result(ds, tid, ok)
            ref.report_task_result(ds, tid, ok)
        elif op < 0.8:
            worker = rng.randrange(3)
            assert port.recover_worker_tasks(worker) == \
                ref.recover_worker_tasks(worker)
        elif op < 0.85:
            moved = port.reassign_once()
            with ref._lock:
                want = {n: d.reassign_timeout_tasks()
                        for n, d in ref._datasets.items()}
            assert moved == {n: ids for n, ids in want.items() if ids}
        elif op < 0.88:
            ids = [t for d, t in held if d == ds][:2]
            assert port.requeue_tasks(ds, ids) == ref.requeue_tasks(ds, ids)
        elif op < 0.92:
            content = ref.checkpoint_dataset(ds)
            assert port.checkpoint_dataset(ds) == content
            assert port.restore_dataset(ds, content) == \
                ref.restore_dataset(ds, content)
        for name in names:
            assert port.checkpoint_dataset(name) == \
                ref.checkpoint_dataset(name), (i, name)
            assert port.dataset_completed(name) == \
                ref.dataset_completed(name)
        assert port.queue_depths() == ref.queue_depths()
    assert port.all_completed() == ref.all_completed()
    assert _state(port) == _state(ref)
    # The snapshot restores into a fresh manager of each package alike.
    port2, ref2 = ttm.TaskManager(task_timeout=50.0), \
        rtm.TaskManager(task_timeout=50.0)
    port2.load_state(port.dump_state())
    ref2.load_state(ref.dump_state())
    assert _state(port2) == _state(ref2)
    for name in names:
        for w in range(2):
            assert _plain(port2.get_task(name, w)) == \
                _plain(ref2.get_task(name, w))


def test_task_reschedule_callback_requeues_a_failed_workers_shards():
    from dlrover_tpu_torch.common.node import Node

    tm = ttm.TaskManager()
    tm.new_dataset(tsplit.TableDatasetSplitter("d", 8, 2))
    first = tm.get_task("d", 3)
    tm.get_task("d", 4)
    cb = TaskRescheduleCallback(tm)
    cb.on_node_failed(Node("worker", 3))
    assert tm.get_task("d", 5)[0] == first[0]
    cb.on_node_deleted(Node("ps", 4))  # only workers' shards move
    assert tm.queue_depths() == (2, 2)
    # The HA journal binds and receives the recovery of worker 5's shard.
    appended = []
    tm.bind_journal(types.SimpleNamespace(
        append=lambda kind, fields: appended.append((kind, fields))))
    assert tm.recover_worker_tasks(5) == 1
    assert appended == [("task.recover", {"worker": 5})]


def _task_sequence(seed: int) -> list:
    rng = random.Random(seed)
    seq = [("NodeMeta", dict(node_id=n, node_rank=n, host="127.0.0.1",
                             agent_port=9000 + n, local_world_size=1))
           for n in (0, 1)]
    seq += [("DatasetShardParams", dict(
                dataset_name="ds", dataset_size=23, shard_size=4,
                num_epochs=2, shuffle=bool(seed % 2), storage_type="text")),
            ("DatasetShardParams", dict(dataset_name="ds", dataset_size=5,
                                        shard_size=1)),
            ("TaskRequest", dict(dataset_name="nope", worker_id=0))]
    for i in range(14):
        seq.append(("TaskRequest", dict(dataset_name="ds",
                                        worker_id=rng.randrange(2),
                                        token=f"t{rng.randrange(6)}")))
        if rng.random() < 0.5:
            seq.append(("TaskResult", dict(dataset_name="ds",
                                           task_id=rng.randrange(i + 1),
                                           worker_id=0,
                                           success=rng.random() < 0.7)))
        if i == 6:
            seq += [("ShardCheckpointRequest", dict(dataset_name="ds")),
                    ("NodeFailure", dict(node_id=1, error_data="oom")),
                    ("ShardCheckpointRequest", dict(dataset_name="ds"))]
    seq += [("ShardCheckpoint", dict(dataset_name="ds", content="")),
            ("ShardCheckpoint", dict(dataset_name="ds", content=(
                '{"dataset_name": "ds", "todo": [[2, {"name": "a", '
                '"start": 0, "end": 4, "record_indices": null}]], '
                '"doing": [[5, {"name": "b", "start": 4, "end": 8, '
                '"record_indices": [4, 5]}, 1]], "epoch": 1, '
                '"task_id_seq": 9}'))),
            ("ShardCheckpointRequest", dict(dataset_name="ds")),
            ("TaskRequest", dict(dataset_name="ds", worker_id=1)),
            ("NetworkReadyRequest", {}),
            ("FaultNodeRequest", {}),
            ("StragglerRequest", {}),
            ("JoinRendezvous", dict(node_id=0, node_rank=0,
                                    local_world_size=1,
                                    rdzv_name="network-check")),
            ("JoinRendezvous", dict(node_id=1, node_rank=1,
                                    local_world_size=1,
                                    rdzv_name="network-check")),
            ("NetworkCheckResult", dict(node_id=0, succeeded=True,
                                        elapsed=1.5, round=0)),
            ("NetworkCheckResult", dict(node_id=1, succeeded=False,
                                        elapsed=0.0, round=0)),
            ("FaultNodeRequest", {}),
            ("NetworkCheckResult", dict(node_id=0, succeeded=True,
                                        elapsed=1.0, round=1)),
            ("NetworkCheckResult", dict(node_id=1, succeeded=True,
                                        elapsed=9.0, round=1)),
            ("NetworkReadyRequest", {}),
            ("FaultNodeRequest", {}),
            ("StragglerRequest", {}),
            ("DiagnosisReport", dict(node_id=0, data_type="step_metrics",
                                     content='{"step": 3}',
                                     timestamp=1700000000.0)),
            ("Heartbeat", dict(node_id=0, timestamp=1700000001.0)),
            ("Heartbeat", dict(node_id=1, timestamp=1700000001.0))]
    return seq


@pytest.mark.parametrize("seed", [0, 1])
def test_servicer_answers_task_messages_with_the_references_bytes(seed):
    ref = RMaster(0, job_name="tasks", min_nodes=2, max_nodes=2)
    port = LocalJobMaster(0, job_name="tasks", min_nodes=2, max_nodes=2)
    try:
        for name, fields in _task_sequence(seed):
            want = ref.servicer(R._REGISTRY[name](**fields))
            got = port.servicer(m._REGISTRY[name](**fields))
            want = want if want is not None else R.BaseResponse()
            got = got if got is not None else m.BaseResponse()
            assert m.serialize(got) == R.serialize(want), (name, got, want)
    finally:
        port._server.stop()
        ref._server.stop(0)


def test_index_sharding_client_over_the_ports_rpc():
    master = LocalJobMaster(0, job_name="shard")
    master.prepare()
    a, b = MasterClient(master.addr, 0), MasterClient(master.addr, 1)
    try:
        ca = IndexShardingClient(a, "ds", dataset_size=10, shard_size=3)
        cb = IndexShardingClient(b, "ds", dataset_size=10, shard_size=3)
        held = cb.fetch_task()  # worker 1 takes a shard, then dies
        assert (held.start, held.end) == (0, 3)
        b.report_failure("killed", restart_count=1)
        assert list(ca.iter_indices()) == [0, 1, 2, 3, 4, 5, 6, 7, 8, 9]
        assert master.task_manager.dataset_completed("ds")
        cp = ca.checkpoint()
        assert '"todo": []' in cp and ca.restore(cp)
        assert list(IndexShardingClient(
            a, "ds2", dataset_size=7, shard_size=3).iter_batches(2)) == [
            [0, 1], [2, 3], [4, 5], [6]]
    finally:
        a.close()
        b.close()
        master.request_stop(True, "test")
        master.stop()
