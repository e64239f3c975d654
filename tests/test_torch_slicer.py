"""The port's sliced persist and coverage proof (``dlrover_tpu_torch/
checkpoint/slicer.py``, ``reshard/plan.py``, ``tree_utils.ShardSource``)
held against the reference's (``dlrover_tpu/checkpoint/slicer.py``,
``reshard/plan.py``, ``tree_utils.ShardSource``) on the same tensors and
``tensors_info``: the partition, the plans, the per-rank shard files byte
for byte, the commit gate's verdicts (mirroring ``tests/test_ckpt_slice.py``)
and each package assembling the other's sliced checkpoint."""

import os
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.checkpoint import shard_file as R
from dlrover_tpu.checkpoint import slicer as rslicer
from dlrover_tpu.checkpoint.tree_utils import ShardSource as RSource
from dlrover_tpu.common.storage import PosixDiskStorage as RStorage
from dlrover_tpu.reshard import plan as rplan
from dlrover_tpu_torch.checkpoint import fsck as pfsck
from dlrover_tpu_torch.checkpoint import shard_file as P
from dlrover_tpu_torch.checkpoint import slicer as pslicer
from dlrover_tpu_torch.checkpoint.tree_utils import ShardSource as PSource
from dlrover_tpu_torch.common.storage import PosixDiskStorage
from dlrover_tpu_torch.reshard import plan as pplan


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state():
    """A replicated state: big tensors that slice, small ones that go whole
    to one owner, bf16, int8, a scalar and an empty tensor."""
    rng = np.random.RandomState(3)
    return {
        "['big']|0": rng.randn(50001).astype(np.float32),  # not divisible
        "['bf']|0": (rng.randn(200, 129) * 3).astype(ml_dtypes.bfloat16),
        "['codes']|0": rng.randint(-128, 128, (300, 256)).astype(np.int8),
        "['small']|0": rng.randn(7).astype(np.float64),
        "['scalar']|0": np.asarray(np.float32(2.5)),
        "['empty']|0": np.zeros((0, 3), np.float32),
        "['step']|0": np.asarray(np.int64(9)),
    }


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _info(state, world, owners=None, host=()):
    out = {}
    for k, v in state.items():
        m = {"path": k.rsplit("|", 1)[0], "global_shape": list(np.shape(v)),
             "index": [[0, d] for d in np.shape(v)]}
        if k in host:
            m["host"] = True
        else:
            m["owners"] = owners if owners is not None else list(range(world))
        out[k] = m
    return out


def _extra(state, step, pid, world, **kw):
    return {"step": step, "meta": {"step": step}, "tensors_info":
            _info(state, world, **kw), "process_id": pid,
            "num_processes": world,
            "tree_paths": sorted({k.rsplit("|", 1)[0] for k in state})}


def _bytes_of(x) -> bytes:
    if torch.is_tensor(x):
        x = _to_numpy(x.contiguous())
    return np.ascontiguousarray(x).tobytes()


# -- the partition ----------------------------------------------------------

@settings(max_examples=200, deadline=None, database=None)
@given(n_elems=st.integers(0, 5000), itemsize=st.sampled_from([1, 2, 4, 8]),
       n_owners=st.integers(1, 9), key=st.text(max_size=30))
def test_slice_bounds_and_owner_of_small_equal_the_reference(
        n_elems, itemsize, n_owners, key):
    n = n_elems * itemsize
    for i in range(n_owners):
        assert pslicer.slice_bounds(n, itemsize, n_owners, i) == \
            rslicer.slice_bounds(n, itemsize, n_owners, i)
    assert pslicer.owner_of_small(key, n_owners) == \
        rslicer.owner_of_small(key, n_owners)
    assert pslicer.SLICE_MIN_BYTES == rslicer.SLICE_MIN_BYTES


@pytest.mark.parametrize("world", [2, 3, 4])
@pytest.mark.parametrize("layout", ["owners", "host", "subgroup"])
def test_plan_persist_gives_the_reference_bytes_meta_and_layout(world,
                                                                layout):
    state = _state()
    kw = {"owners": [1, world - 1]} if layout == "subgroup" else \
        {"host": set(state)} if layout == "host" else {}
    pt = {k: _to_torch(v) for k, v in state.items()}
    for pid in range(world):
        extra = _extra(state, 1, pid, world, **kw)
        rp = rslicer.plan_persist(state, extra, process_id=pid,
                                  num_processes=world)
        pp = pslicer.plan_persist(pt, extra, process_id=pid,
                                  num_processes=world)
        assert pp.layout == rp.layout
        assert pp.meta_extra == rp.meta_extra
        assert pp.extra == rp.extra
        assert (pp.written_bytes, pp.logical_bytes, pp.skipped) == \
            (rp.written_bytes, rp.logical_bytes, rp.skipped)
        assert pp.tensors.keys() == rp.tensors.keys()
        for k in rp.tensors:
            assert _bytes_of(pp.tensors[k]) == _bytes_of(rp.tensors[k]), k


def _write_world(pkg, d, state, step, world, trackers=None, skip=()):
    """Persist one replicated state as ``world`` sliced ranks would, with
    the reference (``pkg == "r"``) or the port."""
    for pid in range(world):
        if pid in skip:
            continue
        extra = _extra(state, step, pid, world)
        if pkg == "r":
            plan = rslicer.plan_persist(
                state, extra, process_id=pid, num_processes=world,
                tracker=trackers[pid] if trackers else None,
                holder_exists=lambda s, p=pid: os.path.exists(
                    R.shard_path(d, s, p)))
            stats = R.write_shard_from_views(RStorage(), d, step, pid,
                                             plan.tensors, plan.extra,
                                             meta_extra=plan.meta_extra)
        else:
            plan = pslicer.plan_persist(
                {k: _to_torch(v) for k, v in state.items()}, extra,
                process_id=pid, num_processes=world,
                tracker=trackers[pid] if trackers else None,
                holder_exists=lambda s, p=pid: os.path.exists(
                    P.shard_path(d, s, p)))
            stats = P.write_shard_from_views(PosixDiskStorage(), d, step,
                                             pid, plan.tensors, plan.extra,
                                             meta_extra=plan.meta_extra)
        if trackers:
            trackers[pid].note_plan(plan, step, stats["crcs"])


@pytest.mark.parametrize("world", [2, 3])
def test_per_rank_shard_files_are_byte_identical(tmp_path, world):
    """Two steps with the dirty fence on: step 2 changes one tensor, so the
    others become refs; every rank's file equals the reference's."""
    rd, pd = str(tmp_path / "r"), str(tmp_path / "p")
    rtr = [rslicer.DirtyTracker() for _ in range(world)]
    ptr = [pslicer.DirtyTracker() for _ in range(world)]
    state = _state()
    for step in (1, 2):
        if step == 2:
            state = dict(state, **{"['big']|0": state["['big']|0"] + 1})
        _write_world("r", rd, state, step, world, rtr)
        _write_world("p", pd, state, step, world, ptr)
        for pid in range(world):
            assert Path(P.shard_path(pd, step, pid)).read_bytes() == \
                Path(R.shard_path(rd, step, pid)).read_bytes(), (step, pid)
        assert pslicer.commit_gate(PosixDiskStorage(), pd, step)
        P.commit(PosixDiskStorage(), pd, step, keep_last=0)
    assert not pfsck.fsck(pd).damaged


def _verdicts(d, step):
    pok, pwhy = pslicer.step_covers(PosixDiskStorage(), d, step)
    rok, rwhy = rslicer.step_covers(RStorage(), d, step)
    return (pok, pwhy), (rok, rwhy)


@pytest.mark.parametrize("case", ["complete", "missing_rank",
                                  "missing_slice", "lying_done_vote",
                                  "missing_exclusive_path"])
def test_step_covers_and_commit_gate_give_the_reference_verdicts(tmp_path,
                                                                 case):
    d = str(tmp_path / "c")
    state = {"w|0": np.arange(30000, dtype=np.float32),
             "b|0": np.arange(100, dtype=np.float32)}
    world = 3
    _write_world("p", d, state, 1, world,
                 skip=(1,) if case == "missing_rank" else ())
    if case == "missing_slice":
        # Rank 2's file without its slice of w: rewrite it from a plan
        # that drops the entry.
        extra = _extra(state, 1, 2, world)
        plan = pslicer.plan_persist({k: _to_torch(v) for k, v in
                                     state.items()}, extra, process_id=2,
                                    num_processes=world)
        plan.tensors.pop("w|0")
        plan.meta_extra.pop("w|0")
        P.write_shard_from_views(PosixDiskStorage(), d, 1, 2, plan.tensors,
                                 plan.extra, meta_extra=plan.meta_extra)
    if case == "lying_done_vote":
        os.remove(P.shard_path(d, 1, 1))  # the bytes are gone ...
        PosixDiskStorage().write("1", P.done_path(d, 1, 1))  # ... the vote
    if case == "missing_exclusive_path":
        extra = _extra(state, 1, 0, world)
        extra["tree_paths"] = ["b", "w", "only_on_rank1"]
        plan = pslicer.plan_persist({k: _to_torch(v) for k, v in
                                     state.items()}, extra, process_id=0,
                                    num_processes=world)
        P.write_shard_from_views(PosixDiskStorage(), d, 1, 0, plan.tensors,
                                 plan.extra, meta_extra=plan.meta_extra)
    (pok, pwhy), (rok, rwhy) = _verdicts(d, 1)
    assert pok == rok == (case == "complete")
    assert pwhy == rwhy
    assert pslicer.commit_gate(PosixDiskStorage(), d, 1) == \
        rslicer.commit_gate(RStorage(), d, 1) == (case == "complete")
    if case == "missing_exclusive_path":
        assert "only_on_rank1" in pwhy
    if case in ("missing_rank", "lying_done_vote"):
        assert "uncovered" in pwhy


def test_the_tiling_proof_matches_the_reference():
    """``build_plan`` + ``validate`` and ``ranks_needed`` on the same
    layouts: the same segments, the same verdicts."""
    infos = {r: {"w|0": {"path": "w", "global_shape": [8, 4],
                         "index": [[2 * r, 2 * r + 2], [0, 4]]}}
             for r in range(4)}
    for layout_mod in (rplan, pplan):
        layout_mod.layout_from_tensors_info(infos)
    src_r = rplan.layout_from_tensors_info(infos)
    src_p = pplan.layout_from_tensors_info(infos)
    for boxes in ({"w": [((0, 8), (0, 4))]}, {"w": [((3, 5), (1, 3))]}):
        assert pplan.ranks_needed(infos, boxes, dst_rank=1) == \
            rplan.ranks_needed(infos, boxes, dst_rank=1)
    dst = {"w|0": ((0, 8), (0, 4))}
    got_p = pplan.build_plan(src_p, pplan.MeshLayout(src_p.tensors,
                                                     {0: dst}))
    got_r = rplan.build_plan(src_r, rplan.MeshLayout(src_r.tensors,
                                                     {0: dst}))
    assert [(s.src_rank, s.box, s.byte_range) for s in got_p.segments] == \
        [(s.src_rank, s.box, s.byte_range) for s in got_r.segments]
    assert got_p.stats() == got_r.stats()
    del infos[2]
    for mod in (rplan, pplan):
        with pytest.raises(mod.PlanError, match="uncovered"):
            mod.build_plan(mod.layout_from_tensors_info(infos),
                           mod.MeshLayout(
                               mod.layout_from_tensors_info(infos).tensors,
                               {0: dst}))
    assert pplan.box_subtract(((0, 4), (0, 4)), ((1, 2), (1, 3))) == \
        rplan.box_subtract(((0, 4), (0, 4)), ((1, 2), (1, 3)))


def _read_all(pkg, d, step):
    """Every rank's pieces of ``step`` gathered by one package's reader
    into the other package's ``ShardSource`` (the cross assembly)."""
    if pkg == "r":
        src = PSource()
        for pid in R.list_shard_ids(RStorage(), d, step):
            tensors, slices, extra = R.read_shard_pieces(RStorage(), d, step,
                                                         pid)
            src.add({k: _to_torch(np.asarray(v)) for k, v in
                     tensors.items()}, extra["tensors_info"], slices)
        return src
    src = RSource()
    for pid in P.list_shard_ids(PosixDiskStorage(), d, step):
        tensors, slices, extra = P.read_shard_pieces(PosixDiskStorage(), d,
                                                     step, pid)
        src.add({k: _to_numpy(v) for k, v in tensors.items()},
                extra["tensors_info"], slices)
    return src


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_assembles_the_others_sliced_checkpoint(tmp_path,
                                                             writer):
    d = str(tmp_path / writer)
    state = _state()
    _write_world(writer[0], d, state, 1, 3)
    src = _read_all(writer[0], d, 1)
    for key, want in state.items():
        path = key.rsplit("|", 1)[0]
        whole = tuple((0, int(n)) for n in np.shape(want))
        got = src.assemble(path, whole)
        assert got is not None, path
        assert _bytes_of(got) == _bytes_of(want), path
        if len(whole) == 1 and whole[0][1] > 4:  # the overlap copy
            part = src.assemble(path, ((1, 4),))
            assert _bytes_of(part) == _bytes_of(want[1:4])
    if writer == "port":
        # The port's own source: a missing rank leaves a box uncovered.
        os.remove(P.shard_path(d, 1, 1))
        src = PSource()
        for pid in P.list_shard_ids(PosixDiskStorage(), d, 1):
            tensors, slices, extra = P.read_shard_pieces(
                PosixDiskStorage(), d, 1, pid)
            src.add(tensors, extra["tensors_info"], slices)
        assert src.assemble("['big']", ((0, 50001),)) is None
        with pytest.raises(KeyError):
            src.whole()
