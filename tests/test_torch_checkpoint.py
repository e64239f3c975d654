"""The port's checkpoint layer (``dlrover_tpu_torch/common/{msgpack_lite,
native,storage,shm}.py``, ``dlrover_tpu_torch/checkpoint/``) held against
the JAX package's (``dlrover_tpu/checkpoint/{shard_file,slicer,fsck}.py``,
``msgpack``, ``ml_dtypes``) on the CPU.

Everything is compared exactly: msgpack bytes, shard file bytes, file
listings, restored tensors (bit for bit) and the losses of a model that
trains on after a restore (the same arithmetic in the same order)."""

import io
import os
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.checkpoint import fsck as rfsck
from dlrover_tpu.checkpoint import shard_file as R
from dlrover_tpu.checkpoint import slicer as rslicer
from dlrover_tpu.common.storage import PosixDiskStorage as RStorage
from dlrover_tpu_torch.checkpoint import fsck as pfsck
from dlrover_tpu_torch.checkpoint import shard_file as P
from dlrover_tpu_torch.checkpoint import slicer as pslicer
from dlrover_tpu_torch.checkpoint import tree_utils
from dlrover_tpu_torch.checkpoint.engine import (
    CheckpointEngine,
    agent_queue_socket,
)
from dlrover_tpu_torch.common import msgpack_lite, shm
from dlrover_tpu_torch.common.native import shm_lib
from dlrover_tpu_torch.common.storage import PosixDiskStorage, storage_for
from dlrover_tpu_torch.models import llama
from dlrover_tpu_torch.optim import adam8bit, adamw
from dlrover_tpu_torch.parallel.accelerate import Strategy, accelerate

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- (a) msgpack_lite == msgpack -------------------------------------------

def _ints():
    out = [0, 1, -1, 2 ** 64 - 1, -2 ** 63]
    for b in (5, 7, 8, 15, 16, 31, 32, 63):
        out += [2 ** b - 1, 2 ** b, -2 ** b, -2 ** b - 1]
    return [v for v in out if -2 ** 63 <= v < 2 ** 64]


_BOUNDARY = (
    [("int", v) for v in _ints()]
    + [("str", "s" * n) for n in (0, 31, 32, 255, 256, 65535, 65536)]
    + [("utf8", "é" * 16), ("bin", b""), ("bin", b"b" * 255),
       ("bin", b"b" * 256), ("bin", b"b" * 65536)]
    + [("array", list(range(n))) for n in (15, 16, 65535, 65536)]
    + [("map", {f"k{i}": i for i in range(n)}) for n in (15, 16, 65536)]
    + [("scalar", v) for v in (None, True, False, 1.5, -0.0, 1e300)]
    + [("tuple", (1, "a", (2.5, None)))]
)


@pytest.mark.parametrize("kind,value", _BOUNDARY,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(_BOUNDARY)])
def test_msgpack_lite_matches_msgpack_at_format_boundaries(kind, value):
    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_lite.packb(value) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


_LEAF = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
         | st.floats(allow_nan=False) | st.text(max_size=40)
         | st.binary(max_size=40))
_TREE = st.recursive(
    _LEAF, lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60)


@settings(max_examples=150, deadline=None, database=None)
@given(_TREE)
def test_msgpack_lite_matches_msgpack_on_nested_values(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert msgpack_lite.packb(value) == want
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("data", [
    b"", b"\x92\x01", b"\xda\x00\x05ab", b"\x01\x02", b"\xc1",
    b"\x81\x01\x02", b"\xa2\xff\xfe",
])
def test_msgpack_lite_rejects_what_msgpack_rejects(data):
    with pytest.raises(Exception):
        msgpack.unpackb(data, raw=False)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data)


@pytest.mark.parametrize("value", [{1, 2}, np.int64(3), 2 ** 64, -2 ** 63 - 1])
def test_msgpack_lite_refuses_other_types(value):
    with pytest.raises((TypeError, OverflowError)):
        msgpack_lite.packb(value)


# -- (b) byte-identical shards ---------------------------------------------

def _numpy_cases():
    rng = np.random.RandomState(0)
    f = rng.randn(300, 7).astype(np.float32)
    return {
        "float32": f,
        "bfloat16": (f * 3).astype(ml_dtypes.bfloat16),
        "int8": rng.randint(-128, 128, size=(40, 128)).astype(np.int8),
        "int32": rng.randint(-2 ** 31, 2 ** 31, size=(33,)).astype(np.int32),
        "int64": np.arange(5, dtype=np.int64),
        "float16": f[:4].astype(np.float16),
        "bool": np.array([True, False, True]),
        "scalar": np.asarray(np.int32(7)),
        "empty": np.zeros((0, 3), np.float32),
    }


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


_EXTRA = {"step": 3, "meta": {"step": 3, "sampler": {"epoch": 0}},
          "tensors_info": {}, "process_id": 0, "num_processes": 1}


@pytest.mark.parametrize("case", sorted(_numpy_cases()))
def test_pack_shard_is_byte_identical_to_the_reference(case):
    a = _numpy_cases()[case]
    key = f"['{case}']|0"
    want = R.pack_shard({key: a}, _EXTRA)
    assert P.pack_shard({key: _to_torch(a)}, _EXTRA) == want
    got, extra = P.unpack_shard(want)
    assert extra == _EXTRA and _same(_to_numpy(got[key]), a)


@pytest.mark.parametrize("workers", [1, 3])
def test_stream_writer_is_byte_identical_to_both_packers(tmp_path, workers):
    cases = _numpy_cases()
    nt = {f"{k}|0": v for k, v in cases.items()}
    nt["big|0"] = np.random.RandomState(1).randn(300_000).astype(np.float32)
    pt = {k: _to_torch(v) for k, v in nt.items()}
    want = R.pack_shard(nt, _EXTRA)
    assert P.pack_shard(pt, _EXTRA) == want
    stats = P.write_shard_from_views(PosixDiskStorage(), str(tmp_path), 1, 0,
                                     pt, _EXTRA, workers=workers,
                                     chunk_bytes=1 << 16)
    assert Path(P.shard_path(str(tmp_path), 1, 0)).read_bytes() == want
    assert stats["passes"] == 1 and stats["total_bytes"] == len(want)


def test_stream_writer_relayout_when_a_crc_is_narrow(tmp_path):
    """A tensor CRC below 65536 takes a narrower msgpack form than the
    placeholder: the writer streams a second time, same bytes."""
    k = next(i for i in range(1 << 22)
             if zlib.crc32(np.int32(i).tobytes()) < 65536)
    t = {"a|0": torch.tensor([k], dtype=torch.int32),
         "b|0": torch.arange(10, dtype=torch.float32)}
    stats = P.write_shard_from_views(PosixDiskStorage(), str(tmp_path), 2, 0,
                                     t, _EXTRA)
    want = R.pack_shard({k2: v.numpy() for k2, v in t.items()}, _EXTRA)
    assert stats["passes"] == 2
    assert Path(P.shard_path(str(tmp_path), 2, 0)).read_bytes() == want


def test_native_crc_agrees_with_zlib():
    lib = shm_lib()
    assert lib is not None, "g++ builds native/shm_arena.cc here"
    buf = np.random.RandomState(3).randint(0, 256, 3 << 20).astype(np.uint8)
    for seed in (0, 12345):
        assert lib.shm_crc32(buf.ctypes.data, buf.nbytes, seed) == \
            zlib.crc32(buf, seed)
    half = len(buf) // 2
    assert P.crc32_update(buf[half:], P.crc32_update(buf[:half])) == \
        zlib.crc32(buf) == P.crc32_bytes(buf)


# -- (c) each package reads the other's files ------------------------------

def _pack_v1(tensors, extra):
    """The v1 format (magic DLRTPUF1, no CRCs), as the reference wrote it."""
    metas, blobs, off = {}, [], 0
    for k, arr in tensors.items():
        shape = list(np.shape(arr))
        arr = np.ascontiguousarray(arr)
        metas[k] = {"dtype": arr.dtype.name, "shape": shape,
                    "offset": off, "nbytes": int(arr.nbytes)}
        blobs.append(arr.reshape(-1).view(np.uint8).tobytes())
        off += arr.nbytes
    meta = msgpack.packb({"tensors": metas, "extra": extra},
                         use_bin_type=True)
    return b"DLRTPUF1" + struct.pack("<Q", len(meta)) + meta + b"".join(blobs)


def test_reference_reads_the_ports_files(tmp_path):
    nt = {f"{k}|0": v for k, v in _numpy_cases().items()}
    pt = {k: _to_torch(v) for k, v in nt.items()}
    d = str(tmp_path)
    P.write_shard(PosixDiskStorage(), d, 4, 0, pt, _EXTRA)
    P.commit(PosixDiskStorage(), d, 4)
    blob = Path(P.shard_path(d, 4, 0)).read_bytes()
    got, extra = R.unpack_shard(blob)
    assert extra == _EXTRA and all(_same(got[k], nt[k]) for k in nt)
    with open(P.shard_path(d, 4, 0), "rb") as f:
        assert R.verify_shard_file(f) == (_EXTRA, 2)
    report = rfsck.fsck(d)
    assert not report.damaged and report.committed_step == 4
    assert R.latest_step(RStorage(), d) == 4


@pytest.mark.parametrize("version", [1, 2])
def test_port_reads_the_references_files(tmp_path, version):
    nt = {f"{k}|0": v for k, v in _numpy_cases().items()}
    blob = (_pack_v1(nt, _EXTRA) if version == 1
            else R.pack_shard(nt, _EXTRA))
    got, extra = P.unpack_shard(blob)
    assert extra == _EXTRA
    assert all(_same(_to_numpy(got[k]), nt[k]) for k in nt)
    assert P.verify_shard_file(io.BytesIO(blob)) == (_EXTRA, version)
    d = str(tmp_path)
    os.makedirs(P.step_dir(d, 7))
    Path(P.shard_path(d, 7, 0)).write_bytes(blob)
    tensors, extra = P.read_shard(PosixDiskStorage(), d, 7, 0)
    assert all(_same(_to_numpy(tensors[k]), nt[k]) for k in nt)


def _info(tensors):
    return {k: {"path": k[:-2], "global_shape": list(np.shape(v)),
                "index": [[0, d] for d in np.shape(v)], "owners": [0]}
            for k, v in tensors.items()}


def _incremental_steps():
    """Three steps of a state in which ``w`` never changes and ``b`` does:
    steps 2 and 3 write ``w`` as a ref to step 1."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    steps = []
    for s in (1, 2, 3):
        t = {"w|0": w, "b|0": np.full(5, s, np.int32)}
        steps.append((s, t, dict(_EXTRA, step=s, tensors_info=_info(t))))
    return steps


def test_incremental_steps_match_the_reference_both_ways(tmp_path):
    rdir, pdir = str(tmp_path / "r"), str(tmp_path / "p")
    rtr, ptr = rslicer.DirtyTracker(), pslicer.DirtyTracker()
    for s, t, extra in _incremental_steps():
        rplan = rslicer.plan_persist(
            t, extra, process_id=0, num_processes=1, tracker=rtr,
            holder_exists=lambda h: os.path.exists(R.shard_path(rdir, h, 0)))
        rst = R.write_shard_from_views(RStorage(), rdir, s, 0, rplan.tensors,
                                       rplan.extra,
                                       meta_extra=rplan.meta_extra)
        rtr.note_plan(rplan, s, rst["crcs"])
        pt = {k: _to_torch(v) for k, v in t.items()}
        pplan = pslicer.plan_persist(
            pt, extra, tracker=ptr,
            holder_exists=lambda h: os.path.exists(P.shard_path(pdir, h, 0)))
        pst = P.write_shard_from_views(PosixDiskStorage(), pdir, s, 0,
                                       pplan.tensors, pplan.extra,
                                       meta_extra=pplan.meta_extra)
        ptr.note_plan(pplan, s, pst["crcs"])
        assert pplan.refs == rplan.refs == ({} if s == 1 else {"w|0": 1})
        assert Path(P.shard_path(pdir, s, 0)).read_bytes() == \
            Path(R.shard_path(rdir, s, 0)).read_bytes()
        R.commit(RStorage(), rdir, s)
        P.commit(PosixDiskStorage(), pdir, s)
    # Each package follows the other's refs.
    for d in (rdir, pdir):
        tensors, extra = P.read_shard(PosixDiskStorage(), d, 3, 0)
        rtensors, _ = R.read_shard(RStorage(), d, 3, 0)
        assert extra["ref_steps"] == [1]
        for k, v in _incremental_steps()[2][1].items():
            assert _same(tensors[k].numpy(), v) and _same(rtensors[k], v)
    assert not pfsck.fsck(pdir).damaged and not rfsck.fsck(pdir).damaged


# -- (d) every damage raises ShardCorruptionError --------------------------

def _damaged():
    good = R.pack_shard({"a|0": np.arange(12, dtype=np.float32).reshape(3, 4),
                         "b|0": np.array([True, False])}, {"step": 1})
    v1 = _pack_v1({"a|0": np.arange(4, dtype=np.float32)}, {})
    flip = bytearray(good)
    flip[-3] ^= 0x01
    meta_flip = bytearray(good)
    meta_flip[R._V2_HEADER + 2] ^= 0x01
    cases = {"tensor_bitflip": bytes(flip), "meta_bitflip": bytes(meta_flip),
             "meta_past_eof": good[:R._V2_HEADER + 4],
             "truncated_blob": good[:-4], "empty": b"", "one_byte": b"x",
             "garbage": b"hello world, definitely not a shard",
             "bad_dtype": R.pack_shard(
                 {"a|0": np.zeros(2, np.float32)}, {},
                 meta_extra={"a|0": {"dtype": "no_such_type"}})}
    cases.update({f"short_{n}": good[:n] for n in (0, 5, 12, 17)})
    cases.update({f"v1_cut_{n}": v1[:n] for n in (3, 12, 20, len(v1) - 4)})
    return cases


@pytest.mark.parametrize("case", sorted(_damaged()))
def test_every_damage_raises_shard_corruption(case):
    blob = _damaged()[case]
    with pytest.raises(R.ShardCorruptionError):
        R.unpack_shard(blob)
    with pytest.raises(P.ShardCorruptionError):
        P.unpack_shard(blob)
    if case != "bad_dtype":  # verification checks bytes, not types
        with pytest.raises(P.ShardCorruptionError):
            P.verify_shard_file(io.BytesIO(blob))


# -- (e) the commit protocol leaves the reference's listing ----------------

class _NoRename(PosixDiskStorage):
    def rename_dir(self, src, dst):
        return False


class _RNoRename(RStorage):
    def rename_dir(self, src, dst):
        return False


def _listing(d):
    return sorted(
        (os.path.relpath(os.path.join(root, f), d),
         Path(root, f).read_bytes() if f.endswith(".ckpt")
         or f.endswith(".txt") else None)
        for root, _, files in os.walk(d) for f in files)


@pytest.mark.parametrize("keep_last", [0, 2])
def test_commit_rotation_quarantine_match_the_reference(tmp_path, keep_last):
    out = {}
    for name, sf, store, norename in (("r", R, RStorage(), _RNoRename()),
                                      ("p", P, PosixDiskStorage(),
                                       _NoRename())):
        d = str(tmp_path / name)
        for s in (1, 2, 3, 4, 5, 6):
            t = {"w|0": np.full(4, s, np.float32)}
            if sf is P:
                t = {k: torch.from_numpy(v) for k, v in t.items()}
            sf.write_shard(store, d, s, 0, t, dict(_EXTRA, step=s))
            sf.commit(store, d, s, keep_last=keep_last)
            if s == 2:
                sf.quarantine_step(store, d, 2)
            if s == 3:
                sf.quarantine_step(norename, d, 3)
        out[name] = (_listing(d), sf.list_steps(store, d),
                     [s for s, _ in sf.list_quarantined(store, d)],
                     sf.latest_step(store, d))
    assert out["p"] == out["r"]
    assert out["p"][2] == [2, 3]


# -- (f) tree_utils and the engine -----------------------------------------

def _tiny_job(opt):
    cfg = llama.LlamaConfig.tiny()
    batch = {"tokens": np.random.RandomState(0).randint(
        0, cfg.vocab_size, size=(2, 17)).astype(np.int32)}
    job = accelerate(
        loss_fn=lambda p, b: llama.loss_fn(p, b, cfg),
        init_fn=lambda g: llama.init_params(cfg, g, "cpu",
                                            param_dtype=torch.float32),
        optimizer=opt, sample_batch=batch, strategy=Strategy(),
        device="cpu")
    return job, batch


def _trained_state(opt, seed=0, steps=2):
    job, batch = _tiny_job(opt)
    state = job.create_state(torch.Generator().manual_seed(seed))
    for _ in range(steps):
        state, _ = job.train_step(state, batch)
    return job, batch, state


def _flat(state):
    tensors, _ = tree_utils.flatten_to_shards(state)
    return {k: t.detach().clone() for k, t in tensors.items()}


def _assert_bit_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.fixture
def engine_env(monkeypatch, tmp_path):
    for var in ("DLROVER_TPU_RUN_ID", "DLROVER_TPU_NUM_PROCESSES",
                "DLROVER_TPU_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    made = []

    def make(job, **kw):
        eng = CheckpointEngine(str(tmp_path / "ckpt"),
                               job_name=f"{job}-{os.getpid()}", **kw)
        made.append(eng.arena.name)
        return eng

    yield make
    for name in made:
        shm.unlink_arena(name)


@pytest.mark.parametrize("opt_name", ["adamw", "adam8bit"])
@pytest.mark.parametrize("route", ["shm", "storage"])
def test_engine_round_trip_continues_exactly(engine_env, opt_name, route):
    opt = adamw(1e-3) if opt_name == "adamw" else adam8bit(1e-3)
    job, batch, state = _trained_state(opt)
    saved = _flat(state)
    eng = engine_env(f"rt-{opt_name}-{route}")
    meta = {"step": 2, "sampler": {"epoch": 0, "completed_steps": 2}}
    if route == "shm":
        eng.save_to_memory(2, state, meta)
    else:
        eng.save_to_storage(2, state, meta)
        assert eng.wait(60)
        eng.close()
        assert shm.unlink_arena(eng.arena.name)
        eng = engine_env(f"rt-{opt_name}-{route}")
    fresh = job.create_state(torch.Generator().manual_seed(7))
    params_before = [id(p) for p in fresh["opt_state"].param_groups[0]
                     ["params"]]
    restored, got_meta = eng.load(fresh)
    assert restored is fresh and got_meta == meta
    assert eng.last_restore_source == route
    assert [id(p) for p in fresh["opt_state"].param_groups[0]["params"]] \
        == params_before
    _assert_bit_equal(saved, _flat(fresh))
    assert fresh["step"] == state["step"] == 2
    for _ in range(2):
        state, m1 = job.train_step(state, batch)
        fresh, m2 = job.train_step(fresh, batch)
        assert float(m1["loss"]) == float(m2["loss"])
    _assert_bit_equal(_flat(state), _flat(fresh))
    eng.close()


def test_incremental_persist_refs_unchanged_tensors(engine_env):
    job, batch, state = _trained_state(adamw(1e-3), steps=1)
    eng = engine_env("inc")
    eng.save_to_storage(1, state, {"step": 1})
    assert eng.wait(60)
    eng.save_to_storage(2, state, {"step": 2})  # no tensor changed
    assert eng.wait(60)
    man = P.read_shard_manifest(eng.storage, eng.ckpt_dir, 2, 0)
    assert man.extra["ref_steps"] == [1]
    assert all(tm["ref"]["step"] == 1 for tm in man.tensors.values()
               if tm["full_nbytes"])
    eng.close()
    shm.unlink_arena(eng.arena.name)
    eng2 = engine_env("inc")
    fresh = job.create_state(torch.Generator().manual_seed(3))
    _, meta = eng2.load(fresh)
    assert meta["step"] == 2 and eng2.last_restore_source == "storage"
    _assert_bit_equal(_flat(state), _flat(fresh))
    eng2.close()


@pytest.mark.parametrize("damage", ["missing", "extra", "shape", "dtype"])
def test_restore_refuses_a_mismatch_and_copies_nothing(damage):
    _, _, state = _trained_state(adamw(1e-3), steps=1)
    source = {k[:-2]: t.clone() for k, t in _flat(state).items()}
    key = "['params']['embed']"
    if damage == "missing":
        del source[key]
    elif damage == "extra":
        source["['params']['nope']"] = torch.zeros(1)
    elif damage == "shape":
        source[key] = source[key][:1]
    else:
        source[key] = source[key].double()
    for t in source.values():
        if t.is_floating_point():
            t.add_(1.0)
    before = _flat(state)
    with pytest.raises(KeyError if damage in ("missing", "extra")
                       else ValueError):
        tree_utils.restore_to_target(source, state)
    _assert_bit_equal(before, _flat(state))


def test_load_falls_back_past_a_corrupt_step_and_quarantines_it(engine_env):
    job, batch, state = _trained_state(adamw(1e-3), steps=1)
    eng = engine_env("ladder")
    eng.save_to_storage(1, state, {"step": 1})
    assert eng.wait(60)
    saved = _flat(state)
    state, _ = job.train_step(state, batch)
    eng.save_to_storage(2, state, {"step": 2})
    assert eng.wait(60)
    eng.close()
    shm.unlink_arena(eng.arena.name)
    d = eng.ckpt_dir
    man = P.read_shard_manifest(eng.storage, d, 2, 0)
    tm = man.tensors["['params']['embed']|0"]
    with open(P.shard_path(d, 2, 0), "r+b") as f:
        f.seek(man.data_base + tm["offset"] + 5)
        b = f.read(1)
        f.seek(-1, 1)
        f.write(bytes([b[0] ^ 0xFF]))
    report = pfsck.fsck(d)
    assert report.damaged and any(
        "embed" in f.reason and "shard_00000" in f.path
        for f in report.findings)
    eng2 = engine_env("ladder")
    fresh = job.create_state(torch.Generator().manual_seed(9))
    _, meta = eng2.load(fresh)
    assert meta["step"] == 1
    assert os.path.isdir(P.step_dir(d, 2) + ".corrupt")
    _assert_bit_equal(saved, _flat(fresh))
    eng2.close()


def test_engine_refuses_what_later_slices_bring(engine_env, monkeypatch,
                                                tmp_path):
    with pytest.raises(NotImplementedError, match="object-store"):
        storage_for("gs://bucket/ckpt")
    eng = engine_env("later")
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        eng.load({}, target_mesh=object())
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        pslicer.plan_persist({}, {}, process_id=1, num_processes=2)
    eng.close()
    sock_dir = tmp_path / "sock"
    monkeypatch.setattr("dlrover_tpu_torch.checkpoint.engine._SOCK_DIR",
                        str(sock_dir))
    sock_dir.mkdir()
    Path(agent_queue_socket("agentjob")).touch()
    with pytest.raises(NotImplementedError, match="agent mode"):
        CheckpointEngine(str(tmp_path), job_name="agentjob")
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="2 processes"):
        CheckpointEngine(str(tmp_path), job_name="two")


# -- the arena ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["native", "python"])
def test_arena_round_trip_on_each_backend(monkeypatch, backend):
    if backend == "python":
        monkeypatch.setattr(shm, "shm_lib", lambda: None)
    name = f"dlrtpu_test_{backend}_{os.getpid()}"
    flat = {k: _to_torch(v) for k, v in _numpy_cases().items()}
    a = shm.SharedMemoryArena(name)
    try:
        a.write_state(flat, {"step": 5})
        assert a.backend == backend
        reader = shm.SharedMemoryArena(name)
        got, extra = reader.read_state(copy=False)
        assert extra == {"step": 5}
        assert all(torch.equal(got[k], flat[k]) and got[k].dtype ==
                   flat[k].dtype for k in flat)
        del got
        reader.close()
        # A writer killed mid-copy leaves the dirty flag: no state.
        a._write_header(struct.pack(shm._HEADER_FMT, shm.MAGIC, a.size,
                                    shm.META_CAPACITY, 0, 1, 0, 1))
        dead = shm.SharedMemoryArena(name)
        assert dead.read_state() is None
        dead.close()
    finally:
        a.close()
        shm.unlink_arena(name)


def test_arena_checks_room_before_mapping(monkeypatch):
    class _Small:
        f_bavail, f_frsize = 1000, 4096

    monkeypatch.setattr(shm.os, "statvfs", lambda path: _Small())
    a = shm.SharedMemoryArena(f"dlrtpu_test_room_{os.getpid()}")
    with pytest.raises(OSError, match=r"needs \d+ bytes .* has 4096000 "
                                      r"bytes"):
        a.write_state({"x": torch.zeros(1 << 20)}, {})
    assert a.backend is None


# -- fsck -------------------------------------------------------------------

def test_fsck_cli_and_reference_agree(tmp_path):
    d = str(tmp_path / "ck")
    rdir = str(tmp_path / "r")
    for s, t, extra in _incremental_steps():
        for sf, store, dd in ((P, PosixDiskStorage(), d),
                              (R, RStorage(), rdir)):
            pt = t if sf is R else {k: _to_torch(v) for k, v in t.items()}
            sf.write_shard(store, dd, s, 0, pt, extra)
            sf.commit(store, dd, s)
    assert pfsck.main([d]) == 0
    # Damage the holder of nothing (step 3's own tensor b) and compare.
    for dd in (d, rdir):
        man = P.read_shard_manifest(PosixDiskStorage(), dd, 3, 0)
        with open(P.shard_path(dd, 3, 0), "r+b") as f:
            f.seek(man.data_base + man.tensors["b|0"]["offset"])
            f.write(b"\xff")
    mine, ref = pfsck.fsck(d), rfsck.fsck(rdir)
    assert mine.damaged and ref.damaged
    assert [(f.severity, f.step, f.reason) for f in mine.findings] == \
        [(f.severity, f.step, f.reason) for f in ref.findings]
    proc = subprocess.run(
        [sys.executable, "-m", "dlrover_tpu_torch.checkpoint.fsck", d,
         "--json"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and '"damaged": true' in proc.stdout
    assert pfsck.main([str(tmp_path / "absent")]) == 2
