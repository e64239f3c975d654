"""The port's ``common/multi_process.py`` against the reference's: the
cases of ``tests/test_shm_ipc.py`` for the lock, the queue and the dict,
run against the port, and the wire in both directions (a port client
against a reference server, and a reference client against a port
server: the same length-prefixed msgpack frames)."""

import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import pytest
import torch

from dlrover_tpu.common import multi_process as ref_mp
from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common import multi_process as port_mp

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _sock_dir():
    """The agent's unix sockets in a directory of this module's own, for
    this process and the children it starts."""
    d = tempfile.mkdtemp(prefix="dlsock")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DLROVER_TPU_SOCK_DIR", d)
        mp.setattr(port_mp, "_SOCK_DIR", d)
        mp.setattr(ref_mp, "_SOCK_DIR", d)
        yield d
    shutil.rmtree(d, ignore_errors=True)


def _name(tag: str) -> str:
    return f"tport-{tag}-{os.getpid()}"


_LOCK_CHILD = """
import sys, time
from dlrover_tpu_torch.common.multi_process import SharedLock
lock = SharedLock(sys.argv[1])
assert lock.acquire(timeout=10)
print("held", flush=True)
time.sleep(float(sys.argv[2]))
lock.release()
"""


def test_shared_lock_mutual_exclusion():
    """A lock held by another process makes this one wait."""
    name = _name("lock")
    lock = port_mp.SharedLock(name, create=True)
    child = None
    try:
        child = subprocess.Popen(
            [sys.executable, "-c", _LOCK_CHILD, name, "0.8"], cwd=REPO,
            stdout=subprocess.PIPE, text=True)
        assert child.stdout.readline().strip() == "held"
        t0 = time.time()
        assert lock.acquire(timeout=10)
        assert time.time() - t0 > 0.4  # had to wait for the child
        lock.release()
        assert child.wait(timeout=10) == 0
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        lock.close()


def test_shared_lock_nonblocking_and_dead_holder():
    name = _name("lock2")
    lock = port_mp.SharedLock(name, create=True)
    other = port_mp.SharedLock(name)
    other._holder = "other-live-holder"
    try:
        assert lock.acquire()
        assert lock.locked()
        assert not other.acquire(blocking=False, timeout=0.1)
        lock.release()
        assert other.acquire(blocking=False, timeout=1.0)
        other.release()
        # A holder whose process is gone (or whose pid was reused) is
        # stolen from, never waited on.
        dead = port_mp.SharedLock(name)
        dead._holder = "pid-999999999-1"
        assert dead.acquire(timeout=1.0)
        assert other.acquire(blocking=False, timeout=1.0)
        other.release()
        me = port_mp._proc_start_time(os.getpid())
        assert me == ref_mp._proc_start_time(os.getpid()) and me is not None
        reused = port_mp.SharedLock(name)
        reused._holder = f"pid-{os.getpid()}-{me + 1}"
        assert reused.acquire(timeout=1.0)
        assert other.acquire(blocking=False, timeout=1.0)
        other.release()
    finally:
        lock.close()


def test_shared_queue():
    q = port_mp.SharedQueue(_name("q"), create=True)
    try:
        q.put({"event": "save", "step": 1})
        q.put({"event": "save", "step": 2})
        assert q.qsize() == 2 and not q.empty()
        assert q.get()["step"] == 1
        assert q.get()["step"] == 2
        with pytest.raises(TimeoutError):
            q.get_nowait()
        q.put("x")
        q.clear()
        assert q.empty()
    finally:
        q.close()


def test_shared_queue_blocking_get():
    name = _name("qb")
    q = port_mp.SharedQueue(name, create=True)
    try:
        def put_later():
            time.sleep(0.3)
            port_mp.SharedQueue(name).put("item")

        threading.Thread(target=put_later, daemon=True).start()
        assert q.get(timeout=10) == "item"
    finally:
        q.close()


def test_shared_dict():
    d = port_mp.SharedDict(_name("d"), create=True)
    try:
        d.set("step", 10)
        d.update({"path": "/ckpt/10", "ok": True})
        assert d.get("step") == 10
        assert d.get("missing", "dflt") == "dflt"
        snap = d.to_dict()
        assert snap["path"] == "/ckpt/10" and snap["ok"] is True
        d.delete("step")
        assert d.get("step") is None
    finally:
        d.close()


def test_shared_dict_timeout_bounds_hung_server():
    """A server that accepts but never answers costs a short-timeout dict
    op about timeout + 2 s, not timeout + 30 s."""
    name = _name("hung")
    path = port_mp.socket_path("dict", name)
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        srv.bind(path)
        srv.listen(4)
        d = port_mp.SharedDict(name)
        t0 = time.time()
        with pytest.raises((ConnectionError, TimeoutError, OSError)):
            d.get("k", timeout=0.5)
        assert time.time() - t0 < 5.0
    finally:
        srv.close()
        try:
            os.unlink(path)
        except OSError:
            pass


def test_socket_path_matches_the_reference():
    for kind, name in (("queue", "job-ckptq"), ("lock", "x" * 120)):
        assert port_mp.socket_path(kind, name) == \
            ref_mp.socket_path(kind, name)


def test_only_a_server_makes_the_socket_dir(monkeypatch, tmp_path):
    """Asking where an agent would listen (the engine's probe) and a
    client that finds no server write nothing; a server makes the
    directory."""
    d = tmp_path / "sock"
    monkeypatch.setattr(port_mp, "_SOCK_DIR", str(d))
    path = port_mp.socket_path("queue", "probe")
    assert os.path.dirname(path) == str(d) and not d.exists()
    with pytest.raises((ConnectionError, OSError)):
        port_mp.SharedDict("probe").get("k", timeout=0.2)
    assert not d.exists()
    srv = port_mp.SharedQueue("probe", create=True)
    try:
        assert os.path.exists(path)
    finally:
        srv.close()


@pytest.mark.parametrize("server_side,client_side", [
    ("reference", "port"), ("port", "reference")])
def test_the_wire_in_both_directions(server_side, client_side):
    """Every primitive served by one package answers the other's client;
    the frames are the same bytes."""
    srv_mod = ref_mp if server_side == "reference" else port_mp
    cli_mod = ref_mp if client_side == "reference" else port_mp
    tag = f"{server_side[0]}{client_side[0]}"
    lock = srv_mod.SharedLock(_name(f"wl{tag}"), create=True)
    q = srv_mod.SharedQueue(_name(f"wq{tag}"), create=True)
    d = srv_mod.SharedDict(_name(f"wd{tag}"), create=True)
    try:
        cl = cli_mod.SharedLock(_name(f"wl{tag}"))
        assert cl.acquire(timeout=5) and cl.locked()
        assert cl.release() and not cl.locked()
        cq = cli_mod.SharedQueue(_name(f"wq{tag}"))
        event = {"event": "save", "step": 7, "local_rank": 1,
                 "ckpt_dir": "/ckpt", "max_to_keep": None, "breakpoint": True,
                 "f": 0.25, "blob": b"\x00\xff", "list": [1, -2, 2 ** 40]}
        assert cq.put(event)
        assert cq.qsize() == 1
        assert q.get(timeout=5) == event
        q.put({"back": [1, 2]})
        assert cq.get(timeout=5) == {"back": [1, 2]}
        cd = cli_mod.SharedDict(_name(f"wd{tag}"))
        cd.update({"persisted_0": 4, "persist_mbps_0": 512.5})
        cd.set("stall_ms_0", 1.5)
        assert d.to_dict() == {"persisted_0": 4, "persist_mbps_0": 512.5,
                               "stall_ms_0": 1.5}
        assert cd.get("persisted_0") == 4 and cd.get("nope", -1) == -1
        with pytest.raises(RuntimeError, match="unknown op"):
            cd._client.request("no_such_op")
    finally:
        lock.close()
        q.close()
        d.close()


def test_frames_are_the_reference_bytes():
    import msgpack

    for obj in (["put", {"event": "save", "step": 3}, 60.0],
                [True, [True, {"step": 1}]], ["get", "k"], [False, None],
                {1: "int key"}):
        assert msgpack_lite.packb(obj) == msgpack.packb(obj,
                                                         use_bin_type=True)
        raw = msgpack.packb(obj, use_bin_type=True)
        assert msgpack_lite.unpackb(raw, strict_map_key=False) == \
            msgpack.unpackb(raw, raw=False, strict_map_key=False)
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(msgpack.packb({1: 2}))
