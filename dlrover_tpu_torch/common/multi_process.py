"""Cross-process primitives served over unix-domain sockets — the port's
own copy of ``dlrover_tpu/common/multi_process.py`` (``LocalSocketServer``,
``SharedLock[Server]``, ``SharedQueue[Server]``, ``SharedDict[Server]``,
``socket_path``, ``_proc_start_time``).

The *agent* process hosts one socket server per named primitive; worker
processes on the same host connect as clients.  Used for

- ``SharedLock``  — fencing shm arena writes against the async saver,
- ``SharedQueue`` — worker -> agent checkpoint save events,
- ``SharedDict``  — small shared metadata (e.g. ckpt step -> path).

Framing: 4-byte big-endian length + msgpack ``[op, args...]`` request and
``[ok, value]`` response, encoded with the port's ``common/msgpack_lite.py``
(the bytes of ``msgpack.packb(use_bin_type=True)``), so a port client
works against a reference server and the other way round.  Connections are
per-call: simple, reconnect-free across worker restarts (the common case
in elastic training).
"""

from __future__ import annotations

import collections
import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, Optional

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.log import logger

_SOCK_DIR = os.environ.get("DLROVER_TPU_SOCK_DIR", "/tmp/dlrover_tpu_sock")


def _proc_start_time(pid: int) -> Optional[int]:
    """Process start time in clock ticks (/proc/<pid>/stat field 22) — the
    (pid, starttime) pair uniquely identifies a process across PID reuse."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("utf-8", "replace")
        # Field 2 (comm) may contain spaces/parens; fields after the last
        # ')' are well-formed.
        rest = stat.rsplit(")", 1)[1].split()
        return int(rest[19])  # field 22 overall
    except (OSError, IndexError, ValueError):
        return None


def socket_path(kind: str, name: str) -> str:
    """Where the server of primitive ``kind`` named ``name`` listens.  Only
    a server creates the directory (the reference's makes it on every
    call): a process that merely asks whether an agent listens writes
    nothing.  Both packages default to ``/tmp/dlrover_tpu_sock``, so that
    either's workers find the other's agent; ``DLROVER_TPU_SOCK_DIR`` moves
    it, for every process that shares the primitives."""
    path = os.path.join(_SOCK_DIR, f"{kind}_{name}.sock")
    if len(path) >= 100:  # AF_UNIX sun_path limit is 108
        import hashlib

        digest = hashlib.md5(name.encode()).hexdigest()[:16]
        path = os.path.join(_SOCK_DIR, f"{kind}_{digest}.sock")
    return path


def _send_msg(sock: socket.socket, obj: Any) -> None:
    data = msgpack_lite.packb(obj)
    sock.sendall(len(data).to_bytes(4, "big") + data)


def _recv_msg(sock: socket.socket) -> Any:
    head = b""
    while len(head) < 4:
        chunk = sock.recv(4 - len(head))
        if not chunk:
            raise ConnectionError("socket closed")
        head += chunk
    n = int.from_bytes(head, "big")
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(1 << 16, n - len(buf)))
        if not chunk:
            raise ConnectionError("socket closed")
        buf += chunk
    return msgpack_lite.unpackb(bytes(buf), strict_map_key=False)


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        try:
            req = _recv_msg(self.request)
            op, args = req[0], req[1:]
            fn = getattr(self.server.owner, f"op_{op}", None)
            if fn is None:
                _send_msg(self.request, [False, f"unknown op {op}"])
                return
            _send_msg(self.request, [True, fn(*args)])
        except (ConnectionError, OSError):
            pass
        except Exception as e:  # noqa: BLE001
            try:
                _send_msg(self.request, [False, f"{type(e).__name__}: {e}"])
            except OSError:
                pass


class _ThreadedUnixServer(socketserver.ThreadingUnixStreamServer):
    daemon_threads = True
    allow_reuse_address = True


class LocalSocketServer:
    """Base for the server side of a named primitive (reference
    ``multi_process.py LocalSocketComm`` server role)."""

    KIND = "base"

    def __init__(self, name: str):
        self.name = name
        self.path = socket_path(self.KIND, name)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        if os.path.exists(self.path):
            os.unlink(self.path)
        self._server = _ThreadedUnixServer(self.path, _Handler)
        self._server.owner = self
        # A short poll interval: close() waits for one poll, and an agent
        # closes one server per primitive when it stops.
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name=f"{self.KIND}-{name}",
            daemon=True,
        )
        self._thread.start()

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
            if os.path.exists(self.path):
                os.unlink(self.path)
        except OSError:
            pass


class _Client:
    def __init__(self, kind: str, name: str):
        self._path = socket_path(kind, name)

    # Extra slack past the server-side op timeout: for ops the server may
    # WAIT on (lock acquire, queue get) its wait is bounded by the op
    # timeout it receives, so with this margin it always answers before
    # the client socket deadline — a reply is only lost on a real crash,
    # never on a close race.  Ops the server answers immediately (dict
    # get/set) pass a small ``reply_margin`` instead: against a hung
    # server whose kernel backlog still accepts connects, the margin IS
    # the caller's real latency bound past its timeout, and 30s there
    # defeats the short budgets the save path and scrape handler rely on.
    _REPLY_MARGIN = 30.0

    def request(
        self, op: str, *args: Any, timeout: float = 60.0,
        reply_margin: Optional[float] = None,
    ) -> Any:
        margin = self._REPLY_MARGIN if reply_margin is None else reply_margin
        deadline = time.monotonic() + timeout
        last: Optional[Exception] = None
        while True:
            sent = False
            try:
                with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
                    s.settimeout(
                        max(0.1, deadline - time.monotonic()) + margin
                    )
                    s.connect(self._path)
                    _send_msg(s, [op, *args])
                    sent = True
                    ok, val = _recv_msg(s)
                    if not ok:
                        raise RuntimeError(val)
                    return val
            except (ConnectionError, FileNotFoundError, socket.timeout, OSError) as e:
                if sent:
                    # The op may have executed server-side (e.g. a queue item
                    # popped).  Re-sending could double-execute; surface the
                    # failure instead of guessing.
                    raise ConnectionError(
                        f"request {op} to {self._path} failed after send: {e}"
                    ) from e
                last = e
                if time.time() >= deadline:
                    break
                time.sleep(0.1)
        raise TimeoutError(f"request {op} to {self._path} failed: {last}")


# ---------------------------------------------------------------------------
# SharedLock
# ---------------------------------------------------------------------------


class SharedLockServer(LocalSocketServer):
    KIND = "lock"

    def __init__(self, name: str):
        self._owner: Optional[str] = None
        self._cond = threading.Condition()
        super().__init__(name)

    @staticmethod
    def _holder_alive(holder: Optional[str]) -> bool:
        # Holders are "pid-<pid>-<starttime>" on this host; a holder whose
        # process died (e.g. a worker SIGKILLed mid-checkpoint) must not
        # wedge the lock.  The start time guards against PID reuse: a
        # recycled pid has a different /proc start time.
        if not holder or not holder.startswith("pid-"):
            return True
        parts = holder.split("-")
        try:
            pid = int(parts[1])
            os.kill(pid, 0)
        except (ProcessLookupError, ValueError, IndexError):
            return False
        except PermissionError:
            return True
        if len(parts) >= 3:
            start = _proc_start_time(pid)
            if start is not None and str(start) != parts[2]:
                return False  # pid was recycled
        return True

    def op_acquire(self, holder: str, blocking: bool, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._owner is not None and self._owner != holder:
                if not self._holder_alive(self._owner):
                    logger.warning(
                        "lock %s: stealing from dead holder %s",
                        self.name, self._owner,
                    )
                    self._owner = None
                    break
                if not blocking:
                    return False
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 1.0))
            self._owner = holder
            return True

    def op_release(self, holder: str) -> bool:
        with self._cond:
            if self._owner == holder:
                self._owner = None
                self._cond.notify_all()
                return True
            return False

    def op_locked(self) -> bool:
        with self._cond:
            return self._owner is not None


class SharedLock:
    """Client handle; ``holder`` defaults to pid so re-acquire by the same
    process is idempotent (fencing semantics of reference ``SharedLock:246``).
    """

    def __init__(self, name: str, create: bool = False):
        self.name = name
        self._server = SharedLockServer(name) if create else None
        self._client = _Client(SharedLockServer.KIND, name)
        start = _proc_start_time(os.getpid())
        self._holder = f"pid-{os.getpid()}-{start if start is not None else 0}"

    def acquire(self, blocking: bool = True, timeout: float = 60.0) -> bool:
        return bool(
            self._client.request(
                "acquire", self._holder, blocking, timeout, timeout=timeout + 5
            )
        )

    def release(self) -> bool:
        return bool(self._client.request("release", self._holder))

    def locked(self) -> bool:
        return bool(self._client.request("locked"))

    def __enter__(self):
        # A fencing lock that silently proceeds unfenced would let a worker
        # write the shm arena concurrently with the saver's read.
        if not self.acquire():
            raise TimeoutError(f"could not acquire shared lock {self.name}")
        return self

    def __exit__(self, *exc):
        self.release()

    def close(self) -> None:
        if self._server:
            self._server.close()


# ---------------------------------------------------------------------------
# SharedQueue
# ---------------------------------------------------------------------------


class SharedQueueServer(LocalSocketServer):
    KIND = "queue"

    def __init__(self, name: str, maxsize: int = 0):
        self._q: collections.deque = collections.deque()
        self._maxsize = maxsize
        self._cond = threading.Condition()
        super().__init__(name)

    def op_put(self, item: Any, timeout: float) -> bool:
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._maxsize and len(self._q) >= self._maxsize:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 1.0))
            self._q.append(item)
            self._cond.notify_all()
            return True

    def op_get(self, timeout: float) -> list:
        deadline = time.monotonic() + timeout
        with self._cond:
            while not self._q:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [False, None]
                self._cond.wait(min(remaining, 1.0))
            item = self._q.popleft()
            self._cond.notify_all()
            return [True, item]

    def op_qsize(self) -> int:
        with self._cond:
            return len(self._q)

    def op_clear(self) -> bool:
        with self._cond:
            self._q.clear()
            return True


class SharedQueue:
    def __init__(self, name: str, create: bool = False, maxsize: int = 0):
        self.name = name
        self._server = SharedQueueServer(name, maxsize) if create else None
        self._client = _Client(SharedQueueServer.KIND, name)

    def put(self, item: Any, timeout: float = 60.0) -> bool:
        return bool(self._client.request("put", item, timeout, timeout=timeout + 5))

    def get(self, timeout: float = 60.0) -> Any:
        ok, item = self._client.request("get", timeout, timeout=timeout + 5)
        if not ok:
            raise TimeoutError(f"queue {self.name} get timed out")
        return item

    def get_nowait(self) -> Any:
        ok, item = self._client.request("get", 0.0)
        if not ok:
            raise TimeoutError(f"queue {self.name} empty")
        return item

    def qsize(self) -> int:
        return int(self._client.request("qsize"))

    def empty(self) -> bool:
        return self.qsize() == 0

    def clear(self) -> None:
        self._client.request("clear")

    def close(self) -> None:
        if self._server:
            self._server.close()


# ---------------------------------------------------------------------------
# SharedDict
# ---------------------------------------------------------------------------


class SharedDictServer(LocalSocketServer):
    KIND = "dict"

    def __init__(self, name: str):
        self._d: Dict[str, Any] = {}
        self._lock = threading.Lock()
        super().__init__(name)

    def op_set(self, key: str, value: Any) -> bool:
        with self._lock:
            self._d[key] = value
            return True

    def op_get(self, key: str) -> list:
        with self._lock:
            if key in self._d:
                return [True, self._d[key]]
            return [False, None]

    def op_update(self, other: dict) -> bool:
        with self._lock:
            self._d.update(other)
            return True

    def op_dict(self) -> dict:
        with self._lock:
            return dict(self._d)

    def op_delete(self, key: str) -> bool:
        with self._lock:
            return self._d.pop(key, None) is not None


class SharedDict:
    # Dict ops are answered immediately (no server-side wait), so the
    # reply margin only needs to cover serialization/scheduling latency —
    # a hung-but-accepting server then costs callers timeout+2s, not
    # timeout+30s (the save path and metrics scrape pass timeout=2.0 and
    # rely on that bound actually holding).
    _REPLY_MARGIN = 2.0

    def __init__(self, name: str, create: bool = False):
        self.name = name
        self._server = SharedDictServer(name) if create else None
        self._client = _Client(SharedDictServer.KIND, name)

    def set(self, key: str, value: Any, timeout: float = 60.0) -> None:
        self._client.request("set", key, value, timeout=timeout,
                             reply_margin=self._REPLY_MARGIN)

    def get(self, key: str, default: Any = None,
            timeout: float = 60.0) -> Any:
        ok, val = self._client.request("get", key, timeout=timeout,
                                       reply_margin=self._REPLY_MARGIN)
        return val if ok else default

    def update(self, other: dict, timeout: float = 60.0) -> None:
        self._client.request("update", other, timeout=timeout,
                             reply_margin=self._REPLY_MARGIN)

    def to_dict(self, timeout: float = 60.0) -> dict:
        return self._client.request("dict", timeout=timeout,
                                    reply_margin=self._REPLY_MARGIN)

    def delete(self, key: str) -> None:
        self._client.request("delete", key,
                             reply_margin=self._REPLY_MARGIN)

    def close(self) -> None:
        if self._server:
            self._server.close()
