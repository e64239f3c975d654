"""Control-plane RPC on the standard library — the port's counterpart of
``dlrover_tpu/common/rpc.py`` (``RpcServer``, ``RpcClient``,
``find_free_port``, ``addr_connectable``, ``local_ip``).

The reference carries its messages over one gRPC generic route
(``/dlrover_tpu.Master/call``).  The port depends on no ``grpcio``, so it
carries the same message bytes (``common/messages.py``, equal to the
reference's ``serialize``) over its own framing: TCP, a 4-byte big-endian
length before each frame, one request frame answered by one reply frame, a
thread per connection on the server and a pool of connections on the
client.  The two packages therefore cannot call each other; what is held
against the reference is the message bytes and the servicer's answers
(``tests/test_torch_master.py``), not the framing.

The contract is the reference's: ``RpcServer(port, handler)`` with ``port=0``
binding a free port; a handler's ``None`` is answered as a successful
``BaseResponse``; a handler exception or a payload that does not decode is
answered as a failed ``BaseResponse`` and the server stays up.
``RpcClient.call`` retries with jittered exponential backoff under a total
deadline.  A refused, reset or closed connection is gRPC's UNAVAILABLE (the
request was not executed, or the server died with it) and is always
retried; a timeout waiting for the reply is DEADLINE_EXCEEDED and is
retried only for calls marked ``idempotent``.  After two UNAVAILABLE
strikes the client drops its pooled connections and asks its
``addr_provider`` for the address again, as the reference rebuilds its
channel.  The reference's chaos sites have no counterpart here
(``constants.CHAOS_LAYER``).
"""

from __future__ import annotations

import itertools
import random
import socket
import socketserver
import struct
import threading
import time
from typing import Callable, List, Optional

from dlrover_tpu_torch.common.constants import GRPC
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    BaseResponse,
    Message,
    deserialize,
    serialize,
)

_LEN = struct.Struct(">I")


class StatusCode:
    """The gRPC status codes this transport raises, by their names."""

    UNAVAILABLE = "UNAVAILABLE"
    DEADLINE_EXCEEDED = "DEADLINE_EXCEEDED"
    RESOURCE_EXHAUSTED = "RESOURCE_EXHAUSTED"


class RpcError(Exception):
    """A failed call, with a gRPC status name (``code()``)."""

    def __init__(self, code: str, details: str = ""):
        super().__init__(f"{code}: {details}")
        self._code = code
        self._details = details

    def code(self) -> str:
        return self._code

    def details(self) -> str:
        return self._details


def find_free_port(host: str = "") -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


def addr_connectable(addr: str, timeout: float = 3.0) -> bool:
    """TCP-probe ``host:port``, retrying until ``timeout`` (a refused
    connection fails at once, so one attempt would race a master that is
    still starting)."""
    try:
        host, port_s = addr.rsplit(":", 1)
        port = int(port_s)
    except ValueError:
        return False
    deadline = time.monotonic() + timeout
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        try:
            with socket.create_connection((host, port),
                                          timeout=max(0.1, remaining)):
                return True
        except OSError:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            time.sleep(min(0.5, remaining))


def local_ip() -> str:
    """This host's address for its peers: the loopback address, as the
    port runs on one host.  The reference's probe of a public address is
    not copied."""
    return "127.0.0.1"


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """``n`` bytes, or ``None`` when the peer closed first."""
    chunks, got = [], 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, _LEN.size)
    if head is None:
        return None
    (n,) = _LEN.unpack(head)
    if n > GRPC.MAX_MESSAGE_LENGTH:
        raise ValueError(f"frame of {n} bytes is over the limit")
    return _recv_exact(sock, n)


class _Server(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True
    block_on_close = False


class RpcServer:
    """A framed TCP server with one dispatch: ``handler(msg) ->
    Optional[Message]``."""

    def __init__(self, port: int,
                 handler: Callable[[Message], Optional[Message]],
                 max_workers: int = 64, host: str = "0.0.0.0"):
        self._handler = handler
        self._host = host
        self._calls = itertools.count()
        self._calls_now = 0
        self._conns: set = set()
        self._conns_mu = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        outer = self

        class _Conn(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                with outer._conns_mu:
                    outer._conns.add(sock)
                try:
                    while True:
                        try:
                            frame = _recv_frame(sock)
                        except (OSError, ValueError):
                            return
                        if frame is None:
                            return
                        _send_frame(sock, outer._dispatch(frame))
                except OSError:
                    return
                finally:
                    with outer._conns_mu:
                        outer._conns.discard(sock)

        self._server = _Server((host, port), _Conn, bind_and_activate=True)
        self._bound_port = self._server.server_address[1]

    def _dispatch(self, request: bytes) -> bytes:
        nth = self._calls_now = next(self._calls) + 1
        try:
            msg = deserialize(request)
        except Exception as e:  # noqa: BLE001 - the control plane stays up
            logger.exception("RPC deserialize error")
            return serialize(BaseResponse(
                success=False, reason=f"{type(e).__name__}: {e}"))
        try:
            resp = self._handler(msg)
            if resp is None:
                resp = BaseResponse(success=True)
        except Exception as e:  # noqa: BLE001 - the control plane stays up
            logger.exception("RPC handler error")
            resp = BaseResponse(success=False,
                                reason=f"{type(e).__name__}: {e}")
        if nth == 1:
            # A promoted standby's first answer ends a failover's gap.
            logger.info("RPC server on :%d answered its first request (%s)",
                        self._bound_port, type(msg).__name__)
        return serialize(resp)

    @property
    def port(self) -> int:
        return self._bound_port

    @property
    def calls(self) -> int:
        """Requests served so far (failed dispatches included)."""
        return self._calls_now

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            name="rpc-server", daemon=True)
        self._thread.start()
        logger.info("RPC server listening on %s:%s", self._host,
                    self._bound_port)

    def stop(self, grace: float = 1.0) -> None:
        """Stop accepting and close every open connection (their clients
        see the connection drop: UNAVAILABLE)."""
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=grace)
        self._server.server_close()
        with self._conns_mu:
            conns = list(self._conns)
        for sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


class RpcClient:
    """The client side, with bounded retry (the reference's
    ``retry_grpc_request`` policy)."""

    #: Default total retry budget of a call, seconds.
    DEFAULT_DEADLINE = 60.0

    def __init__(self, addr: str, timeout: float = 30.0,
                 addr_provider: Optional[Callable[[], str]] = None):
        self._addr = addr
        self._timeout = timeout
        self._addr_provider = addr_provider
        self._reconnect_mu = threading.Lock()
        self._pool_mu = threading.Lock()
        self._pool: List[socket.socket] = []
        self._connected_at = time.monotonic()

    @property
    def addr(self) -> str:
        return self._addr

    def _take(self, timeout: float) -> socket.socket:
        with self._pool_mu:
            if self._pool:
                return self._pool.pop()
        host, port = self._addr.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError as e:  # refused, unreachable, connect timeout
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"connect to {self._addr}: {e}") from e
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def _give(self, sock: socket.socket) -> None:
        with self._pool_mu:
            self._pool.append(sock)

    def _call_once(self, payload: bytes, timeout: float) -> bytes:
        if len(payload) > GRPC.MAX_MESSAGE_LENGTH:
            raise RpcError(StatusCode.RESOURCE_EXHAUSTED,
                           f"request of {len(payload)} bytes")
        sock = self._take(timeout)
        sent = False
        try:
            sock.settimeout(timeout)
            _send_frame(sock, payload)
            sent = True
            data = _recv_frame(sock)
        except socket.timeout as e:
            sock.close()
            code = (StatusCode.DEADLINE_EXCEEDED if sent
                    else StatusCode.UNAVAILABLE)
            raise RpcError(code, f"{self._addr}: {e}") from e
        except (OSError, ValueError) as e:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"{self._addr}: {e}") from e
        if data is None:
            sock.close()
            raise RpcError(StatusCode.UNAVAILABLE,
                           f"{self._addr} closed the connection")
        self._give(sock)
        return data

    def _drop_pool(self) -> None:
        with self._pool_mu:
            pool, self._pool = self._pool, []
        for sock in pool:
            sock.close()

    def reconnect(self, force: bool = False) -> None:
        """Drop the pooled connections and re-resolve the address
        (rate-limited unless ``force``)."""
        with self._reconnect_mu:
            if not force and time.monotonic() - self._connected_at < 2.0:
                return
            if self._addr_provider is not None:
                try:
                    fresh = self._addr_provider()
                except Exception as e:  # noqa: BLE001 - best effort
                    logger.warning("RPC addr re-resolve failed: %s", e)
                    fresh = ""
                if fresh and fresh != self._addr:
                    logger.warning("RPC client re-homing %s -> %s",
                                   self._addr, fresh)
                    self._addr = fresh
            self._drop_pool()
            self._connected_at = time.monotonic()
            logger.info("RPC connections to %s dropped", self._addr)

    def call(self, msg: Message, timeout: Optional[float] = None,
             retries: int = 5, backoff: float = 0.5,
             deadline: Optional[float] = None,
             idempotent: bool = False) -> Message:
        """Send ``msg`` with bounded, jittered exponential retry (see the
        module docstring for what is retried); ``deadline`` bounds all
        attempts and sleeps together."""
        budget = (max(self.DEFAULT_DEADLINE, timeout or self._timeout)
                  if deadline is None else deadline)
        start = time.monotonic()
        last_err: Optional[Exception] = None
        name = type(msg).__name__
        payload = serialize(msg)
        for attempt in range(retries):
            try:
                remaining = budget - (time.monotonic() - start)
                if remaining <= 0:
                    break
                return deserialize(self._call_once(
                    payload, min(timeout or self._timeout, remaining)))
            except RpcError as e:
                last_err = e
                code = e.code()
                retriable = code == StatusCode.UNAVAILABLE or (
                    idempotent and code == StatusCode.DEADLINE_EXCEEDED)
                if not retriable:
                    raise
                if attempt + 1 >= retries:
                    break
                base = min(backoff * (2 ** attempt), 8.0)
                sleep = random.uniform(0.5 * base, base)
                remaining = budget - (time.monotonic() - start)
                if remaining <= sleep:
                    break
                logger.warning("RPC %s to %s failed (%s), retry %d/%d in "
                               "%.1fs", name, self._addr, code, attempt + 1,
                               retries, sleep)
                time.sleep(sleep)
                if code == StatusCode.UNAVAILABLE and attempt >= 1:
                    self.reconnect()
        if last_err is None:
            raise TimeoutError(
                f"RPC {name} to {self._addr}: deadline budget "
                f"{budget:.1f}s spent before the first attempt")
        raise last_err

    def close(self) -> None:
        self._drop_pool()
