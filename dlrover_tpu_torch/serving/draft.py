"""Draft replicas: speculative proposals as a fleet service — the port's
copy of ``dlrover_tpu/serving/draft.py``, held against its
``pack_proposals`` / ``unpack_proposals`` (byte for byte),
``DraftWorker``, ``DraftServer``, ``RemoteDraftClient``,
``connect_remote_draft`` and ``DraftReplicaRunner``.

- :class:`DraftWorker` (the torch side) keeps one dense 1-row KV cache
  per stream; each :meth:`DraftWorker.propose` call catches every
  stream's cache up from the context delta the target shipped (the tokens
  its verify accepted since the last roll), rolls ``k`` proposals and
  rewinds past the speculative writes, the rewind of the local draft
  path;
- :class:`DraftServer` fronts the worker with the port's RPC
  (``DraftRoll`` -> ``DraftProposals``), the ``KvSegmentServer`` shape;
- :class:`RemoteDraftClient` (no torch) is the handle a spec target's
  ``DecodeServer.set_remote_draft`` takes: it CRC-checks every bundle and
  turns every failure into :class:`DraftUnavailable`, on which the target
  decodes plain;
- :class:`DraftReplicaRunner` is the draft replica's control loop:
  register as the ``draft`` role with the proposal server's address,
  heartbeat-poll for the lease, honour drain, deregister.

Correctness belongs to the target's acceptance: whatever the draft
proposes, each request's stream is the target's own decode, so a draft
replica may die at any point and only the acceptance telemetry goes.

The worker imports torch and the model lazily, so the gateway and client
half runs without them.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    BaseResponse,
    DraftProposals,
    DraftRoll,
    Message,
    ServeGrants,
    ServeReplicaDeregister,
    ServeReplicaPoll,
    ServeReplicaRegister,
)

PROPOSALS_VERSION = 1


class DraftUnavailable(RuntimeError):
    """The draft replica could not serve this round's proposals (dead
    peer, torn bundle).  The target's serve loop degrades
    to plain decode — speculation is an optimization, never a
    dependency."""


def pack_proposals(props: Dict[str, Dict[str, Any]]) -> bytes:
    """Pack one round's proposals — ``{rid: {"d": [k ints], "q":
    [k, V] float array | None}}`` — into the CRC-wrapped msgpack
    envelope the KV-segment path uses (body CRC-32 embedded, verified
    by :func:`unpack_proposals`)."""

    streams = []
    for rid, ent in props.items():
        q = ent.get("q")
        if q is not None:
            q = np.ascontiguousarray(np.asarray(q, np.float32))
        streams.append({
            "rid": str(rid),
            "d": [int(t) for t in ent["d"]],
            "q": q.tobytes() if q is not None else b"",
            "qshape": [int(x) for x in q.shape] if q is not None else [],
        })
    body = msgpack_lite.packb(streams)
    return msgpack_lite.packb(
        {"v": PROPOSALS_VERSION,
         "crc": zlib.crc32(body) & 0xFFFFFFFF, "body": body},
    )


def unpack_proposals(payload: bytes) -> Dict[str, Dict[str, Any]]:
    """Verify + unpack a :func:`pack_proposals` bundle.  Raises
    :class:`DraftUnavailable` on ANY damage — torn proposals must
    degrade the round, never be verified against as draft law."""
    try:
        obj = msgpack_lite.unpackb(payload)
        if obj.get("v") != PROPOSALS_VERSION:
            raise ValueError(f"version {obj.get('v')}")
        body = obj["body"]
        crc = int(obj["crc"])
    except Exception as e:  # noqa: BLE001 - converge on DraftUnavailable
        raise DraftUnavailable(
            f"undecodable proposal bundle: {e}"
        ) from None
    if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
        raise DraftUnavailable("proposal bundle CRC mismatch (torn)")
    try:
        streams = msgpack_lite.unpackb(body)
        out: Dict[str, Dict[str, Any]] = {}
        for ent in streams:
            q = None
            if ent.get("qshape"):
                q = np.frombuffer(
                    ent["q"], dtype=np.float32
                ).reshape(ent["qshape"])
            out[ent["rid"]] = {"d": list(ent["d"]), "q": q}
        return out
    except Exception as e:  # noqa: BLE001 - converge on DraftUnavailable
        raise DraftUnavailable(
            f"malformed proposal bundle: {e}"
        ) from None


class DraftWorker:
    """The torch side of a draft replica: one dense 1-row KV cache per
    stream, catch-up and a ``k``-proposal roll per :meth:`propose` call.

    A stream's committed offset is always ``len(prompt)`` plus the tokens
    the target has shipped.  A roll scores the shipped delta as one chunk
    (writing its keys), takes the first proposal from the chunk's last
    logits, steps the rest, then rewinds the offset to the committed
    point: the speculative writes past it are masked and overwritten by
    the next delta.  Every write stays inside the stream's ``max_len``
    rows (a write past a torch cache raises).

    ``round_floor_s`` models the draft card's time a roll on CPU runs
    (one batched roll over all streams = one floor).
    """

    def __init__(
        self,
        params,
        cfg,
        *,
        max_len: int = 512,
        draft_k: int = 4,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        max_streams: int = 32,
        seed: int = 0,
        worker_id: str = "draft",
        round_floor_s: float = 0.0,
    ):
        import collections

        import torch

        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.max_len = int(max_len)
        self.draft_k = int(draft_k)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.max_streams = int(max_streams)
        self.worker_id = worker_id
        self.round_floor_s = float(round_floor_s)
        self.rolls = 0
        self.proposed_tokens = 0
        #: Model forwards run (opens, delta scores, roll steps): what a
        #: kernel-launch count of the worker's process is held to.
        self.forwards = 0
        self._mu = threading.Lock()
        #: Serializes whole proposal rounds: the RPC server is
        #: multithreaded and two targets' rolls must not interleave
        #: stream-state mutations (the floor sleep stays outside, so
        #: concurrent targets overlap it).
        self._roll_mu = threading.Lock()
        #: rid -> {"cache": 1-row cache layers, "off": committed int}, in
        #: LRU order for the stream bound.
        self._streams: "collections.OrderedDict" = \
            collections.OrderedDict()
        #: rids whose open was refused (prompt outside this worker's
        #: cache): the target re-ships the open every round, and a set
        #: lookup answers it.
        self._refused: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Prompt buckets: powers of two up to max_len (padded prefill;
        # the pad keys are overwritten before they become visible).
        b, buckets = 16, []
        while b < self.max_len:
            buckets.append(b)
            b *= 2
        buckets.append(self.max_len)
        self._buckets = tuple(buckets)

    # -- programs ------------------------------------------------------------

    def _score(self, layers, off: int, chunk: np.ndarray):
        """Score a [1, T] chunk continuing a stream's cache at ``off``
        (written in place); returns the logits [T, V]."""
        import torch

        from dlrover_tpu_torch.models import llama_infer

        toks = torch.from_numpy(chunk.astype(np.int64)).to(self.device)
        self.forwards += 1
        logits, _ = llama_infer.forward_step(
            self.params, toks[None, :], self.cfg,
            {"layers": layers, "offset": off},
        )
        return logits[0]

    def _pick(self, lg1):
        """(token, probabilities [V] or None) of one draft position."""
        import torch

        from dlrover_tpu_torch.models import llama_infer

        if self.temperature > 0.0:
            filt = llama_infer._filter_logits(
                lg1[None, :] / self.temperature, self.top_k, self.top_p)
            probs = torch.softmax(filt, dim=-1)[0]
            e = torch.empty_like(probs).exponential_(1.0,
                                                     generator=self._gen)
            return torch.argmax(probs / e), probs
        return torch.argmax(lg1), None

    def _roll(self, layers, off: int, last_logits, k: int):
        """Proposal 1 from ``last_logits``, then ``k - 1`` draft steps
        writing at ``off..``; returns (toks [k], probs [k, V] or None)."""
        import torch

        from dlrover_tpu_torch.models import llama_infer

        tok, q = self._pick(last_logits)
        toks, qs = [tok], [q]
        for i in range(k - 1):
            self.forwards += 1
            lg, _ = llama_infer.forward_step(
                self.params, tok.view(1, 1), self.cfg,
                {"layers": layers, "offset": off + i},
            )
            tok, q = self._pick(lg[0, -1, :])
            toks.append(tok)
            qs.append(q)
        probs = torch.stack(qs) if self.temperature > 0.0 else None
        return torch.stack(toks), probs

    # -- stream lifecycle ----------------------------------------------------

    def _open(self, rid: str, prompt: List[int]) -> Dict[str, Any]:
        """(Re)open one stream: bucketed padded prefill of the prompt into
        a fresh 1-row cache, committed offset = true length."""
        import torch

        from dlrover_tpu_torch.models import llama_infer

        p = np.asarray(prompt, np.int32)
        n = len(p)
        if n == 0 or n > self.max_len:
            raise DraftUnavailable(
                f"stream {rid!r}: prompt of {n} tokens outside "
                f"(0, {self.max_len}]"
            )
        layers = llama_infer.init_cache(
            self.cfg, 1, self.max_len, device=self.device, ring=False
        )["layers"]
        off = 0
        rem = n
        start = 0
        with torch.inference_mode():
            while rem > 0:
                b = next(
                    (x for x in self._buckets if x >= rem),
                    self._buckets[-1],
                )
                b = min(b, self.max_len - start)
                chunk = np.zeros((b,), np.int32)
                take = min(rem, b)
                chunk[:take] = p[start: start + take]
                self._score(layers, off, chunk)
                off += take
                start += take
                rem -= take
        st = {"cache": layers, "off": off}
        with self._mu:
            self._streams[rid] = st
            self._streams.move_to_end(rid)
            while len(self._streams) > self.max_streams:
                evicted, _ = self._streams.popitem(last=False)
                logger.info(
                    "draft %s: evicted stream %s (bound %d)",
                    self.worker_id, evicted, self.max_streams,
                )
        return st

    def warm(self) -> None:
        """Run the serving path's programs once (an open, a delta score
        and a roll) before the replica registers, so that the first real
        round pays no first-call set-up.  It bypasses :meth:`propose`:
        the roll counters stay zero."""
        import torch

        st = self._open("__warm", [1, 2, 3, 4])
        with torch.inference_mode():
            logits = self._score(st["cache"], st["off"],
                                 np.zeros((1,), np.int32))
            self._roll(st["cache"], st["off"] + 1, logits[0],
                       self.draft_k)
        self.close("__warm")

    def close(self, rid) -> None:
        with self._mu:
            self._streams.pop(str(rid), None)
            self._refused.pop(str(rid), None)

    def stream_count(self) -> int:
        with self._mu:
            return len(self._streams)

    def kv_stats(self) -> Dict[str, Any]:
        """The draft's KV memory view in the fleet's ``kv_occupancy``
        convention: committed stream tokens over stream capacity."""
        with self._mu:
            held = sum(int(st["off"]) for st in self._streams.values())
            n = len(self._streams)
        cap = self.max_streams * self.max_len
        return {
            "kv_occupancy": round(held / cap, 4) if cap else 0.0,
            "kv_tokens_held": held,
            "kv_token_capacity": cap,
            "streams": n,
        }

    # -- the proposal loop ---------------------------------------------------

    def propose(self, reqs: List[dict], k: int, sample: bool = False,
                close=()) -> Dict[str, Dict[str, Any]]:
        """One round of proposals for every stream in ``reqs``.  Each
        entry: ``{"rid", "ctx": [tokens emitted since the last roll],
        "open": [prompt]}`` (``open`` present = (re)open first).  Unknown
        streams without an ``open`` are skipped (absent from the result:
        the target re-opens them next round).  Returns ``{rid: {"d": [k
        ints], "q": [k, V] float32 | None}}``."""
        import torch

        k = max(1, min(int(k), self.draft_k))
        if sample != (self.temperature > 0.0):
            raise DraftUnavailable(
                f"sampling mismatch: target asked sample={sample}, "
                f"draft built with temperature={self.temperature}"
            )
        out: Dict[str, Dict[str, Any]] = {}
        with self._roll_mu, torch.inference_mode():
            for rid in close:
                self.close(rid)
            for req in reqs:
                rid = str(req["rid"])
                ctx = [int(t) for t in req.get("ctx") or []]
                with self._mu:
                    if rid in self._refused:
                        continue  # that stream rides plain for good
                    st = self._streams.get(rid)
                    if st is not None:
                        self._streams.move_to_end(rid)
                if req.get("open") is not None:
                    try:
                        st = self._open(rid, req["open"])
                    except DraftUnavailable as e:
                        # One stream's bad open must not fail the round
                        # for the others: that stream rides plain.
                        logger.warning(
                            "draft %s: open refused for %s: %s",
                            self.worker_id, rid, e,
                        )
                        with self._mu:
                            self._refused[rid] = True
                            while len(self._refused) > 256:
                                self._refused.popitem(last=False)
                        continue
                if st is None or not ctx:
                    # Unknown stream / empty delta: target reopens.
                    continue
                off = st["off"]
                L = len(ctx)
                # Per-round deltas (1..k+1) score at their length; a
                # longer catch-up pads to the next prompt bucket (the pad
                # keys sit past the committed offset, overwritten before
                # a later query sees them).
                if L <= self.draft_k + 1:
                    Lb = L
                else:
                    Lb = next(
                        (x for x in self._buckets if x >= L),
                        self._buckets[-1],
                    )
                if off + Lb + k > self.max_len:
                    # Out of cache: drop the stream; target rides plain.
                    self.close(rid)
                    continue
                chunk = np.zeros((Lb,), np.int32)
                chunk[:L] = np.asarray(ctx, np.int32)
                logits = self._score(st["cache"], off, chunk)
                # Proposals continue from the last real ctx token; the
                # roll writes from the committed offset on, over any pad.
                toks, probs = self._roll(st["cache"], off + L,
                                         logits[L - 1], k)
                # Commit exactly the shipped delta.
                st["off"] = off + L
                d = [int(t) for t in toks.cpu().numpy()]
                q = (probs.float().cpu().numpy() if sample else None)
                out[rid] = {"d": d, "q": q}
                self.proposed_tokens += k
            self.rolls += 1
        if self.round_floor_s > 0:
            # One batched roll = one draft-card round, scaled by the
            # roll's width (a k=1 probe costs one draft step).
            time.sleep(
                self.round_floor_s * k / max(1, self.draft_k)
            )
        return out


def handle_draft(worker: DraftWorker,
                 msg: Message) -> Optional[Message]:
    """The proposal server's dispatch, separable from the RPC wrapper
    so loopback fleets serve rolls with zero sockets."""
    if not isinstance(msg, DraftRoll):
        return BaseResponse(
            success=False,
            reason=f"unknown message {type(msg).__name__}",
        )
    try:
        props = worker.propose(
            msg.streams, msg.k, sample=msg.sample, close=msg.close
        )
    except Exception as e:  # noqa: BLE001 - a failed roll degrades
        logger.warning("draft %s: roll failed: %s", worker.worker_id, e)
        return DraftProposals(found=False, reason=str(e)[:200])
    return DraftProposals(found=True, payload=pack_proposals(props))


class DraftServer:
    """RPC front of one draft replica's :class:`DraftWorker` — the
    :class:`~dlrover_tpu_torch.serving.kvseg.KvSegmentServer` shape.  ``addr``
    is what the draft replica announces in its register and the
    gateway hands to spec targets."""

    def __init__(self, worker: DraftWorker, port: int = 0):
        from dlrover_tpu_torch.common.rpc import RpcServer, local_ip

        self.worker = worker
        self._server = RpcServer(port, self.handle)
        self._server.start()
        self.addr = f"{local_ip()}:{self._server.port}"

    def handle(self, msg: Message) -> Optional[Message]:
        return handle_draft(self.worker, msg)

    def stop(self) -> None:
        self._server.stop()


class RemoteDraftClient:
    """The proposal handle a spec target's ``DecodeServer`` consumes
    (``set_remote_draft``).  ``transport`` follows the repo calling
    convention (``call(msg, **kw) -> reply``) — an RpcClient against a
    real draft server or a loopback for in-process fleets.  Every
    failure mode (transport, found=False, torn bundle) converges on
    :class:`DraftUnavailable`; the serve loop then decodes plain."""

    def __init__(self, transport, replica_id: str = "",
                 timeout: float = 10.0):
        self._t = transport
        self._replica_id = replica_id
        self._timeout = timeout

    def propose(self, reqs: List[dict], k: int, sample: bool = False,
                close=()) -> Dict[str, Dict[str, Any]]:
        try:
            resp = self._t.call(DraftRoll(
                replica_id=self._replica_id, k=int(k),
                sample=bool(sample), streams=list(reqs),
                close=[str(r) for r in close],
            ))
        except Exception as e:  # noqa: BLE001 - converge
            raise DraftUnavailable(f"draft roll failed: {e}") from e
        if not isinstance(resp, DraftProposals) or not resp.found:
            raise DraftUnavailable(
                "draft roll refused: "
                f"{getattr(resp, 'reason', 'bad reply type')}"
            )
        return unpack_proposals(resp.payload)

    def close(self) -> None:
        close = getattr(self._t, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 - teardown
                logger.debug("draft client close failed", exc_info=True)


def connect_remote_draft(addr: str, replica_id: str = "",
                         timeout: float = 10.0) -> RemoteDraftClient:
    """Default addr -> handle factory (the replica runner's
    ``draft_connect``): one RpcClient per draft endpoint."""
    from dlrover_tpu_torch.common.rpc import RpcClient

    return RemoteDraftClient(
        RpcClient(addr, timeout=timeout), replica_id=replica_id,
        timeout=timeout,
    )


class DraftReplicaRunner:
    """The draft replica's control loop: register as the ``draft``
    role (announcing the proposal server's address), heartbeat-poll so
    the gateway's lease keeps the draft visible, honour the drain
    flag, deregister.  Proposals themselves ride the
    :class:`DraftServer` data plane — the gateway never sees them."""

    def __init__(
        self,
        server,  # DraftServer (or anything with .worker and .addr)
        transport,
        replica_id: str,
        poll_interval: float = 0.2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.server = server
        self.transport = transport
        self.replica_id = replica_id
        self.poll_interval = poll_interval
        self._clock = clock
        self._stop = threading.Event()
        self.draining = False

    def register(self) -> None:
        self._call_quiet(ServeReplicaRegister(
            replica_id=self.replica_id,
            slots=self.server.worker.max_streams,
            role="draft", spec=True, draft_addr=self.server.addr,
        ))

    def run(self) -> None:
        """Blocking: register, heartbeat until drained/stopped,
        deregister, stop the proposal server."""
        self.register()
        try:
            while not self._stop.wait(self.poll_interval):
                w = self.server.worker
                reply = self._call_quiet(ServeReplicaPoll(
                    replica_id=self.replica_id, free_slots=0,
                    active=[], stats={
                        "role": "draft",
                        "rolls": w.rolls,
                        "proposed_tokens": w.proposed_tokens,
                        # Memory view: committed stream
                        # tokens over capacity — the draft pool's
                        # kv_occupancy in the gateway snapshot.
                        **w.kv_stats(),
                    },
                ))
                if isinstance(reply, ServeGrants):
                    if not reply.known:
                        self.register()
                    if reply.drain:
                        self.draining = True
                        break
        finally:
            self._call_quiet(ServeReplicaDeregister(
                replica_id=self.replica_id
            ))
            stop = getattr(self.server, "stop", None)
            if stop is not None:
                stop()

    def stop(self) -> None:
        self._stop.set()

    def _call_quiet(self, msg):
        try:
            return self.transport.call(msg)
        except Exception as e:  # noqa: BLE001 - best-effort control
            logger.warning(
                "draft %s: %s to gateway failed: %s",
                self.replica_id, type(msg).__name__, e,
            )
            return None
