"""Drain-aware serving replica: the fleet's worker loop — the port's
copy of ``dlrover_tpu/serving/replica.py`` (``CompletionJournal``,
``ReplicaRunner``: unified, prefill and decode roles, P2P and relayed KV,
remote-draft attachment, journal replay; ``prefix_fingerprint``), held
against it.

:class:`ReplicaRunner` turns one continuous-batching ``DecodeServer``
into a gateway-fed replica: it registers, then rides the server's
incremental admission surface (``serve_incremental`` + ``submit``) —
the runner's ``tick`` runs at every admission point of the decode loop,
where it polls the gateway with its free-slot count, feeds grants into
slots as they free, streams the round's tokens back, journals and
reports completions, and honours cancels and the drain flag.

Exactly-once across a kill is a two-party contract:

- the runner journals a completion (fsync'd JSON line keyed by request
  id + prompt hash) BEFORE reporting it, so a kill between the two is
  replayed from the journal at restart (``replayed=True`` reports);
- the gateway dedupes completions by request id, so the replay racing a
  re-dispatch on another replica can never answer a client twice.

The generalized form of ``serve_elastic.py``'s role: the journal contract
is ``serve_journaled``'s, lifted from a fixed prompt list to a gateway
request stream.

No torch at module level — the decode server is injected, so the gateway
side of a fleet (and every unit test of the runner's protocol) runs
without the model stack.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.messages import (
    ServeDone,
    ServeGrants,
    ServeKvReady,
    ServeKvReject,
    ServeReplicaDeregister,
    ServeReplicaPoll,
    ServeReplicaRegister,
    ServeTokens,
)


def _prompt_hash(prompt) -> str:
    return hashlib.sha1(
        np.asarray(prompt, np.int32).tobytes()
    ).hexdigest()[:16]


def prefix_fingerprint(tokens) -> str:
    """Fingerprint of a shared prefix template: what requests
    carry for prefix-aware routing, what replicas report as warm, and
    what keys ``DecodeServer``'s template store.  The journal's prompt
    hash family, defined HERE (torch-free) so clients and the gateway can
    compute it without the model stack; ``llama_infer`` delegates."""
    return _prompt_hash(tokens)


class CompletionJournal:
    """Append-only fsync'd completion journal keyed by (req_id, prompt
    hash) — ``serve_journaled``'s record format on a request stream.  A
    torn tail from a SIGKILL mid-append is truncated away before the
    first new append; records whose prompt hash mismatches a re-granted
    request are ignored (journal-path reuse must re-serve, not replay
    stale tokens).

    BOUNDED: only the newest ``max_records`` completions are retained
    (memory and disk both) — the journal's job is crash recovery of
    RECENT work, not an archive; a long-lived replica must not grow
    its RSS and fsync file forever.  Compaction rewrites the file
    atomically once it exceeds the cap by 25% slack (amortized cost)."""

    def __init__(self, path: str, max_records: int = 10000):
        self.path = path
        self.max_records = max_records
        self._records: Dict[str, Dict[str, Any]] = {}
        self._f = None
        self._load()
        if len(self._records) > self.max_records:
            self._compact()

    def _load(self) -> None:
        try:
            with open(self.path, "r+") as f:
                content = f.read()
                cut = content.rfind("\n") + 1
                if cut < len(content):
                    f.truncate(cut)
                for line in content[:cut].split("\n"):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue  # torn line persisted by an old writer
                    self._records[str(rec["rid"])] = rec
        except OSError:
            pass  # no journal yet

    def replayable(self) -> Dict[str, Dict[str, Any]]:
        return dict(self._records)

    def lookup(self, req_id: str, prompt) -> Optional[List[int]]:
        rec = self.lookup_record(req_id, prompt)
        if rec is None:
            return None
        return [int(t) for t in rec["tokens"]]

    def lookup_record(self, req_id: str,
                      prompt) -> Optional[Dict[str, Any]]:
        """The full journal record (tokens + per-request telemetry) —
        what replay paths report from, so a replayed completion
        carries the SAME acceptance numbers it earned live."""
        rec = self._records.get(req_id)
        if rec is None or rec.get("ph") != _prompt_hash(prompt):
            return None
        return rec

    def append(self, req_id: str, prompt, tokens,
               extra: Optional[Dict[str, Any]] = None) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        rec = {
            "rid": req_id,
            "ph": _prompt_hash(prompt),
            "tokens": [int(t) for t in tokens],
        }
        if extra:
            rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        self._records[req_id] = rec
        if len(self._records) >= self.max_records + max(
            64, self.max_records // 4
        ):
            self._compact()

    def _compact(self) -> None:
        """Trim to the newest ``max_records`` and rewrite the file
        atomically (tmp + rename; the old handle is replaced)."""
        drop = len(self._records) - self.max_records
        if drop > 0:
            for req_id in list(self._records)[:drop]:
                del self._records[req_id]
        if self._f is not None:
            self._f.close()
            self._f = None
        tmp = self.path + ".compact"
        with open(tmp, "w") as f:
            for rec in self._records.values():
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class ReplicaRunner:
    """One replica's control loop (see module docstring).

    ``transport`` follows the repo RPC calling convention
    (``call(msg, **kw) -> reply``): an ``RpcClient`` against a real
    gateway or a ``LoopbackTransport`` for in-process fleets.
    """

    def __init__(
        self,
        server,  # DecodeServer (or any object with its serve surface)
        transport,
        replica_id: str,
        journal_path: Optional[str] = None,
        poll_interval: float = 0.05,
        round_floor_s: float = 0.0,
        replay_limit: int = 256,
        role: str = "unified",  # unified | prefill | decode
        kv_p2p: bool = True,
        kv_server=None,  # injectable KvSegmentServer (tests)
        kv_connect=None,  # addr -> transport override for pulls (tests)
        draft_connect=None,  # addr -> proposal handle override (tests)
        clock=time.monotonic,
    ):
        self.server = server
        self.transport = transport
        self.replica_id = replica_id
        self.role = role or "unified"
        #: Peer-to-peer KV handoff: when True, a prefill
        #: grant WITHOUT ``kv_relay`` publishes the exported segment on
        #: this replica's segment server and sends the gateway only a
        #: ticket; the decode replica pulls the bytes directly.  The
        #: segment server is started lazily on the first P2P prefill
        #: (decode-only and unified-relay fleets never pay the port).
        self.kv_p2p = kv_p2p
        self._kv_server = kv_server
        self._kv_connect = kv_connect
        #: addr -> cached pull client: a decode replica pulls from the
        #: same few prefill peers over and over — per-pull channel
        #: setup would put connection churn on the data-plane hot path.
        self._kv_clients: Dict[str, Any] = {}
        #: Remote-draft attachment: when the server is
        #: spec-remote capable, every poll reply's ``draft_addr`` is
        #: applied — a new address builds a proposal handle via
        #: ``draft_connect`` (default: one RpcClient per endpoint) and
        #: hands it to ``DecodeServer.set_remote_draft``; "" detaches.
        self._draft_connect = draft_connect
        self._draft_addr = ""
        self._draft_handle = None
        self._draft_failures_seen = 0
        self.journal = (
            CompletionJournal(journal_path) if journal_path else None
        )
        self.poll_interval = poll_interval
        self.replay_limit = replay_limit
        #: Optional per-round latency floor: models the device-bound
        #: regime on hosts where decode compute shares the CPU with the
        #: control plane.  The sleep sits
        #: in tick — between dispatch rounds — exactly where a blocking
        #: device future would.
        self.round_floor_s = round_floor_s
        self._clock = clock
        self._last_poll = 0.0
        self._draining = False
        self._stopped = False
        self._journal_replayed = False
        self._granted: Dict[str, Dict[str, Any]] = {}  # rid -> grant
        #: rid -> grant trace context: the gateway's trace
        #: id + parent span id for this replica's detail spans.
        self._traces: Dict[str, Dict[str, str]] = {}
        self._stream_buf: Dict[str, List[int]] = {}
        self._first_token_at: Dict[str, float] = {}
        self._admitted_at: Dict[str, float] = {}
        # Sliding-window throughput accounting for the poll stats.
        self._win_start = clock()
        self._win_tokens = 0
        self._last_tps = 0.0
        self._last_ttft_ms = 0.0
        self.served = 0
        self.replayed = 0
        self.dropped = 0
        self.prefilled = 0  # KV segments produced (prefill role)
        self.kv_rejected = 0  # torn segments refused (decode role)
        self.kv_published = 0  # segments published P2P (prefill role)
        self.kv_pulled = 0  # segments pulled P2P (decode role)
        self.kv_pull_failed = 0  # pulls that fell to the relay ladder

    # -- protocol steps ---------------------------------------------------

    def register(self) -> None:
        # Best-effort like every other control-plane send: a gateway
        # still booting (or flapping again right after a known=False
        # poll) must not kill the replica — the next poll's
        # known=False reply retries the registration.
        self._call_quiet(ServeReplicaRegister(
            replica_id=self.replica_id, slots=self.server.slots,
            role=self.role,
            spec=bool(getattr(self.server, "spec_capable", False)),
        ))
        if self.journal is not None and not self._journal_replayed:
            # Journal replay, ONCE per incarnation: report every
            # completed request before any new work — the gateway's
            # dedupe makes this idempotent, so a restarted replica can
            # never lose a finished request nor decode it twice.  A
            # later re-register (gateway flap) skips the bulk replay —
            # a restarted gateway answers "unknown" for all of it, and
            # any request it re-dispatches hits the journal at grant
            # time anyway (the _admit lookup).
            self._journal_replayed = True
            # Eager replay covers only the NEWEST records: the gateway
            # only cares about completions it still tracks (recent
            # in-flight work); a full 10k-record replay would be tens
            # of seconds of sequential RPCs with no polls — long past
            # the lease timeout, so the gateway would declare the
            # freshly registered replica dead mid-replay.  Older
            # records still answer re-dispatched grants through the
            # _admit journal lookup.
            items = list(self.journal.replayable().items())
            for req_id, rec in items[-self.replay_limit:]:
                self.replayed += 1
                self._call_quiet(ServeDone(
                    replica_id=self.replica_id, req_id=req_id,
                    tokens=[int(t) for t in rec["tokens"]],
                    ok=True, replayed=True,
                    # Telemetry rides the journal: a replay
                    # reports the acceptance the request earned live.
                    tokens_per_round=float(rec.get("tpr", 0.0)),
                    spec_rounds=int(rec.get("spr", 0)),
                    trace=self._replay_trace(req_id, rec),
                ))

    def run(self) -> None:
        """Blocking: register, serve until drained, deregister."""
        self.register()
        try:
            self.server.serve_incremental(
                tick=self.tick,
                on_finish=self._on_finish,
                on_token=self._on_token,
            )
        finally:
            self._call_quiet(ServeReplicaDeregister(
                replica_id=self.replica_id
            ))
            if self.journal is not None:
                self.journal.close()
            if self._kv_server is not None:
                # Un-pulled publications die with the replica; the
                # gateway's reject->relay ladder re-prefills them.
                stop = getattr(self._kv_server, "stop", None)
                if stop is not None:
                    stop()
            for cli in self._kv_clients.values():
                close = getattr(cli, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 - teardown
                        logger.debug("kv pull client close failed",
                                     exc_info=True)
            self._kv_clients.clear()
            if self._draft_handle is not None:
                close = getattr(self._draft_handle, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:  # noqa: BLE001 - teardown
                        logger.debug("draft handle close failed",
                                     exc_info=True)
                self._draft_handle = None

    def tick(self) -> bool:
        """One admission-point visit from the decode loop: rate-limited
        gateway poll + stream flush.  Returns False once draining is
        complete (the serve loop then finishes in-flight work and
        returns)."""
        if self.round_floor_s > 0:
            time.sleep(self.round_floor_s)
        now = self._clock()
        if now - self._last_poll < self.poll_interval:
            return not self._stopped and not self._done_draining()
        self._last_poll = now
        self._flush_streams()
        warm = getattr(self.server, "warm_prefix_fps", None)
        reply = self._call_quiet(ServeReplicaPoll(
            replica_id=self.replica_id,
            free_slots=self.server.free_slots(),
            active=self._owned_rids(),
            stats=self._stats(),
            warm_prefixes=list(warm()) if warm is not None else [],
        ))
        if isinstance(reply, ServeGrants):
            if not reply.known:
                # Gateway restarted: re-register (and re-replay the
                # journal — dedupe makes it cheap) before the next poll.
                logger.info(
                    "replica %s: gateway lost us; re-registering",
                    self.replica_id,
                )
                self.register()
            for rid_key in reply.cancel:
                # Pending: drop before admission.  In-flight: shed the
                # slot mid-decode (abort discards the partial output
                # and frees the slot for live work — a deadline-expired
                # request must not occupy a slot to its full budget).
                abort = getattr(self.server, "abort", None)
                if self.server.cancel(rid_key) or (
                    abort is not None and abort(rid_key)
                ):
                    self._forget(rid_key)
            for grant in reply.requests:
                self._admit(grant)
            # A handle failure latches the serve loop onto plain
            # decode until a NEW handle attaches — so a TRANSIENT
            # draft fault (one timed-out roll) must trigger a
            # reconnect even when the gateway keeps offering the same
            # unchanged address: drop our record of it and let this
            # very reply's offer rebuild the handle.  Rate-limited
            # naturally: one reconnect per observed failure, and a
            # genuinely dead draft ages out of the gateway's offers
            # within a lease.
            last = getattr(self.server, "last_stats", None) or {}
            fails = int(last.get("spec_draft_failures", 0))
            if fails > self._draft_failures_seen:
                self._draft_failures_seen = fails
                self._draft_addr = ""
            self._apply_draft_addr(getattr(reply, "draft_addr", ""))
            if reply.drain:
                self._draining = True
        return not self._stopped and not self._done_draining()

    def _apply_draft_addr(self, addr: str) -> None:
        """Attach/detach the remote draft per the gateway's current
        endpoint.  Only spec-remote servers participate; a
        server with a LOCAL draft keeps it.  A changed address (draft
        relaunch lands on a new port) rebuilds the handle — which also
        resets the serve loop's dead-draft latch."""
        if not getattr(self.server, "spec_remote", False):
            return
        if addr == self._draft_addr:
            return
        old, self._draft_handle = self._draft_handle, None
        if old is not None:
            close = getattr(old, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:  # noqa: BLE001 - teardown
                    logger.debug("draft handle close failed",
                                 exc_info=True)
        self._draft_addr = addr
        if addr:
            try:
                if self._draft_connect is not None:
                    self._draft_handle = self._draft_connect(addr)
                else:
                    from dlrover_tpu_torch.serving.draft import (
                        connect_remote_draft,
                    )

                    self._draft_handle = connect_remote_draft(
                        addr, replica_id=self.replica_id
                    )
            except Exception as e:  # noqa: BLE001 - plain decode
                logger.warning(
                    "replica %s: draft connect to %s failed: %s",
                    self.replica_id, addr, e,
                )
                self._draft_handle = None
                self._draft_addr = ""
        logger.info(
            "replica %s: remote draft %s", self.replica_id,
            addr or "detached",
        )
        self.server.set_remote_draft(self._draft_handle)

    # -- internals --------------------------------------------------------

    def _replay_trace(self, req_id: str, rec: Dict[str, Any]) -> dict:
        """Trace context of a journal replay: the id the
        request earned when served live (``tr`` in the record), plus a
        replay span so the resurrection is VISIBLE in the merged trace,
        not a duplicate trace.  A record WITHOUT ``tr`` was served
        unsampled (or pre-trace): the replay must stay unsampled too —
        fabricating a derived id here would punch through head-based
        sampling and break the sampled/unsampled accounting."""
        tid = str(rec.get("tr") or "")
        if not tid:
            return {}
        return {"tid": tid}

    def stop(self) -> None:
        """End the serve loop at its next tick, without a drain: what a
        replica whose host went away looks like to its gateways (the
        in-flight work is finished, nothing new is taken).  The reference
        reaches the same flag through its chaos site."""
        self._stopped = True

    def _done_draining(self) -> bool:
        return self._draining and not self._owned_rids()

    def _owned_rids(self) -> List[str]:
        return list(self.server.active_rids()) + \
            list(self.server.pending_rids())

    def _admit(self, grant) -> None:
        rid_key = grant.req_id
        stage = getattr(grant, "stage", "full") or "full"
        if stage == "prefill":
            self._handle_prefill(grant)
            return
        if rid_key in self._granted or rid_key in self._owned_rids():
            return  # duplicate grant (shouldn't happen; be safe)
        gtrace = dict(getattr(grant, "trace", None) or {})
        if self.journal is not None:
            cached = self.journal.lookup_record(rid_key, grant.prompt)
            if cached is not None:
                # This replica already served it in a previous
                # incarnation: answer from the journal, never re-decode
                # (a decode-grant's shipped segment is simply unused —
                # the gateway drops it at the terminal completion).
                self.replayed += 1
                self._call_quiet(ServeDone(
                    replica_id=self.replica_id, req_id=rid_key,
                    tokens=[int(t) for t in cached["tokens"]],
                    ok=True, replayed=True,
                    tokens_per_round=float(cached.get("tpr", 0.0)),
                    spec_rounds=int(cached.get("spr", 0)),
                    trace=self._replay_trace(rid_key, cached),
                ))
                return
        tid = str(gtrace.get("tid", ""))
        psid = str(gtrace.get("sid", ""))
        try:
            if stage == "decode":
                # Disaggregated decode: verify + admit the
                # shipped KV segment.  A torn segment is NEVER decoded
                # from — the gateway re-prefills on the reject.
                # A grant carrying a TICKET (kv_addr) means
                # the bytes live on the prefill replica's segment
                # server — pull them directly; a failed pull rides the
                # same reject ladder (the gateway re-prefills in relay
                # mode).
                payload = grant.kv
                if getattr(grant, "kv_addr", ""):
                    from dlrover_tpu_torch.serving.kvseg import (
                        KvPullError,
                        pull_kv_segment,
                    )

                    try:
                        payload = pull_kv_segment(
                            grant.kv_addr, rid_key, grant.kv_fp,
                            grant.kv_crc32, grant.kv_nbytes,
                            transport=self._kv_transport(
                                grant.kv_addr
                            ),
                        )
                        self.kv_pulled += 1
                    except KvPullError as e:
                        self.kv_pull_failed += 1
                        logger.warning(
                            "replica %s: KV pull for %s failed: %s",
                            self.replica_id, rid_key, e,
                        )
                        self._call_quiet(ServeKvReject(
                            replica_id=self.replica_id,
                            req_id=rid_key,
                            reason=f"pull: {str(e)[:200]}",
                        ))
                        return
                self.server.import_kv(
                    rid_key, payload,
                    np.asarray(grant.prompt, np.int32),
                    grant.max_new_tokens,
                )
            else:
                kw = {}
                if getattr(grant, "prefix_len", 0):
                    # Only prefixed grants ride the kwargs — plain
                    # submits keep working against any server with the
                    # bare (rid, prompt, mnt) surface.
                    kw = {
                        "prefix_len": grant.prefix_len,
                        "prefix_fp": getattr(grant, "prefix_fp", ""),
                    }
                self.server.submit(
                    rid_key, np.asarray(grant.prompt, np.int32),
                    grant.max_new_tokens, **kw,
                )
        except ValueError as e:
            if stage == "decode" and getattr(e, "KV_REJECT", False):
                self.kv_rejected += 1
                logger.warning(
                    "replica %s: KV segment for %s rejected: %s",
                    self.replica_id, rid_key, e,
                )
                self._call_quiet(ServeKvReject(
                    replica_id=self.replica_id, req_id=rid_key,
                    reason=str(e)[:200],
                ))
                return
            # Can never fit this replica's cache: a terminal, visible
            # failure beats a silent requeue loop.
            self._call_quiet(ServeDone(
                replica_id=self.replica_id, req_id=rid_key,
                tokens=[], ok=False, reason=f"capacity: {e}",
            ))
            return
        self._granted[rid_key] = {
            "prompt": [int(t) for t in grant.prompt],
        }
        if tid:
            self._traces[rid_key] = {"tid": tid, "sid": psid}
        self._admitted_at[rid_key] = self._clock()

    def _handle_prefill(self, grant) -> None:
        """Prefill-grant path, host-synchronous within the
        tick: score the prompt, export the KV segment, report
        kv-ready.  Failure modes all converge on the gateway's
        recovery ladder: a capacity error fails terminally, a lost
        payload (a failed
        send) leaves the rid unowned so the 2-poll reconcile
        re-dispatches the prefill."""
        rid_key = grant.req_id
        gtrace = dict(getattr(grant, "trace", None) or {})
        tid = str(gtrace.get("tid", ""))
        psid = str(gtrace.get("sid", ""))
        try:
            self.server.prefill_request(
                rid_key, np.asarray(grant.prompt, np.int32),
                grant.max_new_tokens,
                prefix_len=getattr(grant, "prefix_len", 0),
                prefix_fp=getattr(grant, "prefix_fp", ""),
            )
            payload, fp32_bytes = self.server.export_kv(rid_key)
        except ValueError as e:
            self._call_quiet(ServeDone(
                replica_id=self.replica_id, req_id=rid_key,
                tokens=[], ok=False, reason=f"prefill: {e}",
            ))
            return
        self.prefilled += 1
        relay = getattr(grant, "kv_relay", False) or not self.kv_p2p
        if not relay:
            # P2P: publish locally, ship only the ticket.
            server = self._ensure_kv_server()
            if server is None:
                relay = True  # segment server unavailable: relay
        if not relay:
            ticket = server.store.put(rid_key, payload)
            if ticket is None:
                # The store could not retain the segment (oversized,
                # or evicted by the publication pressure the bound
                # exists for): shipping a dead ticket would burn an
                # attempt on a guaranteed-failed pull — relay instead.
                logger.warning(
                    "replica %s: segment for %s not retainable "
                    "(%d bytes); relaying through the gateway",
                    self.replica_id, rid_key, len(payload),
                )
                relay = True
        # The kv-ready report carries the grant's trace context back
        #: a gateway that adopted this request after a
        # failover (and admitted it untraced) joins the original trace
        # at the handoff, the same contract as ServeDone.trace.
        ktrace = {"tid": tid, "sid": psid} if tid else {}
        if not relay:
            seg_fp, crc, nb = ticket
            self.kv_published += 1
            self._call_quiet(ServeKvReady(
                replica_id=self.replica_id, req_id=rid_key,
                fp32_bytes=int(fp32_bytes), addr=server.addr,
                seg_fp=seg_fp, crc32=crc, nbytes=nb, trace=ktrace,
            ))
            return
        self._call_quiet(ServeKvReady(
            replica_id=self.replica_id, req_id=rid_key,
            payload=payload, fp32_bytes=int(fp32_bytes), trace=ktrace,
        ))

    def _kv_transport(self, addr: str):
        """Cached pull transport per peer address (bounded; LRU-ish
        oldest-first eviction closes the retired client)."""
        if self._kv_connect is not None:
            return self._kv_connect(addr)
        cli = self._kv_clients.get(addr)
        if cli is None:
            from dlrover_tpu_torch.common.rpc import RpcClient

            cli = RpcClient(addr, timeout=10.0)
            self._kv_clients[addr] = cli
            while len(self._kv_clients) > 16:
                old = self._kv_clients.pop(
                    next(iter(self._kv_clients))
                )
                try:
                    old.close()
                except Exception:  # noqa: BLE001 - teardown
                    logger.debug("kv pull client close failed",
                                 exc_info=True)
        return cli

    def _ensure_kv_server(self):
        """Lazy segment server for P2P publishes; a failure to bind
        degrades to the relay path rather than killing the replica."""
        if self._kv_server is None:
            try:
                from dlrover_tpu_torch.serving.kvseg import KvSegmentServer

                self._kv_server = KvSegmentServer()
                logger.info(
                    "replica %s: KV segment server on %s",
                    self.replica_id, self._kv_server.addr,
                )
            except Exception as e:  # noqa: BLE001 - degrade to relay
                logger.warning(
                    "replica %s: KV segment server failed (%s); "
                    "relaying segments through the gateway",
                    self.replica_id, e,
                )
                self.kv_p2p = False
                return None
        return self._kv_server

    def _on_token(self, rid_key, tok) -> None:
        self._stream_buf.setdefault(rid_key, []).append(int(tok))
        self._win_tokens += 1
        if rid_key not in self._first_token_at:
            now = self._clock()
            self._first_token_at[rid_key] = now
            admitted = self._admitted_at.get(rid_key)
            if admitted is not None:
                self._last_ttft_ms = (now - admitted) * 1000.0

    def _on_finish(self, rid_key, tokens) -> None:
        grant = self._granted.get(rid_key)
        prompt = grant["prompt"] if grant else []
        # The result contract strips the echoed prompt: the gateway
        # client gets exactly the NEW tokens (the journal stores the
        # same, so replay and fresh serve agree byte-for-byte).
        new_tokens = [int(t) for t in tokens[len(prompt):]]
        # Per-request speculation telemetry: journaled WITH
        # the completion so replay reports what the request earned.
        pop = getattr(self.server, "pop_request_stats", None)
        st = pop(rid_key) if pop is not None else None
        tpr = round(float(st["tokens_per_round"]), 3) if st else 0.0
        spr = int(st["spec_rounds"]) if st else 0
        trace = self._traces.get(rid_key)
        extra: Dict[str, Any] = {}
        if st:
            extra["tpr"] = tpr
            extra["spr"] = spr
        if trace is not None:
            # The trace id rides the journal record so a replay joins
            # the ORIGINAL trace.
            extra["tr"] = trace["tid"]
        if self.journal is not None:
            self.journal.append(
                rid_key, prompt, new_tokens, extra=extra or None,
            )
        self.served += 1
        self._flush_streams(only=rid_key)
        self._call_quiet(ServeDone(
            replica_id=self.replica_id, req_id=rid_key,
            tokens=new_tokens, ok=True,
            tokens_per_round=tpr, spec_rounds=spr,
        ))
        self._forget(rid_key)

    def _forget(self, rid_key) -> None:
        self._granted.pop(rid_key, None)
        self._traces.pop(rid_key, None)
        self._stream_buf.pop(rid_key, None)
        self._admitted_at.pop(rid_key, None)
        self._first_token_at.pop(rid_key, None)

    def _flush_streams(self, only=None) -> None:
        keys = [only] if only is not None else list(self._stream_buf)
        for rid_key in keys:
            buf = self._stream_buf.get(rid_key)
            if not buf:
                continue
            self._stream_buf[rid_key] = []
            self._call_quiet(ServeTokens(
                replica_id=self.replica_id, req_id=rid_key,
                tokens=buf,
            ))

    def _stats(self) -> Dict[str, Any]:
        now = self._clock()
        span = now - self._win_start
        if span >= 1.0:
            self._last_tps = self._win_tokens / span
            self._win_start = now
            self._win_tokens = 0
        active = len(self.server.active_rids())
        stats = {
            "slot_occupancy": active / max(1, self.server.slots),
            # Memory occupancy in BOTH modes: block-pool utilization under paged KV, the slot
            # fraction otherwise — one continuous signal, so autoscale
            # hysteresis sees no discontinuity at the flag flip.
            "kv_occupancy": active / max(1, self.server.slots),
            "queue_depth": self.server.pending_count(),
            "tokens_per_sec": round(self._last_tps, 2),
            "ttft_ms_last": round(self._last_ttft_ms, 2),
            "served": self.served,
            "replayed": self.replayed,
            "role": self.role,
        }
        blocks = getattr(self.server, "block_stats", None)
        blocks = blocks() if blocks is not None else None
        if blocks is not None:
            stats["kv_occupancy"] = round(
                blocks["block_occupancy"], 4
            )
            stats["free_blocks"] = int(blocks["free_blocks"])
            stats["total_blocks"] = int(blocks["total_blocks"])
            stats["preemptions"] = int(blocks["preemptions"])
        if self.prefilled:
            stats["prefilled"] = self.prefilled
        if self.kv_published:
            stats["kv_published"] = self.kv_published
        if self.kv_pulled or self.kv_pull_failed:
            stats["kv_pulled"] = self.kv_pulled
            stats["kv_pull_failed"] = self.kv_pull_failed
        hits = getattr(self.server, "prefix_hits", None)
        if hits is not None:
            # Template hit/miss telemetry: how well the router's
            # residency map matches this replica's actual store.
            stats["prefix_hits"] = hits
            stats["prefix_misses"] = self.server.prefix_misses
        last = getattr(self.server, "last_stats", None)
        if last and "tokens_per_round" in last:
            # Speculative acceptance (or plain tokens/round) telemetry.
            stats["tokens_per_round"] = round(
                last["tokens_per_round"], 3
            )
        if last and last.get("path") == "spec":
            # Cumulative spec counters: the gateway folds
            # these as deltas into its fleet-wide spec_* counters.
            stats["spec_rounds"] = int(last.get("rounds", 0))
            stats["spec_accepted"] = int(
                last.get("accepted_tokens", 0)
            )
            stats["spec_fallbacks"] = int(
                last.get("spec_fallback_rounds", 0)
            )
            stats["spec_draft_failures"] = int(
                last.get("spec_draft_failures", 0)
            )
        return stats

    def _call_quiet(self, msg):
        """Control-plane sends are best-effort from the decode loop's
        perspective: a flapping gateway must not kill the replica (the
        lease/reconcile machinery recovers the state)."""
        try:
            return self.transport.call(msg)
        except Exception as e:  # noqa: BLE001
            logger.warning(
                "replica %s: %s to gateway failed: %s",
                self.replica_id, type(msg).__name__, e,
            )
            return None
