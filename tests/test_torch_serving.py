"""The port's serving fleet (``dlrover_tpu_torch/serving/``, the serving
messages of ``common/messages.py`` and ``agent/metrics.py``) against the
JAX package's ``dlrover_tpu/serving/``.

- every serving message's bytes are equal in both packages and each
  decodes the other's, its empty wire-optional fields left off alike;
- ``GatewayCore`` scripted alike in both packages under one stepped clock
  (the reference at ``trace_sample=0``, so no span id is drawn) gives
  equal replies and ``stats_snapshot``s: admission, backpressure,
  dedupe, prefix- and spec-aware routing, leases and requeue, the
  two-stage prefill/decode grants, deadlines and drain;
- the autoscaler's decisions, ``Histogram``'s percentiles and states,
  ``pack_proposals`` bundles and ``CompletionJournal`` files are equal;
- a port ``ReplicaRunner`` serves a reference ``GatewayCore`` (and the
  reverse) through a loopback that encodes in one package and decodes in
  the other: every request completes exactly once with the greedy tokens.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.agent import metrics as jmetrics
from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu.serving import autoscale as jauto
from dlrover_tpu.serving import draft as jdraft
from dlrover_tpu.serving import gateway as jgw
from dlrover_tpu.serving import replica as jrep
from dlrover_tpu_torch.agent import metrics as tmetrics
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.serving import autoscale as tauto
from dlrover_tpu_torch.serving import draft as tdraft
from dlrover_tpu_torch.serving import gateway as tgw
from dlrover_tpu_torch.serving import replica as trep

SERVING_MESSAGES = [
    "ServeSubmit", "ServeAck", "ServeStatusRequest", "ServeStatusReply",
    "ServeReplicaRegister", "ServeReplicaDeregister", "ServeReplicaPoll",
    "ServeGrants", "ServeTokens", "ServeDone", "ServeKvReady",
    "KvSegmentFetch", "KvSegmentData", "DraftRoll", "DraftProposals",
    "ServeKvReject", "ServeDrainRequest", "ServeFleetStatsRequest",
    "ServeFleetStats",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sample(f: dataclasses.Field):
    """A non-empty value of a field's type (from its default)."""
    d = f.default if f.default is not dataclasses.MISSING \
        else f.default_factory()
    if isinstance(d, bool):
        return not d
    if isinstance(d, int):
        return d + 3
    if isinstance(d, float):
        return d + 0.25
    if isinstance(d, str):
        return d + "x"
    if isinstance(d, bytes):
        return b"\x00\x01ab"
    if isinstance(d, list):
        return [1, 2, 3]
    if isinstance(d, dict):
        return {"tid": "abc", "n": 2}
    raise AssertionError(f"no sample for {f.name}")


@pytest.mark.parametrize("name", SERVING_MESSAGES)
def test_serving_message_bytes_equal_both_ways(name):
    jcls, tcls = getattr(jmsg, name), getattr(tmsg, name)
    assert [f.name for f in dataclasses.fields(jcls)] == \
        [f.name for f in dataclasses.fields(tcls)]
    assert jcls._WIRE_OPTIONAL == tcls._WIRE_OPTIONAL
    full = {f.name: _sample(f) for f in dataclasses.fields(jcls)}
    for kw in ({}, full):
        jm, tm = jcls(**kw), tcls(**kw)
        wire = jmsg.serialize(jm)
        assert tmsg.serialize(tm) == wire
        assert dataclasses.asdict(tmsg.deserialize(wire)) == \
            dataclasses.asdict(tm)
        assert dataclasses.asdict(jmsg.deserialize(tmsg.serialize(tm))) == \
            dataclasses.asdict(jm)


# -- GatewayCore scripted alike ----------------------------------------------------

class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _wire(x, msg_mod):
    if isinstance(x, msg_mod.Message):
        return msg_mod.serialize(x)
    return x


def _script(gw_mod, msg_mod):
    """Drive one GatewayCore through the fleet's protocol; return every
    reply (messages as wire bytes) and the final snapshot."""
    clock = Clock()
    cfg = gw_mod.GatewayConfig(queue_cap=7, lease_timeout_s=3.0,
                               trace_sample=0.0, spec_decode_min_tokens=8,
                               prefix_reserve_s=0.5)
    core = gw_mod.GatewayCore(cfg, clock=clock)
    out = []

    def rec(x):
        out.append(_wire(x, msg_mod))

    core.register("u0", 2)
    core.register("s0", 2, spec=True)
    core.register("d0", 4, role="draft", spec=True, draft_addr="h:1")
    for i in range(9):
        rec(core.submit(f"q{i}", [1, 2, 3, i + 1], 4 + 2 * i,
                        deadline_s=5.0 if i == 3 else 0.0,
                        prefix_len=2 if i % 3 == 0 else 0,
                        prefix_fp="fpA" if i % 3 == 0 else ""))
    rec(core.submit("q1", [1], 4))  # retried in-flight submit
    rec(core.poll("u0", 2, [], {"tokens_per_round": 1.0}, ["fpA"]))
    clock.t += 0.1
    rec(core.poll("s0", 2, [], {"spec_rounds": 3, "spec_accepted": 9,
                               "spec_fallbacks": 1}))
    rec(core.poll("d0", 0, [], {"role": "draft", "rolls": 2}))
    clock.t += 0.2
    rec(core.stream("u0", "q0", [5, 6]))
    rec(core.complete("u0", "q0", [5, 6, 7, 8], True))
    rec(core.complete("u0", "q0", [5, 6, 7, 8], True))  # duplicate
    rec(core.submit("q0", [1, 2, 3, 1], 4))  # answered from the cache
    rec(core.status("q0"))
    rec(core.status("q5"))
    clock.t += 0.7
    rec(core.poll("u0", 1, ["q3"], {}, ["fpA"]))
    rec(core.poll("s0", 2, [], {"spec_rounds": 5, "spec_accepted": 15,
                               "spec_fallbacks": 1}))
    # u0 goes silent past its lease: its work is requeued.
    for _ in range(4):
        clock.t += 1.0
        rec(core.poll("s0", 1, list(core._replicas["s0"].assigned)[:1]))
        core.sweep()
    rec(core.complete("u0", "q3", [1], True, replayed=True))  # late
    core.register("p0", 2, role="prefill")
    core.register("c0", 2, role="decode")
    rec(core.submit("k0", [9, 9, 9], 3))
    rec(core.poll("p0", 2, []))
    rec(core.kv_ready("p0", "k0", b"SEGMENT", 28))
    rec(core.poll("c0", 2, []))
    rec(core.kv_reject("c0", "k0", "torn"))
    rec(core.poll("p0", 2, []))
    rec(core.kv_ready("p0", "k0", b"", 28, "h:2", "fp", 7, 9))
    rec(core.poll("c0", 2, []))
    rec(core.complete("c0", "k0", [4, 4, 4], True, tokens_per_round=2.5,
                      spec_rounds=2))
    clock.t += 6.0  # deadlines
    core.sweep()
    rec(core.poll("s0", 2, []))  # re-registers after its lapse
    core.register("s0", 2, spec=True)
    rec(core.drain("s0"))
    rec(core.poll("s0", 2, []))
    rec(core.pick_drain_victim())
    rec(core.pressure())
    core.deregister("s0")
    rec(core.status("q3"))
    snap = core.stats_snapshot()
    return out, snap, core.counters


def test_gateway_core_scripted_alike():
    jout, jsnap, jc = _script(jgw, jmsg)
    tout, tsnap, tc = _script(tgw, tmsg)
    assert len(jout) == len(tout)
    for i, (a, b) in enumerate(zip(jout, tout)):
        assert a == b, (i, a, b)
    assert jsnap == tsnap
    assert jc == tc
    assert tc["completed"] >= 2 and tc["redispatched"] >= 1
    assert tc["duplicate_completions"] >= 1 and tc["kv_handoffs"] == 1
    assert tc["rejected"] >= 1 and tc["timeout"] >= 1
    assert tc["spec_grants"] >= 1 and tc["prefix_hits"] >= 1


# -- autoscale, histograms, proposals, journals -------------------------------------

def _snapshots():
    rng = np.random.RandomState(0)
    for i in range(40):
        yield {
            "replicas_alive": int(rng.randint(1, 6)),
            "queue_depth": int(rng.randint(0, 40)),
            "occupancy": float(rng.rand()),
            "ttft_p95_ms": float(rng.choice([0.0, 50.0, 900.0])),
            "tokens_per_round": float(rng.choice([0.0, 1.2, 3.5])),
            **({"kv_occupancy": float(rng.rand())} if i % 2 else {}),
            "pools": {role: {"alive": int(rng.randint(0, 4)),
                             "queue_depth": int(rng.randint(0, 20)),
                             "occupancy": float(rng.rand()),
                             "tokens_per_round": float(rng.rand() * 4)}
                      for role in ("unified", "prefill", "decode",
                                   "draft")},
        }


def test_autoscale_decisions_equal():
    kw = dict(max_replicas=5, ttft_p95_high_ms=500.0, up_patience=2,
              down_patience=2, tokens_per_round_low=1.5,
              mem_high_occupancy=0.8)
    jpol, tpol = jauto.ScalePolicy(**kw), tauto.ScalePolicy(**kw)
    js, ts = jauto.ScaleState(), tauto.ScaleState()
    jps, tps = {}, {}
    roles = ("unified", "prefill", "decode", "draft")
    for snap in _snapshots():
        assert tauto.decide(snap, tpol, ts) == jauto.decide(snap, jpol, js)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert tauto.decide_pools(snap, {r: tpol for r in roles}, tps) == \
            jauto.decide_pools(snap, {r: jpol for r in roles}, jps)


def test_histogram_equal():
    for window in (None, 5.0):
        clock = Clock()
        jh = jmetrics.Histogram(window_s=window, clock=clock)
        th = tmetrics.Histogram(window_s=window, clock=clock)
        rng = np.random.RandomState(1)
        for v in rng.exponential(300.0, size=500):
            clock.t += 0.03
            jh.observe(v)
            th.observe(v)
            if rng.rand() < 0.05:
                for p in (0.5, 0.95, 0.99):
                    assert th.percentile(p) == jh.percentile(p)
        assert th.snapshot() == jh.snapshot()
        assert th.state() == jh.state()
        merged = tmetrics.Histogram.merged([th.state(), jh.state()])
        assert merged.state() == \
            jmetrics.Histogram.merged([jh.state(), th.state()]).state()
    c = tmetrics.CounterSet()
    c.inc("a")
    c.inc("a", 2)
    assert c.snapshot() == {"a": 3}
    s = tmetrics.StatSet()
    s.set("x", 2)
    assert s.get("x") == 2.0 and s.snapshot() == {"x": 2.0}


def test_proposal_bundles_equal_both_ways():
    rng = np.random.RandomState(2)
    props = {
        "r0": {"d": [1, 2, 3], "q": rng.rand(3, 7).astype(np.float32)},
        "7": {"d": [4], "q": None},
        "r2": {"d": [5, 6], "q": rng.rand(2, 7)},
    }
    for sample in (True, False):
        p = {k: dict(v, q=v["q"] if sample else None)
             for k, v in props.items()}
        wire = jdraft.pack_proposals(p)
        assert tdraft.pack_proposals(p) == wire
        a, b = tdraft.unpack_proposals(wire), jdraft.unpack_proposals(wire)
        assert sorted(a) == sorted(b)
        for rid in a:
            assert a[rid]["d"] == b[rid]["d"]
            if b[rid]["q"] is None:
                assert a[rid]["q"] is None
            else:
                np.testing.assert_array_equal(a[rid]["q"], b[rid]["q"])
    torn = bytearray(wire)
    torn[-3] ^= 0xFF
    for mod in (tdraft, jdraft):
        with pytest.raises(mod.DraftUnavailable):
            mod.unpack_proposals(bytes(torn))


def test_completion_journal_files_equal(tmp_path):
    recs = [("a", [1, 2], [3, 4], None), ("b", [5], [6], {"tpr": 2.5}),
            ("c", [7, 8, 9], [1], {"spr": 3, "tr": "abc"})]
    paths = {}
    for name, mod in (("j", jrep), ("t", trep)):
        path = tmp_path / f"{name}.jsonl"
        jr = mod.CompletionJournal(str(path), max_records=2)
        for rid, prompt, toks, extra in recs:
            jr.append(rid, prompt, toks, extra=extra)
        jr.close()
        paths[name] = path
    assert paths["j"].read_bytes() == paths["t"].read_bytes()
    with open(paths["t"], "a") as f:
        f.write('{"rid": "d", "ph"')  # torn tail
    for mod in (jrep, trep):
        jr = mod.CompletionJournal(str(paths["t"]))
        assert sorted(jr.replayable()) == ["a", "b", "c"]
        assert jr.lookup("c", [7, 8, 9]) == [1]
        assert jr.lookup("c", [7, 8]) is None
        jr.close()
    assert trep.prefix_fingerprint([1, 2, 3]) == \
        jrep.prefix_fingerprint([1, 2, 3])


# -- a replica of one package serving the other package's gateway -------------------

class Bridge:
    """A transport whose caller speaks package ``a`` and whose gateway
    speaks package ``b``: each message crosses as wire bytes."""

    def __init__(self, handler, a, b):
        self.handler, self.a, self.b = handler, a, b

    def call(self, msg, **_kw):
        resp = self.handler(self.b.deserialize(self.a.serialize(msg)))
        if resp is None:
            resp = self.b.BaseResponse(success=True)
        return self.a.deserialize(self.b.serialize(resp))


@pytest.fixture(scope="module")
def tiny():
    jcfg = jllama.LlamaConfig.tiny(n_layer=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layer=2, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


PROMPTS = [np.random.RandomState(3).randint(1, 256, size=(n,))
           .astype(np.int32) for n in (4, 7, 11, 5, 9)]


@pytest.mark.parametrize("direction", ["port_replica", "port_gateway"])
def test_cross_package_fleet_completes_exactly_once(tiny, direction,
                                                    tmp_path):
    jcfg, jp, tcfg, tp = tiny
    kw = dict(slots=2, max_len=48, prompt_buckets=(16,))
    if direction == "port_replica":
        gw, gmsg = jgw.Gateway(port=0), jmsg
        srv = tinfer.DecodeServer(tp, tcfg, **kw)
        rmod, rmsg = trep, tmsg
    else:
        gw, gmsg = tgw.Gateway(port=0), tmsg
        srv = jinfer.DecodeServer(jp, jcfg, **kw)
        rmod, rmsg = jrep, jmsg
    want = tinfer.DecodeServer(tp, tcfg, **kw).serve(PROMPTS, 6)
    runner = rmod.ReplicaRunner(
        srv, Bridge(gw.handle, rmsg, gmsg), "r0",
        journal_path=str(tmp_path / "r0.jsonl"), poll_interval=0.005)
    th = threading.Thread(target=runner.run, daemon=True)
    th.start()
    try:
        for i, p in enumerate(PROMPTS):
            ack = gw.handle(gmsg.ServeSubmit(req_id=f"q{i}",
                                             prompt=p.tolist(),
                                             max_new_tokens=6))
            assert ack.status == "accepted"
        deadline = time.monotonic() + 60
        while gw.core.counters["completed"] < len(PROMPTS):
            assert time.monotonic() < deadline, gw.core.counters
            time.sleep(0.01)
    finally:
        gw.core.drain("r0")
        th.join(timeout=30)
        gw.stop()
    assert not th.is_alive()
    c = gw.core.counters
    assert c["completed"] == len(PROMPTS) and c["duplicate_completions"] == 0
    for i, (p, w) in enumerate(zip(PROMPTS, want)):
        st = gw.core.status(f"q{i}")
        assert st.state == "done"
        assert st.tokens == w[len(p):].tolist()
    assert runner.served == len(PROMPTS)
