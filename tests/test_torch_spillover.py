"""The port's cross-cell spillover (``dlrover_tpu_torch/serving/
spillover.py``, ``Gateway.spill_router``) against the JAX package's, under
the same stepped clock, with exact equality:

- ``SpilloverPolicy.decide`` over a hypothesis grid of local pressure,
  sibling views, hop counts, configurations and transport failures;
- ``CellSpillRouter`` in front of two ``Gateway``s (cells A and B) fed one
  submit / status / complete script: the same acks, states, ``spill_*``
  counters and adopted terminals;
- ``GlobalClient.home_cell``, its whole-cell failover over scripted cells,
  and ``merge_global_snapshots``.
"""

import dataclasses
import types

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from dlrover_tpu.common import messages as jmsg
from dlrover_tpu.serving import gateway as jgw
from dlrover_tpu.serving import spillover as jsp
from dlrover_tpu_torch.common import messages as tmsg
from dlrover_tpu_torch.serving import gateway as tgw
from dlrover_tpu_torch.serving import spillover as tsp

REF = types.SimpleNamespace(sp=jsp, gw=jgw, msg=jmsg)
PORT = types.SimpleNamespace(sp=tsp, gw=tgw, msg=tmsg)


class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# -- the policy --------------------------------------------------------------

pressure_st = st.one_of(
    st.fixed_dictionaries({"pressure": st.sampled_from(
        [0.0, 0.5, 0.84, 0.85, 0.99, 1.0, 1.5])}),
    st.fixed_dictionaries({"in_flight": st.integers(0, 12),
                           "queue_cap": st.integers(0, 8)}),
    st.just({}),
)
sibling_st = st.tuples(pressure_st, st.sampled_from([True, False, None])) \
    .map(lambda t: dict(t[0], **({} if t[1] is None else {"alive": t[1]})))
config_st = st.fixed_dictionaries({
    "max_hops": st.integers(0, 2),
    "spill_at": st.sampled_from([0.5, 1.0]),
    "sibling_headroom": st.sampled_from([0.5, 0.85, 1.0]),
    "failure_cooldown_s": st.sampled_from([0.0, 5.0]),
})
step_st = st.tuples(
    pressure_st, st.booleans(),
    st.dictionaries(st.sampled_from(["A", "B", "C", "D"]), sibling_st,
                    max_size=4),
    st.integers(0, 2),
    st.lists(st.sampled_from(["A", "B", "C"]), max_size=2),  # failures
    st.sampled_from([0.0, 1.0, 4.9, 5.0, 6.0]),  # clock step
)


def policy_run(pkg, cfg, steps):
    clock = Clock()
    pol = pkg.sp.SpilloverPolicy(pkg.sp.SpilloverConfig(**cfg), clock=clock)
    out = []
    for local, draining, siblings, hops, failures, dt in steps:
        for cell in failures:
            pol.note_failure(cell)
        clock.advance(dt)
        loc = dict(local, draining=draining)
        out.append(dataclasses.asdict(pol.decide(loc, siblings, hops)))
        out.append(pkg.sp._pressure_of(local))
    return out


@settings(max_examples=200, deadline=None)
@given(cfg=config_st, steps=st.lists(step_st, min_size=1, max_size=6))
def test_policy_decide_equal(cfg, steps):
    assert policy_run(PORT, cfg, steps) == policy_run(REF, cfg, steps)


def test_policy_defaults_equal():
    assert dataclasses.asdict(tsp.SpilloverConfig()) == \
        dataclasses.asdict(jsp.SpilloverConfig())
    assert tsp.TERMINAL_STATES == jsp.TERMINAL_STATES
    d = tsp.SpilloverPolicy(clock=Clock()).decide(
        {"pressure": 1.0}, {"B": {"pressure": 0.2}, "A": {"pressure": 0.2}})
    assert d == tsp.SpillDecision(True, target="A", reason="saturated")


# -- the router between two cells --------------------------------------------

class Dead:
    def call(self, msg, **kw):
        raise RuntimeError("sibling cell is gone")


def router_script(pkg) -> list:
    """Cells A (queue_cap 2) and B behind ``Gateway.handle`` with
    ``spill_router`` set, each the other's sibling through a loopback."""
    M, G = pkg.msg, pkg.gw
    clock = Clock()
    gws = {
        "A": G.Gateway(port=0, config=G.GatewayConfig(
            queue_cap=2, trace_sample=0.0), clock=clock),
        "B": G.Gateway(port=0, config=G.GatewayConfig(
            queue_cap=4, trace_sample=0.0), clock=clock),
    }
    links = {c: G.LoopbackTransport(gw.handle) for c, gw in gws.items()}
    routers = {}
    for cell, other in (("A", "B"), ("B", "A")):
        routers[cell] = pkg.sp.CellSpillRouter(
            cell, gws[cell].core, {other: links[other]}, clock=clock)
        gws[cell].spill_router = routers[cell]
    out = []

    def rec(x):
        out.append(M.serialize(x) if isinstance(x, M.Message) else x)

    def submit(cell, rid, hops=0, n=4):
        rec(links[cell].call(M.ServeSubmit(
            req_id=rid, prompt=[1, 2, int(rid[1:]) + 1], max_new_tokens=n,
            spill_hops=hops)))

    def status(cell, rid):
        rec(links[cell].call(M.ServeStatusRequest(req_id=rid)))

    def counters():
        for cell in ("A", "B"):
            rec({k: v for k, v in gws[cell].core.counters.items()})
            rec(routers[cell].spilled_count)

    try:
        gws["A"].core.register("ra", 1)
        gws["B"].core.register("rb", 2)
        for i in range(5):
            submit("A", f"q{i}")  # 2 local, then forwarded to B
        submit("A", "q3")  # a retry of a forwarded request stays at B
        for i in range(5):
            status("A", f"q{i}")
        counters()
        # B serves what it holds; A's status polls adopt the terminals.
        grants = gws["B"].core.poll("rb", 2, [])
        rec([g.req_id for g in grants.requests])
        for g in grants.requests:
            gws["B"].core.complete("rb", g.req_id, [9, int(g.req_id[1:])])
        for i in range(5):
            status("A", f"q{i}")
        submit("A", "q2")  # answered from A's dedupe (adopted)
        counters()
        # Hop budget: a hop-marked submit to a full A is not re-forwarded.
        submit("A", "q7", hops=1)
        # Draining A forwards even with headroom.
        grants = gws["A"].core.poll("ra", 1, [])
        for g in grants.requests:
            gws["A"].core.complete("ra", g.req_id, [1])
        routers["A"].set_draining(True)
        submit("A", "q8")
        routers["A"].set_draining(False)
        # A dead sibling: the forward fails, the policy cools it down and
        # the submit lands locally; after the cooldown B is offered again.
        routers["A"]._siblings["B"] = Dead()
        for i in (10, 11, 12):
            submit("A", f"q{i}")
        status("A", "q8")  # the spilled request's sibling is gone
        routers["A"]._siblings["B"] = links["B"]
        submit("A", "q13")  # B still cooling down: rejected locally
        clock.advance(5.0)
        submit("A", "q14")  # forwarded again
        counters()
    finally:
        for gw in gws.values():
            gw.stop(0.0)
    return out


def test_cell_spill_router_equal():
    got, want = router_script(PORT), router_script(REF)
    assert got == want


def test_cell_spill_router_counts_each_hop_once():
    out = router_script(PORT)
    dicts = [x for x in out if isinstance(x, dict)]
    a, b = dicts[-2], dicts[-1]
    assert a["spill_forwarded"] >= 1
    # Every forward accepted by B is one spill_ingress at B (the retried
    # q3 went again: one more forward at A, one more ingress at B).
    assert b["spill_ingress"] == a["spill_forwarded"]
    assert a["spill_adopted"] >= 1 and a["dedupe_hits"] >= 1
    assert a["spill_rebuffed"] == 1


# -- the global client -------------------------------------------------------

CELL_SETS = [("A",), ("A", "B"), ("A", "B", "C"), ("B", "C"),
             ("cellA", "cellB", "cellC", "cellD")]


@pytest.mark.parametrize("cells", CELL_SETS, ids="+".join)
def test_home_cell_equal(cells):
    ids = [f"req-{i}" for i in range(1000)]
    t = tsp.GlobalClient({c: object() for c in cells})
    j = jsp.GlobalClient({c: object() for c in cells})
    assert [t.home_cell(i) for i in ids] == [j.home_cell(i) for i in ids]
    assert [tsp._rendezvous_key(c, i) for c in cells for i in ids[:50]] == \
        [jsp._rendezvous_key(c, i) for c in cells for i in ids[:50]]
    alive = cells[1:]
    t = tsp.GlobalClient({c: object() for c in cells},
                         alive_fn=lambda: alive)
    j = jsp.GlobalClient({c: object() for c in cells},
                         alive_fn=lambda: alive)
    assert [t.home_cell(i) for i in ids] == [j.home_cell(i) for i in ids]


class Cell:
    """A TierClient-shaped cell over one core; ``dead`` makes every call
    raise, like a blacked-out cell's transport."""

    def __init__(self, core):
        self.core, self.dead = core, False

    def submit(self, req_id, prompt, max_new_tokens, deadline_s=0.0,
               submit_timeout=10.0):
        if self.dead:
            raise RuntimeError("cell is dark")
        return self.core.submit(req_id, prompt, max_new_tokens, deadline_s)

    def status(self, req_id):
        if self.dead:
            raise RuntimeError("cell is dark")
        return self.core.status(req_id)


def global_script(pkg) -> list:
    G = pkg.gw
    cells = {c: Cell(G.GatewayCore(G.GatewayConfig(
        queue_cap=3, trace_sample=0.0), clock=Clock())) for c in "AB"}
    for c, cell in cells.items():
        cell.core.register(f"r{c}", 4)
    cli = pkg.sp.GlobalClient(cells, poll_interval=0.0)
    ids = [f"g{i}" for i in range(12)]
    out = [[cli.home_cell(i) for i in ids]]
    acks = [cli.submit(i, [1, int(i[1:])], 3) for i in ids]
    out.append([(a.status, a.reason) for a in acks])
    cells["A"].dead = True
    for c in "B":
        grants = cells[c].core.poll(f"r{c}", 4, [])
        for g in grants.requests:
            cells[c].core.complete(f"r{c}", g.req_id, [7])
    results = {}
    for i in ids:
        if acks[int(i[1:])].status == "rejected":
            continue
        r = cli.result(i, timeout=0.0)
        if r.state != "done":
            grants = cells["B"].core.poll("rB", 4, [])
            for g in grants.requests:
                cells["B"].core.complete("rB", g.req_id, [8])
            r = cli.result(i, timeout=0.0)
        results[i] = (r.state, r.tokens)
    out.append(results)
    out.append(cli.cell_failovers)
    return out


def test_global_client_failover_equal():
    got, want = global_script(PORT), global_script(REF)
    assert got == want
    assert got[-1] >= 1 and all(s == "done" for s, _ in got[-2].values())


count_st = st.dictionaries(
    st.sampled_from(["submitted", "spill_ingress", "spill_forwarded",
                     "spill_rebuffed", "spill_adopted", "completed"]),
    st.integers(0, 30), max_size=6)
cell_snap_st = st.one_of(st.none(), st.just({}), st.fixed_dictionaries({
    "counters": count_st,
    "in_flight": st.integers(0, 9),
    "queue_depth": st.integers(0, 9),
    "replicas_alive": st.integers(0, 3),
}))


@settings(max_examples=150, deadline=None)
@given(snaps=st.dictionaries(st.sampled_from(["A", "B", "C"]), cell_snap_st,
                             max_size=3))
def test_merge_global_snapshots_equal(snaps):
    assert tsp.merge_global_snapshots(snaps) == \
        jsp.merge_global_snapshots(snaps)
