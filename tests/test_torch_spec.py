"""Speculative decoding and journaled serving of the port against the JAX
package (``dlrover_tpu_torch/models/llama_infer.py`` against
``dlrover_tpu/models/llama_infer.py``): the acceptance laws, the width
policies, ``generate_speculative(_batched)``, every speculative variant of
``DecodeServer`` (slotted, paged, int8, prefix templates, EOS, local and
remote draft, global and per-request adaptive width) and
``serve_journaled``'s journal.

Both sides take the same weights (``LlamaConfig.tiny``, fp32, the JAX
``init_params`` trees carried across by ``params_from_numpy``): a 2-block
target and a 1-block draft of another seed.  Greedy tokens and the
reference's ``last_stats`` keys must be equal; the journal bytes must be
equal.  Sampled speculation draws the draft's tokens from a torch
generator (there is no JAX key), so it is held as a law: the acceptance's
first-token law over numpy draws, and the first speculated token of a
sampled server run against the target's own softmax (bound: 4.5 standard
errors plus 0.01).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu.serving import draft as jdraft
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.serving import draft as tdraft

KW = dict(slots=2, max_len=64, prompt_buckets=(8, 16), draft_k=2)
MNT = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed, n_layer, **over):
    jcfg = jllama.LlamaConfig.tiny(n_layer=n_layer, dtype=jnp.float32,
                                   **over)
    tcfg = tllama.LlamaConfig.tiny(n_layer=n_layer, dtype=torch.float32,
                                   **over)
    jp = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def models():
    """(target pair, draft pair): 2 blocks seed 0, 1 block seed 1."""
    return _pair(0, 2), _pair(1, 1)


def _prompts(seed, lens, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


PROMPTS = _prompts(0, (5, 9, 12, 3, 14))
PREFIX = _prompts(1, (20,))[0]


def _ref_keys(jst, tst):
    assert set(jst) <= set(tst), sorted(set(jst) - set(tst))
    return {k: (jst[k], tst[k]) for k in jst if jst[k] != tst[k]}


def _same_tokens(jouts, touts):
    assert len(jouts) == len(touts)
    for a, b in zip(jouts, touts):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the acceptance and the width policies -------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_accept_batch_equal_on_equal_draws(seed):
    """Equal p, q, d and generators give equal (j, tok), with and without
    per-row widths and frozen rows."""
    rng = np.random.default_rng(seed)
    B, k, V = 6, 3, 11
    p = rng.dirichlet(np.ones(V), size=(B, k + 1))
    q = rng.dirichlet(np.ones(V) * 0.5, size=(B, k))
    d = rng.integers(0, V, size=(B, k))
    done = rng.random(B) < 0.3
    k_row = rng.integers(0, k + 1, size=B)
    for kr in (None, k_row):
        a = jinfer._spec_accept_batch(p, q, d, done,
                                      np.random.default_rng(seed + 9), kr)
        b = tinfer._spec_accept_batch(p, q, d, done,
                                      np.random.default_rng(seed + 9), kr)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    for i in range(B):
        ra = jinfer._spec_accept_round(p[i], q[i], d[i],
                                       np.random.default_rng(i))
        rb = tinfer._spec_accept_round(p[i], q[i], d[i],
                                       np.random.default_rng(i))
        assert ra == rb


def test_width_policies_agree_on_a_grid():
    for draft_k in (1, 2, 4, 8):
        for cur in range(1, draft_k + 1):
            for acc in np.linspace(0.5, draft_k + 1.5, 23):
                assert tinfer._adapt_spec_k(cur, draft_k, acc) == \
                    jinfer._adapt_spec_k(cur, draft_k, acc)
        for ewma in np.linspace(0.0, draft_k + 2.0, 31):
            for be in (0.0, 1.5, 1 + 0.6 * draft_k):
                assert tinfer._spec_k_request(ewma, draft_k, be) == \
                    jinfer._spec_k_request(ewma, draft_k, be)


def test_batched_acceptance_law():
    """The first token of a round follows the target's p[0] whatever the
    draft's q (the law the reference's Monte-Carlo test holds)."""
    rng = np.random.default_rng(0)
    V, k, B, N = 8, 3, 64, 400
    p = rng.dirichlet(np.ones(V), size=k + 1)
    q = rng.dirichlet(np.ones(V) * 0.3, size=k)
    pb = np.broadcast_to(p, (B, k + 1, V))
    qb = np.broadcast_to(q, (B, k, V))
    counts = np.zeros(V)
    done = np.zeros(B, bool)
    for _ in range(N):
        d = np.stack([rng.choice(V, p=q[i], size=B) for i in range(k)], 1)
        j, tok = tinfer._spec_accept_batch(pb, qb, d, done, rng)
        np.add.at(counts, np.where(j >= 1, d[:, 0], tok), 1)
    emp = counts / (N * B)
    se = np.sqrt(p[0] * (1 - p[0]) / (N * B))
    assert (np.abs(emp - p[0]) <= 4.5 * se + 0.01).all(), (emp, p[0])


# -- the generators --------------------------------------------------------------

def test_generate_speculative_batched_greedy(models):
    (jcfg, jp, tcfg, tp), (jdc, jdp, tdc, tdp) = models
    prompts = PROMPTS[:4]
    P = max(len(p) for p in prompts)
    padded = np.zeros((len(prompts), P), np.int32)
    for b, p in enumerate(prompts):
        padded[b, :len(p)] = p
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for eos in (int(PROMPTS[0][0]),):
        js, ts = {}, {}
        jo, jl = jinfer.generate_speculative_batched(
            jp, jcfg, jdp, jdc, jnp.asarray(padded), jnp.asarray(lens),
            max_new_tokens=MNT, k=3, eos_token=eos, stats=js)
        to, tl = tinfer.generate_speculative_batched(
            tp, tcfg, tdp, tdc, torch.from_numpy(padded).long(),
            torch.from_numpy(lens), max_new_tokens=MNT, k=3, eos_token=eos,
            stats=ts)
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        assert js == ts
    # The single-stream form is the batched row; both are the plain
    # ragged decode.
    one = tinfer.generate_speculative(
        tp, tcfg, tdp, tdc, torch.from_numpy(prompts[1][None]).long(),
        max_new_tokens=MNT, k=2)
    np.testing.assert_array_equal(one[0].numpy(),
                                  to[1, :int(tl[1])].numpy())
    plain, _ = tinfer.generate_ragged(
        tp, tcfg, torch.from_numpy(padded).long(), torch.from_numpy(lens),
        max_new_tokens=MNT, eos_token=eos)
    np.testing.assert_array_equal(plain.numpy(), to.numpy())


# -- the speculative server --------------------------------------------------------

def _ref_server(models, draft, **kw):
    (jcfg, jp, _, _), (jdc, jdp, _, _) = models
    d = {"self": (jp, jcfg), "other": (jdp, jdc), None: None}[draft]
    return jinfer.DecodeServer(jp, jcfg, draft=d, **KW, **kw)


def _port_server(models, draft, **kw):
    (_, _, tcfg, tp), (_, _, tdc, tdp) = models
    d = {"self": (tp, tcfg), "other": (tdp, tdc), None: None}[draft]
    return tinfer.DecodeServer(tp, tcfg, draft=d, **KW, **kw)


SERVER_VARIANTS = {
    # name: (draft, server keywords)
    "slotted_perreq_eos": ("other", dict(
        adapt_k_per_request=True, spec_probe_every=2,
        eos_token=int(PROMPTS[2][3]))),
    "paged_int8_adapt": ("other", dict(
        paged=True, block_size=8, quant_kv=True, adapt_k=True,
        adapt_every=2)),
}


@pytest.fixture(scope="module", params=sorted(SERVER_VARIANTS))
def server_pair(request, models):
    draft, kw = SERVER_VARIANTS[request.param]
    return (request.param, _ref_server(models, draft, **kw),
            _port_server(models, draft, **kw))


def test_spec_server_batch(server_pair):
    """serve(): tokens and the reference's last_stats equal; the tokens
    are the plain server's."""
    name, js, ts = server_pair
    streamed = []
    jo = js.serve(PROMPTS, MNT)
    to = ts.serve(PROMPTS, MNT, on_token=lambda r, t: streamed.append(r))
    _same_tokens(jo, to)
    assert not _ref_keys(js.last_stats, ts.last_stats), name
    assert ts.last_stats["path"] == "spec"
    assert len(streamed) == sum(len(o) - len(p)
                                for o, p in zip(to, PROMPTS))
    plain = tinfer.DecodeServer(ts.params, ts.cfg, slots=2, max_len=64,
                                prompt_buckets=(8, 16),
                                eos_token=ts.eos_token,
                                quant_kv=ts.quant_kv, paged=ts.paged,
                                block_size=ts.block_size)
    _same_tokens(plain.serve(PROMPTS, MNT), to)


def test_spec_server_shared_prefix(server_pair):
    """shared_prefix past the largest bucket: both models admit from
    their templates."""
    name, js, ts = server_pair
    short = [p[:4] for p in PROMPTS[:3]]
    jo = js.serve(short, MNT, shared_prefix=PREFIX)
    to = ts.serve(short, MNT, shared_prefix=PREFIX)
    _same_tokens(jo, to)
    assert not _ref_keys(js.last_stats, ts.last_stats), name
    assert ts.last_stats["templated"] == 3


def test_spec_server_incremental_prefix(server_pair):
    """submit(prefix_len=) through serve_incremental: completions and the
    per-request stats the runner pops are the reference's."""
    name, js, ts = server_pair
    got = {}
    for srv, key in ((js, "j"), (ts, "t")):
        for i, p in enumerate(PROMPTS[:3]):
            srv.submit(f"r{i}", np.concatenate([PREFIX, p[:5]]), MNT,
                       prefix_len=len(PREFIX))
        outs = {}
        srv.serve_incremental(
            tick=lambda s=srv: bool(s.pending_count() or s.active_rids()),
            on_finish=lambda rid, toks, o=outs: o.__setitem__(
                rid, np.asarray(toks)))
        got[key] = (outs, {r: srv.pop_request_stats(r) for r in outs},
                    srv.prefix_misses)
    assert sorted(got["j"][0]) == sorted(got["t"][0])
    for rid in got["j"][0]:
        np.testing.assert_array_equal(got["j"][0][rid], got["t"][0][rid])
    assert got["j"][1] == got["t"][1]
    assert got["j"][2] == got["t"][2]


def _remote_pair(models, **kw):
    """A spec_remote server in each package with its own package's
    DraftWorker on the 1-block draft as the proposal handle."""
    (jcfg, jp, tcfg, tp), (jdc, jdp, tdc, tdp) = models
    js = jinfer.DecodeServer(jp, jcfg, spec_remote=True, **KW, **kw)
    ts = tinfer.DecodeServer(tp, tcfg, spec_remote=True, **KW, **kw)
    js.set_remote_draft(jdraft.DraftWorker(jdp, jdc, max_len=64, draft_k=2))
    ts.set_remote_draft(tdraft.DraftWorker(tdp, tdc, max_len=64, draft_k=2))
    return js, ts


def test_spec_server_remote_draft(models):
    js, ts = _remote_pair(models, adapt_k_per_request=True,
                          spec_probe_every=2)
    jo, to = js.serve(PROMPTS, MNT), ts.serve(PROMPTS, MNT)
    _same_tokens(jo, to)
    assert not _ref_keys(js.last_stats, ts.last_stats)
    assert ts.last_stats["rounds"] > 0


class _Dies:
    """A proposal handle that fails from its ``n``-th call on."""

    def __init__(self, inner, n):
        self.inner, self.n, self.calls = inner, n, 0

    def propose(self, *a, **kw):
        self.calls += 1
        if self.calls >= self.n:
            raise tdraft.DraftUnavailable("draft gone")
        return self.inner.propose(*a, **kw)


def test_spec_server_survives_a_dead_remote_draft(models):
    (_, _, tcfg, tp), (_, _, tdc, tdp) = models
    ts = tinfer.DecodeServer(tp, tcfg, spec_remote=True, **KW)
    ts.set_remote_draft(_Dies(tdraft.DraftWorker(tdp, tdc, max_len=64,
                                                 draft_k=3), 3))
    to = ts.serve(PROMPTS, MNT)
    st = ts.last_stats
    assert st["spec_draft_failures"] == 1 and st["spec_fallback_rounds"] > 0
    plain = tinfer.DecodeServer(tp, tcfg, slots=2, max_len=64,
                                prompt_buckets=(8, 16))
    _same_tokens(plain.serve(PROMPTS, MNT), to)
    with pytest.raises(ValueError, match="spec_remote"):
        plain.set_remote_draft(object())


def test_spec_server_sampled_law(models):
    """The first speculated token of a sampled run follows the target's
    softmax at its position, whatever the (other-seed) draft proposes;
    two seeds differ; top_k=1 is greedy."""
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, vocab_size=8)
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    tdc = tllama.LlamaConfig.tiny(dtype=torch.float32, vocab_size=8,
                                  n_layer=1)
    tdp = tllama.init_params(tdc, torch.Generator().manual_seed(1), "cpu")
    for params in (tp, tdp):  # peaked laws, far from uniform
        params["lm_head"].mul_(60.0)
    V = tcfg.vocab_size
    prompt = _prompts(3, (6,), vocab=V)[0]
    srv = tinfer.DecodeServer(tp, tcfg, slots=16, max_len=32,
                              prompt_buckets=(16,), temperature=1.0,
                              draft=(tdp, tdc), draft_k=2, seed=3)
    n = 512
    outs = srv.serve([prompt] * n, 2)
    first = np.array([o[len(prompt)] for o in outs])
    second = np.array([o[len(prompt) + 1] for o in outs])
    t1 = np.bincount(first, minlength=V).argmax()
    rows = second[first == t1]
    ctx = torch.from_numpy(np.concatenate([prompt, [t1]])[None]).long()
    cache = tinfer.init_cache(tcfg, 1, 16, device="cpu")
    logits, _ = tinfer.forward_step(tp, ctx, tcfg, cache)
    p = torch.softmax(logits[0, -1], -1).double().numpy()
    emp = np.bincount(rows, minlength=V) / len(rows)
    se = np.sqrt(p * (1 - p) / len(rows))
    assert len(rows) >= 40
    assert (np.abs(emp - p) <= 4.5 * se + 0.01).all()
    other = tinfer.DecodeServer(tp, tcfg, slots=16, max_len=32,
                                prompt_buckets=(16,), temperature=1.0,
                                draft=(tdp, tdc), draft_k=2, seed=4)
    assert any(not np.array_equal(a, b) for a, b in
               zip(outs[:16], other.serve([prompt] * 16, 2)))
    (_, _, tcfg, tp), (_, _, tdc, tdp) = models
    greedy_k1 = tinfer.DecodeServer(tp, tcfg, temperature=0.8, top_k=1,
                                    draft=(tdp, tdc), **KW)
    greedy = tinfer.DecodeServer(tp, tcfg, **KW)
    _same_tokens(greedy.serve(PROMPTS[:3], MNT),
                 greedy_k1.serve(PROMPTS[:3], MNT))


# -- serve_journaled ------------------------------------------------------------

def test_serve_journaled_bytes_and_cross_replay(models, tmp_path):
    """The two packages' journals are byte-equal; each replays the
    other's; a torn tail is cut off before the next append."""
    (jcfg, jp, tcfg, tp), _ = models
    js = jinfer.DecodeServer(jp, jcfg, **KW)
    ts = tinfer.DecodeServer(tp, tcfg, **KW)
    jpath, tpath = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jo = jinfer.serve_journaled(js, PROMPTS, MNT, str(jpath))
    to = tinfer.serve_journaled(ts, PROMPTS, MNT, str(tpath))
    _same_tokens(jo, to)
    assert jpath.read_bytes() == tpath.read_bytes()
    # Each package replays the other's journal without serving.
    boom = []
    again = tinfer.serve_journaled(ts, PROMPTS, MNT, str(jpath),
                                   on_serve=lambda *a: boom.append(a))
    _same_tokens(jo, again)
    back = jinfer.serve_journaled(js, PROMPTS, MNT, str(tpath),
                                  on_serve=lambda *a: boom.append(a))
    _same_tokens(to, back)
    assert not boom
    # Stop after 2 completions, tear the tail, run again: the rest is
    # served and the file is the uninterrupted run's, line for line.
    part = tmp_path / "part.jsonl"

    def stop(rid, toks, n=[0]):
        n[0] += 1
        if n[0] == 2:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        tinfer.serve_journaled(ts, PROMPTS, MNT, str(part), on_serve=stop)
    with open(part, "a") as f:
        f.write('{"rid": 4, "ph": "tor')
    served = []
    # A restarted worker: a fresh server on the same weights.
    ts = tinfer.DecodeServer(tp, tcfg, **KW)
    outs = tinfer.serve_journaled(ts, PROMPTS, MNT, str(part),
                                  on_serve=lambda r, t: served.append(r))
    _same_tokens(to, outs)
    assert len(served) == len(PROMPTS) - 2
    lines = part.read_text().splitlines()
    assert all(json.loads(x) for x in lines) and len(lines) == len(PROMPTS)
    assert sorted(lines) == sorted(tpath.read_text().splitlines())
    # A different prompt set re-serves instead of replaying.
    other = [p[::-1].copy() for p in PROMPTS]
    served.clear()
    tinfer.serve_journaled(ts, other, MNT, str(tpath),
                           on_serve=lambda r, t: served.append(r))
    assert len(served) == len(other)
    with pytest.raises(ValueError, match="greedy"):
        tinfer.serve_journaled(
            tinfer.DecodeServer(tp, tcfg, temperature=0.5, **KW),
            PROMPTS, MNT, str(tmp_path / "s.jsonl"))
