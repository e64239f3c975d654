"""The port's prefix caching (``dlrover_tpu_torch/models/llama_infer.py``:
``prefix_fingerprint``, ``DecodeServer(prefix_cache_cap=)``,
``serve(shared_prefix=)``, ``submit(prefix_len=, prefix_fp=)``,
``check_capacity(prefix_len=)`` and the template store) against the JAX
package's ``dlrover_tpu/models/llama_infer.py``, mirroring
``tests/test_llama_infer.py``'s ``TestPrefixCaching``, ``TestPrefixStore``
and ``TestPagedKv.test_greedy_parity_shared_prefix_template``.

The law: a prefix template changes no token.  ``serve(prompts,
shared_prefix=prefix)`` and the incremental ``submit(prefix + p,
prefix_len=len(prefix))`` emit exactly what the reference's
``serve([prefix + p])`` emits, slotted and paged, fp32 and int8, and what
the port's own untemplated serve emits.  Both sides take the same fp32
parameters (``LlamaConfig.tiny(n_layer=2)`` carried across by
``params_from_numpy``); each reference output is computed once (a module
fixture) and the port's variants are held against it.

Tolerances: none; fingerprints and tokens are compared for equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy

BS = 8
VOCAB = 256


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(n_layer=2, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layer=2, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def jsrv(model):
    """``jsrv(quant)``: one reference server (slots 2, max_len 96, bucket
    8) per cache type for the module; its programs compile once."""
    jcfg, jp, _, _ = model
    made = {}

    def get(quant=False):
        if quant not in made:
            made[quant] = jinfer.DecodeServer(
                jp, jcfg, slots=2, max_len=96, prompt_buckets=(8,), seed=0,
                quant_kv=quant)
        return made[quant]

    return get


def _draw(rng, n):
    return rng.randint(1, VOCAB, n).astype(np.int32)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def _drain(srv):
    out = {}
    srv.serve_incremental(
        tick=lambda: bool(srv.pending_count() or srv.active_rids()),
        on_finish=lambda r, t: out.__setitem__(r, t),
    )
    return out


# -- prefix_fingerprint -------------------------------------------------------

@pytest.mark.parametrize("tokens", [
    [1, 2, 3], np.arange(300, dtype=np.int64), np.zeros(0, np.int32),
    np.array([0, 31999, 7], np.int16),
], ids=["list", "int64", "empty", "int16"])
def test_prefix_fingerprint_matches_reference(tokens):
    fp = tinfer.prefix_fingerprint(tokens)
    assert fp == jinfer.prefix_fingerprint(tokens)
    assert len(fp) == 16


# -- serve(shared_prefix=) ----------------------------------------------------

# name -> (prefix length, prompt cut, requests, server keywords): the
# reference's TestPrefixCaching cases (slots 2, max_len 96, bucket 8).
SHARED = {
    # prefix 20 > bucket 8: every admission rides the template.
    "long": (20, None, 4, {}),
    # the combined prompts fit one bucket: scratch prefills.
    "short": (2, 4, 4, {}),
    "int8": (17, None, 3, {"quant_kv": True}),
    # an empty prompt after a prefix of two whole chunks: one chunk must
    # still run to give the first token.
    "empty_aligned": (16, None, 0, {}),
}


def _shared_case(name):
    P0, cut, n, kw = SHARED[name]
    rng = np.random.RandomState(11)
    prompts = [_draw(rng, int(ln)) for ln in rng.randint(3, 8, size=(4,))]
    if cut:
        prompts = [p[:cut] for p in prompts]
    prompts = prompts[:n] if n else prompts
    prefix = _draw(rng, P0)
    if name == "empty_aligned":
        prompts = [np.zeros((0,), np.int32), _draw(rng, 5)]
    return prefix, prompts, kw


@pytest.fixture(scope="module")
def shared_ref(jsrv):
    """The reference's ``serve(prompts, shared_prefix=)`` per case."""
    out = {}
    for name in SHARED:
        prefix, prompts, kw = _shared_case(name)
        out[name] = jsrv(bool(kw.get("quant_kv"))).serve(
            prompts, max_new_tokens=8, shared_prefix=prefix)
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
@pytest.mark.parametrize("name", list(SHARED))
def test_shared_prefix_matches_reference(model, shared_ref, name, paged):
    _, _, tcfg, tp = model
    prefix, prompts, kw = _shared_case(name)

    def server():
        return tinfer.DecodeServer(tp, tcfg, slots=2, max_len=96,
                                   prompt_buckets=(8,), seed=0, paged=paged,
                                   block_size=BS, **kw)

    srv = server()
    got = srv.serve(prompts, max_new_tokens=8, shared_prefix=prefix)
    _same(got, shared_ref[name])
    untemplated = server().serve(
        [np.concatenate([prefix, p]) for p in prompts], max_new_tokens=8)
    _same(untemplated, shared_ref[name])
    st = srv.last_stats
    long_ones = sum(len(prefix) + len(p) > 8 for p in prompts)
    assert st["templated"] == long_ones
    assert st["template_forwards"] == (1 if long_ones else 0)
    if paged:
        assert srv.kv_arena.conserved()


def test_template_saves_prefill_forwards(model):
    """A templated admission scores only its own chunk: fewer forwards than
    the untemplated path, one template prefill for the whole batch."""
    _, _, tcfg, tp = model
    prefix, prompts, _ = _shared_case("long")
    kw = dict(slots=2, max_len=96, prompt_buckets=(8,))
    a = tinfer.DecodeServer(tp, tcfg, **kw)
    a.serve(prompts, max_new_tokens=8, shared_prefix=prefix)
    b = tinfer.DecodeServer(tp, tcfg, **kw)
    b.serve([np.concatenate([prefix, p]) for p in prompts], max_new_tokens=8)
    pa = a.last_stats["forwards"] - a.last_stats["rounds"]
    pb = b.last_stats["forwards"] - b.last_stats["rounds"]
    # 20 + 3..7 tokens: 3-4 chunks of 8 untemplated, 1-2 templated.
    assert pa + a.last_stats["template_forwards"] < pb


def test_paged_template_shares_blocks(model, jsrv):
    """The reference's ``test_greedy_parity_shared_prefix_template``: the
    paged template shares whole prefix blocks; its blocks stay held for the
    run (the next serve resets the pool), and the pool is conserved."""
    _, _, tcfg, tp = model
    rng3, rng7 = np.random.RandomState(3), np.random.RandomState(7)
    prefix = _draw(rng3, 17)
    prompts = [_draw(rng7, n) for n in (6, 9, 5)]
    ref = jsrv().serve(prompts, max_new_tokens=8, shared_prefix=prefix)
    srv = tinfer.DecodeServer(tp, tcfg, slots=2, max_len=96,
                              prompt_buckets=(8,), seed=0, paged=True,
                              block_size=BS)
    _same(srv.serve(prompts, max_new_tokens=8, shared_prefix=prefix), ref)
    st = srv.last_stats
    assert st["templated"] == 3 and st["shared_blocks"] > 0
    arena = srv.kv_arena
    assert arena.conserved()
    assert arena.free_blocks == arena.n_blocks - arena.blocks_for(17)


@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_templated_counts_only_admissions_the_template_served(
        model, paged, monkeypatch):
    """``last_stats["templated"]`` counts an admission only where the
    template saved work: not where the prefix is shorter than the largest
    bucket (the first re-scored chunk is chunk 0), nor, paged, where the
    pool will not hold the template's blocks (``hold`` refuses here).  Both
    still emit the untemplated serve's tokens."""
    _, _, tcfg, tp = model
    rng = np.random.RandomState(31)
    short, long_ = _draw(rng, 5), _draw(rng, 20)
    full = [np.concatenate([short, _draw(rng, 15)]),
            np.concatenate([long_, _draw(rng, 6)])]
    kw = dict(slots=2, max_len=48, prompt_buckets=(8,), seed=0)
    ref = tinfer.DecodeServer(tp, tcfg, **kw).serve(full, 6)
    if paged:
        kw.update(paged=True, block_size=BS)
    srv = tinfer.DecodeServer(tp, tcfg, **kw)
    if paged:
        monkeypatch.setattr(srv.kv_arena, "hold", lambda n: None)
    srv.submit(0, full[0], 6, prefix_len=5)
    srv.submit(1, full[1], 6, prefix_len=20)
    got = _drain(srv)
    _same([got[0], got[1]], ref)
    assert srv.last_stats["templated"] == (0 if paged else 1)
    assert srv.prefix_misses == 2


def test_tight_pool_admits_without_templates(model):
    """A pool too tight for every request and its template: admissions
    wait, preempt, and go without the template when the batch is empty,
    and still emit the slotted server's tokens; and a request that does
    not fit beside the templates' held blocks drops the holds (a later one
    holds again)."""
    _, _, tcfg, tp = model
    rng = np.random.RandomState(21)
    prefix = _draw(rng, 20)
    own = [_draw(rng, n) for n in (4, 7, 5, 6)]
    kw = dict(slots=2, max_len=48, prompt_buckets=(8,), seed=0)
    ref = tinfer.DecodeServer(tp, tcfg, **kw).serve(
        [np.concatenate([prefix, p]) for p in own], max_new_tokens=12)
    srv = tinfer.DecodeServer(tp, tcfg, paged=True, block_size=BS,
                              pool_blocks=6, **kw)
    _same(srv.serve(own, max_new_tokens=12, shared_prefix=prefix), ref)
    assert srv.preemptions > 0
    assert srv.kv_arena.conserved()

    # One slot, 7 blocks of 8: A + 4 holds A's 3 blocks; B + 20 needs 5
    # bare blocks with 4 free, so the holds go; A + 4 holds A again.
    a, b = _draw(rng, 20), _draw(rng, 20)
    full = [np.concatenate([a, _draw(rng, 4)]),
            np.concatenate([b, _draw(rng, 20)]),
            np.concatenate([a, _draw(rng, 4)])]
    kw = dict(slots=1, max_len=48, prompt_buckets=(8,), seed=0)
    ref = tinfer.DecodeServer(tp, tcfg, **kw).serve(full, 4)
    inc = tinfer.DecodeServer(tp, tcfg, paged=True, block_size=BS,
                              pool_blocks=7, **kw)
    for i, p in enumerate(full):
        inc.submit(i, p, 4, prefix_len=20)
    got = _drain(inc)
    _same([got[i] for i in range(3)], ref)
    st = inc.last_stats
    assert st["templated"] == 2 and st["template_forwards"] == 2
    assert inc.kv_arena.conserved()
    # A's template is held again after the drop; B's never was.
    assert inc.kv_arena.free_blocks == 7 - 3


def test_prefix_validation_and_capacity(model):
    _, _, tcfg, tp = model
    rng = np.random.RandomState(11)
    prompts = [_draw(rng, 4)]
    srv = tinfer.DecodeServer(tp, tcfg, slots=1, max_len=32,
                              prompt_buckets=(8,))
    with pytest.raises(ValueError, match="non-empty 1-D"):
        srv.serve(prompts, max_new_tokens=4,
                  shared_prefix=np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="non-empty 1-D"):
        srv.serve(prompts, max_new_tokens=4,
                  shared_prefix=np.zeros((0,), np.int32))
    # The prefix counts against capacity.
    with pytest.raises(ValueError, match="prefix 24"):
        srv.serve(prompts, max_new_tokens=8, shared_prefix=_draw(rng, 24))
    with pytest.raises(ValueError, match="prefix 24"):
        srv.check_capacity(4, 8, prefix_len=24)
    with pytest.raises(ValueError, match="prefix_len 4 out of range"):
        srv.submit("a", prompts[0], 4, prefix_len=4)
    with pytest.raises(ValueError, match="token ids"):
        srv.serve(prompts, max_new_tokens=4,
                  shared_prefix=np.array([VOCAB], np.int32))
    assert srv.pending_count() == 0


# -- submit(prefix_len=): the fingerprint store -------------------------------

STORE = {"slotted": {}, "paged": {"paged": True, "block_size": BS},
         "int8": {"quant_kv": True},
         "int8_paged": {"quant_kv": True, "paged": True, "block_size": BS}}


@pytest.fixture(scope="module")
def store_case(jsrv):
    """Three requests behind one 20-token prefix and the reference's
    ``serve`` of the combined prompts, dense and int8."""
    rng = np.random.RandomState(5)
    prefix = _draw(rng, 20)
    own = [_draw(rng, 5) for _ in range(3)]
    full = [np.concatenate([prefix, p]) for p in own]
    refs = {quant: jsrv(quant).serve(full, max_new_tokens=6)
            for quant in (False, True)}
    return prefix, full, refs


@pytest.mark.parametrize("layout", list(STORE))
def test_incremental_prefix_matches_reference(model, store_case, layout):
    _, _, tcfg, tp = model
    prefix, full, refs = store_case
    kw = dict(slots=2, max_len=96, prompt_buckets=(8,), seed=0,
              **STORE[layout])
    srv = tinfer.DecodeServer(tp, tcfg, prefix_cache_cap=2, **kw)
    for i, p in enumerate(full):
        srv.submit(f"q{i}", p, 6, prefix_len=20)
    got = _drain(srv)
    assert srv.prefix_misses == 1 and srv.prefix_hits == 2
    assert srv.warm_prefix_fps() == [tinfer.prefix_fingerprint(prefix)]
    assert srv.last_stats["templated"] == 3
    want = refs[bool(kw.get("quant_kv"))]
    _same([got[f"q{i}"] for i in range(3)], want)
    _same(tinfer.DecodeServer(tp, tcfg, **kw).serve(full, 6), want)
    if srv.paged:
        assert srv.kv_arena.conserved()


def test_lru_bounded_and_cleared(model):
    _, _, tcfg, tp = model
    srv = tinfer.DecodeServer(tp, tcfg, slots=2, max_len=64,
                              prompt_buckets=(8,), prefix_cache_cap=2)
    rng = np.random.RandomState(5)
    fps = []
    for _ in range(3):
        prefix = _draw(rng, 20)
        fps.append(tinfer.prefix_fingerprint(prefix))
        srv._ensure_prefix_template(prefix, fps[-1])
    assert srv.warm_prefix_fps() == fps[1:]  # the oldest is evicted
    assert srv.template_forwards == 3
    srv.clear_prefix_templates()
    assert srv.warm_prefix_fps() == []
    assert srv.prefix_hits == 0 and srv.prefix_misses == 0


def test_fingerprint_collision_rebuilds(model):
    """An entry whose tokens differ from the claimed fingerprint's is
    rebuilt, never served."""
    _, _, tcfg, tp = model
    srv = tinfer.DecodeServer(tp, tcfg, slots=2, max_len=64,
                              prompt_buckets=(8,))
    rng = np.random.RandomState(5)
    p1, p2 = _draw(rng, 20), _draw(rng, 20)
    first = srv._ensure_prefix_template(p1, "colliding-fp")
    entry = srv._ensure_prefix_template(p2, "colliding-fp")
    assert srv.prefix_misses == 2 and srv.prefix_hits == 0
    np.testing.assert_array_equal(entry["prefix"], p2)
    assert not torch.equal(first["layers"][0]["k"], entry["layers"][0]["k"])
    assert srv._ensure_prefix_template(p2, "colliding-fp") is entry
    assert srv.prefix_hits == 1
