"""The port's prefill/decode KV-segment handoff
(``dlrover_tpu_torch/models/llama_infer.py``: ``KvSegmentError``,
``KV_SEGMENT_VERSION``, ``pack_kv_segment``, ``unpack_kv_segment`` and
``DecodeServer.prefill_request`` / ``export_kv`` / ``import_kv``) against
the JAX package's ``dlrover_tpu/models/llama_infer.py``, mirroring
``tests/test_llama_infer.py``'s ``TestKvSegment``, ``TestKvHandoff`` and
``TestPagedKv.test_paged_handoff_ships_block_lists``.

The laws: the payload is the reference's byte for byte (fp32, bf16 and
int8 with fp32 scales; monolithic and block-list framing), and each
package unpacks the other's; a torn or foreign segment raises
``KvSegmentError`` and is never admitted; a request prefilled on one server
and imported by another decodes exactly what one server serving it in
place emits, for segments packed by either package.  Both sides take the
same fp32 parameters (``LlamaConfig.tiny(n_layer=2)``).

Tolerances: payload bytes, unpacked arrays and tokens are compared for
equality.  The staged fp32 rows of the two packages' prefills agree within
1e-5 (the same sums in another order); the int8 export against the fp32
one is held to the reference's own dequantization bounds (layer 0 within
0.51 of a scale step, deeper layers within 2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu.serving import kvseg
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy

BS = 8
MNT = 6


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


# -- the wire format ----------------------------------------------------------

def _layers(kind, n=5, layers=2, KV=2, D=4):
    """The reference test's per-layer arrays (numpy; bf16 as jnp's)."""
    rng = np.random.RandomState(3)
    out = []
    for _ in range(layers):
        if kind == "int8":
            lay = {
                "k": rng.randint(-127, 127, (1, KV, n, D)).astype(np.int8),
                "v": rng.randint(-127, 127, (1, KV, n, D)).astype(np.int8),
                "ks": rng.rand(1, KV, n).astype(np.float32),
                "vs": rng.rand(1, KV, n).astype(np.float32),
            }
        else:
            lay = {"k": rng.randn(1, KV, n, D).astype(np.float32),
                   "v": rng.randn(1, KV, n, D).astype(np.float32)}
            if kind == "bf16":
                lay = {k: np.asarray(jnp.asarray(v, jnp.bfloat16))
                       for k, v in lay.items()}
        out.append(lay)
    return out


def _torch_layers(layers):
    """The same arrays as CPU tensors (bf16 from its uint16 bits)."""
    out = []
    for lay in layers:
        t = {}
        for k, v in lay.items():
            if v.dtype.name == "bfloat16":
                t[k] = torch.from_numpy(v.view(np.uint16).astype(np.int16)
                                        ).view(torch.bfloat16)
            else:
                t[k] = torch.from_numpy(v.copy())
        out.append(t)
    return out


def _bytes(a) -> bytes:
    if torch.is_tensor(a):
        return tinfer.byte_view(a.contiguous()).tobytes()
    return np.ascontiguousarray(a).tobytes()


def _same_arrays(got_layers, want_layers):
    assert len(got_layers) == len(want_layers)
    for g, w in zip(got_layers, want_layers):
        assert sorted(g) == sorted(w)
        for k in w:
            assert tuple(g[k].shape) == tuple(w[k].shape), k
            assert _bytes(g[k]) == _bytes(w[k]), k


@pytest.mark.parametrize("block_size", [0, 2, 8], ids=["mono", "bs2", "bs8"])
@pytest.mark.parametrize("kind", ["fp32", "bf16", "int8"])
def test_payload_bytes_match_reference(kind, block_size):
    ref_layers = _layers(kind)
    layers = _torch_layers(ref_layers)
    quant = kind == "int8"
    want = jinfer.pack_kv_segment(ref_layers, 5, 42, quant, block_size)
    got = tinfer.pack_kv_segment(layers, 5, 42, quant, block_size)
    assert got == want
    # Each package unpacks the other's payload to the same arrays.
    mine = tinfer.unpack_kv_segment(want[0])
    theirs = jinfer.unpack_kv_segment(got[0])
    for seg in (mine, theirs):
        assert (seg["n"], seg["first"], seg["quant"]) == (5, 42, quant)
        assert seg.get("block_size") == (block_size or None)
    _same_arrays(mine["layers"], ref_layers)
    _same_arrays(theirs["layers"], layers)


def test_fp32_bytes_and_int8_saving():
    payload, fp32_bytes = tinfer.pack_kv_segment(
        _torch_layers(_layers("fp32")), 5, 42, False)
    assert fp32_bytes == 2 * 2 * (1 * 2 * 5 * 4) * 4
    q = _torch_layers(_layers("int8", n=8, D=16))
    payload, fp32_bytes = tinfer.pack_kv_segment(q, 8, 1, True)
    # int8 codes + fp32 per-slot scales: 1/4 + 1/D of fp32, plus the
    # envelope.
    assert len(payload) < 0.5 * fp32_bytes
    assert tinfer.KvSegmentError.KV_REJECT is True
    assert issubclass(tinfer.KvSegmentError, ValueError)
    assert tinfer.KV_SEGMENT_VERSION == jinfer.KV_SEGMENT_VERSION == 1


@pytest.mark.parametrize("block_size", [0, 2], ids=["mono", "blocks"])
def test_torn_payload_rejected_everywhere(block_size):
    payload, _ = tinfer.pack_kv_segment(
        _torch_layers(_layers("fp32")), 5, 0, False, block_size)
    for cut in (len(payload) // 3, len(payload) // 2, len(payload) - 5):
        torn = bytearray(payload)
        torn[cut] ^= 0xFF
        with pytest.raises(tinfer.KvSegmentError):
            tinfer.unpack_kv_segment(bytes(torn))
    for bad in (payload[: len(payload) // 2], b"garbage", b""):
        with pytest.raises(tinfer.KvSegmentError):
            tinfer.unpack_kv_segment(bad)


def _repack(payload, **meta_over):
    """The payload with its meta edited (CRCs still valid)."""
    from dlrover_tpu_torch.common import msgpack_lite

    obj = msgpack_lite.unpackb(payload)
    obj["meta"].update(meta_over)
    return msgpack_lite.packb(obj)


def test_incoherent_meta_rejected():
    layers = _torch_layers(_layers("fp32"))
    mono, _ = tinfer.pack_kv_segment(layers, 5, 0, False)
    blocks, _ = tinfer.pack_kv_segment(layers, 5, 0, False, 2)
    for bad, what in (
        (_repack(mono, v=2), "version"),
        (_repack(mono, layers=3), "size mismatch"),
        (_repack(mono, shapes={"k": [[1, 2, 5, 4], "float8_e3m9"],
                               "v": [[1, 2, 5, 4], "float32"]}),
         "incoherent"),
        (_repack(blocks, n=7), "block meta"),
        (_repack(blocks, bcrc=[0, 0, 0]), "block 0/3 CRC"),
    ):
        with pytest.raises(tinfer.KvSegmentError, match=what):
            tinfer.unpack_kv_segment(bad)


# -- the handoff between servers ----------------------------------------------

def _prompt(seed=7, n=13):
    return np.random.RandomState(seed).randint(1, 256, n).astype(np.int32)


def _tsrv(model, **kw):
    _, _, tcfg, tp = model
    base = dict(slots=1, max_len=64, prompt_buckets=(8,), seed=0)
    base.update(kw)
    return tinfer.DecodeServer(tp, tcfg, block_size=BS, **base)


@pytest.fixture(scope="module")
def jsrv(model):
    """``jsrv(quant, paged)``: one reference server per layout for the
    module (its programs compile once; prefill, import and serve reuse
    it)."""
    jcfg, jp, _, _ = model
    made = {}

    def get(quant=False, paged=False):
        if (quant, paged) not in made:
            made[quant, paged] = jinfer.DecodeServer(
                jp, jcfg, slots=1, max_len=64, prompt_buckets=(8,), seed=0,
                block_size=BS, quant_kv=quant, paged=paged)
        return made[quant, paged]

    return get


def _drain(srv):
    out = {}
    srv.serve_incremental(
        tick=lambda: bool(srv.pending_count() or srv.active_rids()),
        on_finish=lambda r, t: out.__setitem__(r, t),
    )
    return out


@pytest.fixture(scope="module")
def ref(jsrv):
    """The reference's in-place decode of the 13-token prompt, dense and
    int8, and its prefill servers' staged rows and payloads (prefilled
    once, slotted and paged)."""
    prompt = _prompt()
    out = {"prompt": prompt}
    for quant in (False, True):
        out["tokens", quant] = jsrv(quant).serve(
            [prompt], max_new_tokens=MNT)[0]
    for quant, paged in ((False, False), (True, False), (False, True)):
        pf = jsrv(quant, paged)
        first = pf.prefill_request("x", prompt, MNT)
        staged = [{k: np.array(v) for k, v in lay.items()}
                  for lay in pf._kv_exports["x"]["layers"]]
        out["prefill", quant, paged] = (first, staged, pf.export_kv("x")[0])
    return out


LAYOUTS = {"slotted": {}, "int8": {"quant_kv": True},
           "paged": {"paged": True}, "int8_paged": {"quant_kv": True,
                                                     "paged": True}}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_handoff_decodes_as_in_place(model, ref, layout):
    """Prefill on one port server, import on another: the stream equals
    the same server serving the request in place and the reference's."""
    kw = LAYOUTS[layout]
    prompt = ref["prompt"]
    quant = bool(kw.get("quant_kv"))
    pf = _tsrv(model, **kw)
    first = pf.prefill_request("x", prompt, MNT)
    staged = [{k: v.clone() for k, v in lay.items()}
              for lay in pf._kv_exports["x"]["layers"]]
    payload, fp32_bytes = pf.export_kv("x")
    assert fp32_bytes > 0
    if quant:
        assert len(payload) < 0.5 * fp32_bytes
    seg = tinfer.unpack_kv_segment(payload)
    _same_arrays(seg["layers"], staged)
    assert seg["first"] == first
    # A paged server ships a block list (the reference's telemetry peek
    # reads the framing from the meta).
    want_blocks = (BS, -(-len(prompt) // BS)) if pf.paged else None
    assert kvseg.segment_block_info(payload) == want_blocks
    with pytest.raises(ValueError, match="no staged prefill"):
        pf.export_kv("x")
    dec = _tsrv(model, **kw)
    dec.import_kv("x", payload, prompt, MNT)
    got = _drain(dec)["x"]
    assert dec.last_stats["imported"] == 1
    assert dec.last_stats["forwards"] == dec.last_stats["rounds"]
    in_place = _tsrv(model, **kw).serve([prompt], max_new_tokens=MNT)[0]
    np.testing.assert_array_equal(got, in_place)
    np.testing.assert_array_equal(got, ref["tokens", quant])
    if dec.paged:
        assert dec.kv_arena.conserved()


@pytest.mark.parametrize("quant,paged", [(False, False), (True, False),
                                         (False, True)],
                         ids=["slotted", "int8", "paged"])
def test_staged_rows_match_reference(model, ref, quant, paged):
    """The port's staged prefill rows against the reference's: fp32 within
    1e-5, int8 codes within one step and scales within 1e-5 relative."""
    prompt = ref["prompt"]
    r_first, r_staged, _ = ref["prefill", quant, paged]
    pf = _tsrv(model, quant_kv=quant, paged=paged)
    assert pf.prefill_request("x", prompt, MNT) == r_first
    got = pf._kv_exports["x"]["layers"]
    for g, w in zip(got, r_staged):
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k].dtype == np.int8:
                d = np.abs(g[k].numpy().astype(int) - w[k].astype(int))
                assert d.max() <= 1 and (d > 0).mean() < 0.01, k
            else:
                np.testing.assert_allclose(g[k].numpy(), w[k], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("quant,paged", [(False, False), (True, False),
                                         (False, True)],
                         ids=["slotted", "int8", "paged"])
def test_segments_cross_packages(model, ref, jsrv, quant, paged):
    """A reference-packed segment imported by the port, and a port-packed
    one imported by the reference, decode to the same tokens."""
    prompt = ref["prompt"]
    _, _, r_payload = ref["prefill", quant, paged]
    dec = _tsrv(model, quant_kv=quant, paged=paged)
    dec.import_kv("r", r_payload, prompt, MNT)
    np.testing.assert_array_equal(_drain(dec)["r"], ref["tokens", quant])
    pf = _tsrv(model, quant_kv=quant, paged=paged)
    pf.prefill_request("t", prompt, MNT)
    t_payload, _ = pf.export_kv("t")
    jdec = jsrv(quant, paged)
    jdec.import_kv("t", t_payload, prompt, MNT)
    np.testing.assert_array_equal(_drain(jdec)["t"], ref["tokens", quant])


def test_quant_export_within_dequant_tolerance(model, ref):
    prompt = ref["prompt"]
    segs = {}
    for quant in (False, True):
        pf = _tsrv(model, quant_kv=quant)
        pf.prefill_request("x", prompt, MNT)
        segs[quant] = tinfer.unpack_kv_segment(pf.export_kv("x")[0])
    for li, (lq, lf) in enumerate(zip(segs[True]["layers"],
                                       segs[False]["layers"])):
        for code, scale in (("k", "ks"), ("v", "vs")):
            deq = lq[code].float() * lq[scale][..., None]
            if li == 0:
                # Layer 0 sees the same inputs in both servers: absmax
                # int8 bounds |err| by half a step.
                bound = lq[scale][..., None] * 0.51 + 1e-6
                assert bool(((deq - lf[code]).abs() <= bound).all())
            else:
                torch.testing.assert_close(deq, lf[code], atol=2e-2,
                                           rtol=0)


def test_import_rejects_torn_and_mismatched_segments(model, ref):
    _, _, tcfg, _ = model
    prompt = ref["prompt"]
    pf = _tsrv(model)
    pf.prefill_request("x", prompt, MNT)
    payload, _ = pf.export_kv("x")
    dec = _tsrv(model)
    torn = bytearray(payload)
    torn[len(torn) // 2] ^= 0xFF
    with pytest.raises(tinfer.KvSegmentError):
        dec.import_kv("x", bytes(torn), prompt, MNT)
    with pytest.raises(tinfer.KvSegmentError, match="tokens"):
        dec.import_kv("x", payload, prompt[:-1], MNT)
    with pytest.raises(tinfer.KvSegmentError, match="quant"):
        _tsrv(model, quant_kv=True).import_kv("x", payload, prompt, MNT)
    # A payload whose meta declares the wrong rank rejects on the server's
    # own layout, never the payload's.
    n = len(prompt)
    bad_layers = [{"k": torch.zeros(1, tcfg.n_kv_head, n),
                   "v": torch.zeros(1, tcfg.n_kv_head, n)}
                  for _ in range(tcfg.n_layer)]
    bad, _ = tinfer.pack_kv_segment(bad_layers, n, 0, False)
    with pytest.raises(tinfer.KvSegmentError, match="shape"):
        dec.import_kv("x", bad, prompt, MNT)
    staged = tinfer.unpack_kv_segment(payload)["layers"]
    for what, layers in (
        ("layers", staged[:1]),
        ("keys", [dict(lay, ks=lay["k"][..., 0]) for lay in staged]),
        ("dtype", [{k: v.double() for k, v in lay.items()}
                   for lay in staged]),
    ):
        seg, _ = tinfer.pack_kv_segment(layers, n, 0, False)
        with pytest.raises(tinfer.KvSegmentError, match=what):
            dec.import_kv("x", seg, prompt, MNT)
    with pytest.raises(ValueError, match="exceeds max_len"):
        dec.import_kv("x", payload, prompt, 64)
    assert dec.pending_count() == 0


@pytest.mark.parametrize("paged", [False, True], ids=["slotted", "paged"])
def test_prefill_uses_prefix_template(model, paged):
    """A prefixed prefill rides the template store (a hit on the second
    request); the handed-off stream equals the in-place one."""
    prompt = _prompt()
    prefix = np.random.RandomState(9).randint(1, 256, 20).astype(np.int32)
    full = np.concatenate([prefix, prompt])
    pf = _tsrv(model, paged=paged)
    pf.prefill_request("a", full, MNT, prefix_len=20)
    pf.prefill_request("b", full, MNT, prefix_len=20)
    assert pf.prefix_misses == 1 and pf.prefix_hits == 1
    assert pf.warm_prefix_fps() == [tinfer.prefix_fingerprint(prefix)]
    # One template prefill; each of the 33 tokens' prefills scores from
    # position 16 on (chunks at 16, 24 and 25), not the 5 chunks from 0.
    assert pf.template_forwards == 1
    assert pf.prefill_forwards == 2 * 3
    a = tinfer.unpack_kv_segment(pf.export_kv("a")[0])["layers"]
    payload, _ = pf.export_kv("b")
    _same_arrays(tinfer.unpack_kv_segment(payload)["layers"], a)
    dec = _tsrv(model, paged=paged)
    dec.import_kv("b", payload, full, MNT)
    want = _tsrv(model).serve([full], max_new_tokens=MNT)[0]
    np.testing.assert_array_equal(_drain(dec)["b"], want)


def test_dense_segment_imports_into_paged_server(model, ref):
    """Cross-mode: a slotted prefill's monolithic segment imports into a
    paged decode server, and a torn block is caught by its CRC."""
    prompt = ref["prompt"]
    pf = _tsrv(model)
    pf.prefill_request("y", prompt, MNT)
    dense_payload, _ = pf.export_kv("y")
    assert kvseg.segment_block_info(dense_payload) is None
    dec = _tsrv(model, paged=True)
    dec.import_kv("y", dense_payload, prompt, MNT)
    np.testing.assert_array_equal(_drain(dec)["y"], ref["tokens", False])
    pf = _tsrv(model, paged=True)
    pf.prefill_request("z", prompt, MNT)
    torn = bytearray(pf.export_kv("z")[0])
    torn[len(torn) // 2] ^= 0xFF
    with pytest.raises(tinfer.KvSegmentError):
        _tsrv(model, paged=True).import_kv("z", bytes(torn), prompt, MNT)


def test_imports_share_a_batch_with_prefills(model):
    """Imported and prefilled requests in one incremental run, two slots:
    every stream equals the slotted server's in-place serve."""
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 256, n).astype(np.int32) for n in (13, 5, 9)]
    for kw in ({}, {"paged": True}):
        pf = _tsrv(model, **kw)
        dec = _tsrv(model, slots=2, **kw)
        for i, p in enumerate(prompts):
            if i % 2:
                dec.submit(i, p, MNT)
            else:
                pf.prefill_request(i, p, MNT)
                dec.import_kv(i, pf.export_kv(i)[0], p, MNT)
        got = _drain(dec)
        want = _tsrv(model, slots=2).serve(prompts, max_new_tokens=MNT)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i], w)
        assert dec.last_stats["imported"] == 2
