"""The reference's keywords on the port's counterparts, and two checks the
records asked for: the int8 KV cache's drift at depth, and
``shard_version``.

1. Keywords.  For each public function of ``dlrover_tpu`` that the port
   has a counterpart of, every keyword of the reference's signature (read
   with ``inspect.signature``) is one the port's counterpart takes.  Where
   the reference's value has no CUDA meaning the port refuses it by name:
   ``interpret=True`` and ``backend="pallas"`` on a CPU tensor raise
   ``ValueError``, the flash tile keywords take only the reference's
   defaults, a JAX PRNG ``key=`` raises, and ``accelerate``'s sharding and
   search keywords raise ``NotImplementedError`` naming the slice that
   brings them (Queue A item 5; ``fp8_init`` item 6).  ``backend=
   "reference"`` runs the plain versions, ``"pallas"`` the kernels, and a
   name the reference's op does not give (``"auto"``, ``"jnp"``) raises;
   ``quantize_blockwise`` also takes its reference's ``"jnp"``.
   ``accelerate(grad_accum=)`` forces ``Strategy.grad_accum``.
2. The int8 cache's drift.  Through 32 layers of the tiny fp32 model the
   port's int8-vs-dense ``forward_step`` logits drift (max |Δ| / span of
   the dense logits) by what the reference's drift on the same weights and
   prompt is, within 1e-3 of it relative: the drift is the reference's
   own, not a fault of the port.
3. ``shard_file.shard_version`` gives the reference's answer on v1 and v2
   shards and on foreign bytes.
"""

import importlib
import inspect
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.models import llama_infer as jinfer
from dlrover_tpu_torch import optim as toptim
from dlrover_tpu_torch.checkpoint import shard_file as tshard
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models import llama_infer as tinfer
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.ops import cross_entropy as txent
from dlrover_tpu_torch.ops import flash_attention as tfa
from dlrover_tpu_torch.ops import quant as tquant
from dlrover_tpu_torch.ops import rmsnorm as trms
from dlrover_tpu_torch.parallel import accelerate as tacc


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (reference module, name) -> the port's module: the functions whose
# keywords the port must take.
COUNTERPARTS = {
    ("dlrover_tpu.ops.rmsnorm", "rmsnorm"): trms,
    ("dlrover_tpu.ops.cross_entropy", "softmax_cross_entropy"): txent,
    ("dlrover_tpu.ops.flash_attention", "flash_attention"): tfa,
    ("dlrover_tpu.ops.quant", "quantize_blockwise"): tquant,
    ("dlrover_tpu.ops.quant", "dequantize_blockwise"): tquant,
    ("dlrover_tpu.ops.quant", "quantize_dynamic"): tquant,
    ("dlrover_tpu.ops.quant", "dequantize_dynamic"): tquant,
    ("dlrover_tpu.parallel.accelerate", "accelerate"): tacc,
    ("dlrover_tpu.checkpoint.shard_file", "shard_version"): tshard,
    ("dlrover_tpu.models.llama_infer", "prefix_fingerprint"): tinfer,
    ("dlrover_tpu.models.llama_infer", "pack_kv_segment"): tinfer,
    ("dlrover_tpu.models.llama_infer", "unpack_kv_segment"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.submit"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.check_capacity"):
        tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.serve"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.serve_incremental"):
        tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.prefill_request"):
        tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.export_kv"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.import_kv"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.warm_prefix_fps"):
        tinfer,
    ("dlrover_tpu.models.llama_infer",
     "DecodeServer.clear_prefix_templates"): tinfer,
}


def _attr(obj, dotted):
    for part in dotted.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("ref_mod,name", list(COUNTERPARTS),
                         ids=[n for _, n in COUNTERPARTS])
def test_port_takes_every_reference_keyword(ref_mod, name):
    ref = inspect.signature(_attr(importlib.import_module(ref_mod), name))
    port = inspect.signature(_attr(COUNTERPARTS[ref_mod, name], name))
    missing = [k for k, p in ref.parameters.items()
               if p.kind != p.VAR_POSITIONAL and k not in port.parameters]
    assert not missing, f"{name} lacks the reference's {missing}"
    # Where both sides give a default, it is the same one (a JAX PRNG key
    # and a TPU backend choice have no torch value beyond None).
    for k, p in ref.parameters.items():
        q = port.parameters[k]
        if p.default is not p.empty and q.default is not q.empty:
            want = p.default
            if isinstance(q.default, torch.dtype):  # jnp.float32 -> name
                want = getattr(torch, np.dtype(want).name)
            assert q.default == want, (name, k, q.default, p.default)


def test_decode_server_takes_prefix_cache_cap():
    ref = inspect.signature(jinfer.DecodeServer.__init__).parameters
    port = inspect.signature(tinfer.DecodeServer.__init__).parameters
    assert port["prefix_cache_cap"].default == \
        ref["prefix_cache_cap"].default == 4


# -- the ops' backend / interpret keywords ------------------------------------

def _cpu_inputs():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 32, generator=g)
    w = torch.rand(32, generator=g) + 0.5
    logits = torch.randn(6, 40, generator=g)
    labels = torch.randint(0, 40, (6,), generator=g)
    q = torch.randn(1, 2, 8, 16, generator=g)
    return x, w, logits, labels, q


def test_backend_keywords_pick_the_plain_versions_on_the_cpu():
    x, w, logits, labels, q = _cpu_inputs()
    base = trms.rmsnorm(x, w, eps=1e-5)
    for backend in (None, "reference"):
        assert torch.equal(trms.rmsnorm(x, w, eps=1e-5, backend=backend),
                           base)
    assert torch.equal(trms.rmsnorm(x, w, eps=1e-5), trms._reference(
        x, w, 1e-5))
    loss = txent.softmax_cross_entropy(logits, labels)
    assert torch.equal(
        txent.softmax_cross_entropy(logits, labels, backend="reference"),
        loss)
    out = tfa.flash_attention(q, q, q)
    ref = tfa.flash_attention(q, q, q, backend="reference")
    assert torch.equal(ref, tfa.reference_attention(q, q, q))
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    defaults = dict(block_q=512, block_k=512, bwd_block_q=256,
                    bwd_block_k=512)
    assert torch.equal(tfa.flash_attention(q, q, q, **defaults), out)
    codes, scale = tquant.quantize_blockwise(x, backend="plain")
    for backend in ("jnp", "auto"):
        c, s = tquant.quantize_blockwise(x, backend=backend)
        assert torch.equal(c, codes) and torch.equal(s, scale)


REFUSED = {
    "rmsnorm_pallas": (lambda x, w, lg, lb, q: trms.rmsnorm(
        x, w, backend="pallas"), ValueError, "launches the CUDA kernel"),
    "rmsnorm_interpret": (lambda x, w, lg, lb, q: trms.rmsnorm(
        x, w, interpret=True), ValueError, "no CUDA meaning"),
    "rmsnorm_unknown": (lambda x, w, lg, lb, q: trms.rmsnorm(
        x, w, backend="triton"), ValueError, "backend must be"),
    # Names the reference's op does not give these values: refused, not
    # guessed at.
    "rmsnorm_auto": (lambda x, w, lg, lb, q: trms.rmsnorm(
        x, w, backend="auto"), ValueError, "backend must be"),
    "xent_jnp": (lambda x, w, lg, lb, q: txent.softmax_cross_entropy(
        lg, lb, backend="jnp"), ValueError, "backend must be"),
    "flash_jnp": (lambda x, w, lg, lb, q: tfa.flash_attention(
        q, q, q, backend="jnp"), ValueError, "backend must be"),
    "xent_pallas": (lambda x, w, lg, lb, q: txent.softmax_cross_entropy(
        lg, lb, backend="pallas"), ValueError, "launches the CUDA kernel"),
    "xent_interpret": (lambda x, w, lg, lb, q: txent.softmax_cross_entropy(
        lg, lb, interpret=True), ValueError, "no CUDA meaning"),
    "flash_pallas": (lambda x, w, lg, lb, q: tfa.flash_attention(
        q, q, q, backend="pallas"), ValueError, "launches the CUDA kernel"),
    "flash_interpret": (lambda x, w, lg, lb, q: tfa.flash_attention(
        q, q, q, interpret=True), ValueError, "no CUDA meaning"),
    "flash_block_q": (lambda x, w, lg, lb, q: tfa.flash_attention(
        q, q, q, block_q=256), ValueError, "block_q=256.*tiles are fixed"),
    "flash_bwd_block_k": (lambda x, w, lg, lb, q: tfa.flash_attention(
        q, q, q, bwd_block_k=128), ValueError, "bwd_block_k=128"),
    "quant_pallas": (lambda x, w, lg, lb, q: tquant.quantize_blockwise(
        x, backend="pallas"), ValueError, "CUDA tensors"),
    "quant_pallas_stochastic": (
        lambda x, w, lg, lb, q: tquant.quantize_blockwise(
            x, backend="pallas", stochastic=True), ValueError,
        "stochastic"),
    "quant_interpret": (lambda x, w, lg, lb, q: tquant.quantize_blockwise(
        x, interpret=True), ValueError, "no CUDA meaning"),
    "quant_key": (lambda x, w, lg, lb, q: tquant.quantize_blockwise(
        x, stochastic=True, key=jax.random.PRNGKey(0)), ValueError,
        "generator="),
    "dynamic_key": (lambda x, w, lg, lb, q: tquant.quantize_dynamic(
        x, key=jax.random.PRNGKey(0)), ValueError, "generator="),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_values_raise_by_name(case):
    fn, exc, match = REFUSED[case]
    with pytest.raises(exc, match=match):
        fn(*_cpu_inputs())


# -- accelerate ---------------------------------------------------------------

def _job(**kw):
    def init_fn(gen):
        return {"w": torch.randn(4, 1, generator=gen)}

    def loss_fn(params, batch):
        return ((batch["x"] @ params["w"]) ** 2).mean()

    sample = kw.pop("sample", {"x": np.ones((4, 4), np.float32)})
    return tacc.accelerate(loss_fn=loss_fn, init_fn=init_fn,
                           optimizer=toptim.adamw(1e-3), sample_batch=sample,
                           strategy=tacc.Strategy(), device="cpu", **kw)


def test_accelerate_grad_accum_forces_the_strategy():
    job = _job(grad_accum=2)
    assert job.strategy.grad_accum == 2
    state = job.create_state(torch.Generator().manual_seed(0))
    state, metrics = job.train_step(state,
                                    {"x": np.ones((4, 4), np.float32)})
    assert state["step"] == 1 and torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="multiple of grad_accum=3"):
        _job(grad_accum=3)
    assert _job(grad_accum=None).strategy.grad_accum == 1


@pytest.mark.parametrize("kw,match", [
    ({"devices": ["cpu"]}, "item 5"),
    ({"batch_axes": ("dp",)}, "item 5"),
    ({"profile_steps": 2}, "item 5"),
    ({"search_evals": 4}, "item 5"),
    ({"cache": "/nonexistent"}, "item 5"),
    ({"fp8_init": dict}, "item 6"),
], ids=["devices", "batch_axes", "profile_steps", "search_evals", "cache",
        "fp8_init"])
def test_accelerate_refuses_later_slice_keywords(kw, match):
    name = next(iter(kw))
    with pytest.raises(NotImplementedError, match=f"{name}=.*{match}"):
        _job(**kw)


# -- the int8 KV cache's drift at depth ---------------------------------------

def test_int8_drift_at_32_layers_is_the_references():
    """max |int8 logits − dense logits| / max |dense logits| of one prefill
    through 32 layers (tiny width, fp32, one seeded prompt): the port's
    equals the reference's within 1e-3 of it."""
    jcfg = jllama.LlamaConfig.tiny(n_layer=32, dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(n_layer=32, dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    B, P = 2, 16
    prompt = np.random.RandomState(0).randint(1, 256, (B, P)).astype(
        np.int32)
    def step(p, t, c):
        return jinfer.forward_step(p, t, jcfg, c)[0]

    drift = {}
    ref = {q: np.asarray(step(jp, jnp.asarray(prompt),
                              jinfer.init_cache(jcfg, B, P, quant_kv=q)))
           for q in (False, True)}
    with torch.inference_mode():
        port = {q: tinfer.forward_step(
            tp, torch.from_numpy(prompt).long(), tcfg,
            tinfer.init_cache(tcfg, B, P, device="cpu", quant_kv=q))[0]
            .numpy() for q in (False, True)}
    for name, lg in (("reference", ref), ("port", port)):
        drift[name] = float(np.abs(lg[True] - lg[False]).max()
                            / np.abs(lg[False]).max())
    assert drift["reference"] > 0
    assert abs(drift["port"] - drift["reference"]) <= \
        1e-3 * drift["reference"], drift


# -- shard_version ------------------------------------------------------------

def test_shard_version_matches_reference():
    from dlrover_tpu.checkpoint import shard_file as jshard
    from dlrover_tpu_torch.common import msgpack_lite

    arr = np.arange(6, dtype=np.float32)
    v2_port = tshard.pack_shard({"a|0": torch.from_numpy(arr)}, {"step": 1})
    v2_ref = jshard.pack_shard({"a|0": arr}, {"step": 1})
    meta = msgpack_lite.packb({"tensors": {"a|0": {
        "dtype": "float32", "shape": [6], "offset": 0, "nbytes": 24}},
        "extra": {}})
    v1 = b"DLRTPUF1" + struct.pack("<Q", len(meta)) + meta + arr.tobytes()
    cases = {"v2_port": (v2_port, 2), "v2_ref": (v2_ref, 2), "v1": (v1, 1),
             "foreign": (b"PK\x03\x04" + bytes(20), None),
             "v3": (b"DLRTPUF3" + bytes(12), None), "short": (b"DLRT", None),
             "empty": (b"", None)}
    for name, (data, want) in cases.items():
        assert tshard.shard_version(data) == want, name
        assert jshard.shard_version(data) == want, name
    assert tshard.shard_version(bytearray(v1)) == 1
    assert tshard.shard_version(memoryview(v2_port)) == 2
