"""The reference's keywords on the port's counterparts, and two checks the
records asked for: the int8 KV cache's drift at depth, and
``shard_version``.

1. Keywords.  For each public function of ``dlrover_tpu`` that the port
   has a counterpart of, every keyword of the reference's signature (read
   with ``inspect.signature``) is one the port's counterpart takes.  Where
   the reference's value has no CUDA meaning the port refuses it by name:
   ``interpret=True`` and ``backend="pallas"`` on a CPU tensor raise
   ``ValueError``, the flash tile keywords take only the reference's
   defaults, a JAX PRNG ``key=`` raises, and ``accelerate``'s keywords of
   a later slice raise ``NotImplementedError`` naming it (``fp8_init``
   item 6; the search keywords of item 5b are taken since it was ported,
   and their cases now build).  ``backend=
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
from dlrover_tpu_torch.checkpoint import engine as tengine
from dlrover_tpu_torch.common import constants as tconst
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.parallel import layout_planner as tplanner
from dlrover_tpu_torch.parallel import mesh as tmesh
from dlrover_tpu_torch.parallel import ring_attention as tring
from dlrover_tpu_torch.parallel import sequence as tseq
from dlrover_tpu_torch.parallel import sharding as tsharding
from dlrover_tpu_torch.parallel import strategy_search as tss
from dlrover_tpu_torch.trainer import elastic as telastic
from dlrover_tpu_torch.trainer import trainer as ttrainer


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
    ("dlrover_tpu.parallel.accelerate", "infer_param_specs"): tacc,
    ("dlrover_tpu.parallel.accelerate", "search"): tacc,
    ("dlrover_tpu.parallel.accelerate", "aot_analyze"): tacc,
    ("dlrover_tpu.parallel.ring_attention", "ring_attention"): tring,
    ("dlrover_tpu.parallel.sequence", "ulysses_attention"): tseq,
    ("dlrover_tpu.parallel.strategy_search", "BayesStrategySearch.__init__"):
        tss,
    ("dlrover_tpu.parallel.strategy_search", "StrategyCache.__init__"): tss,
    ("dlrover_tpu.parallel.strategy_search", "MasterStrategyCache.__init__"):
        tss,
    ("dlrover_tpu.parallel.strategy_search", "default_space"): tss,
    ("dlrover_tpu.parallel.strategy_search", "estimate_step_hbm_bytes"):
        tss,
    ("dlrover_tpu.parallel.strategy_search", "prune_space_by_memory"): tss,
    ("dlrover_tpu.parallel.strategy_search", "fingerprint"): tss,
    ("dlrover_tpu.models.llama", "loss_fn"): tllama,
    ("dlrover_tpu.parallel.mesh", "MeshSpec.normalized"): tmesh,
    ("dlrover_tpu.parallel.mesh", "build_mesh"): tmesh,
    ("dlrover_tpu.parallel.mesh", "build_hybrid_mesh"): tmesh,
    ("dlrover_tpu.parallel.mesh", "candidate_specs"): tmesh,
    ("dlrover_tpu.parallel.sharding", "logical_to_spec"): tsharding,
    ("dlrover_tpu.parallel.sharding", "tree_logical_to_specs"): tsharding,
    ("dlrover_tpu.parallel.sharding", "shard_tree"): tsharding,
    ("dlrover_tpu.parallel.sharding", "named_sharding_tree"): tsharding,
    ("dlrover_tpu.parallel.sharding", "constraint"): tsharding,
    ("dlrover_tpu.parallel.layout_planner", "plan_layout"): tplanner,
    ("dlrover_tpu.parallel.layout_planner", "plan_report"): tplanner,
    ("dlrover_tpu.parallel.layout_planner", "validate_layout"): tplanner,
    ("dlrover_tpu.models.llama", "param_logical_axes"): tllama,
    ("dlrover_tpu.checkpoint.engine", "CheckpointEngine.load"): tengine,
    ("dlrover_tpu.trainer.elastic", "ElasticTrainer.__init__"): telastic,
    ("dlrover_tpu.trainer.trainer", "Trainer.__init__"): ttrainer,
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
    ("dlrover_tpu.models.llama_infer", "DecodeServer.__init__"): tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.set_remote_draft"):
        tinfer,
    ("dlrover_tpu.models.llama_infer", "DecodeServer.pop_request_stats"):
        tinfer,
    ("dlrover_tpu.models.llama_infer", "serve_journaled"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_spec_accept_round"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_spec_accept_batch"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_spec_programs"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_spec_remote_round"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_adapt_spec_k"): tinfer,
    ("dlrover_tpu.models.llama_infer", "_spec_k_request"): tinfer,
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


@pytest.mark.parametrize("name", ["generate_speculative",
                                  "generate_speculative_batched",
                                  "_spec_decode_round"])
def test_speculative_generators_take_the_reference_keywords(name):
    """The speculative generators take every keyword of the reference with
    its default; the reference's JAX key (``rng``, or the round's draft
    key ``sub``) is a ``torch.Generator`` here (``generator``), as in
    ``generate``."""
    ref = inspect.signature(getattr(jinfer, name)).parameters
    port = inspect.signature(getattr(tinfer, name)).parameters
    renamed = {"rng": "generator", "sub": "generator"}
    assert [renamed.get(k, k) for k in ref] == list(port), name
    for k, p in ref.items():
        if k not in renamed:
            assert port[k].default == p.default, (name, k)


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
    kw.setdefault("strategy", tacc.Strategy())
    return tacc.accelerate(loss_fn=loss_fn, init_fn=init_fn,
                           optimizer=toptim.adamw(1e-3), sample_batch=sample,
                           device="cpu", **kw)


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
    ({"devices": ["cpu"]}, None),
    ({"batch_axes": ("dp",)}, None),
    ({"profile_steps": 2}, "taken"),
    ({"search_evals": 4}, "taken"),
    ({"cache": "/nonexistent"}, "taken"),
    ({"fp8_init": dict}, "item 6"),
], ids=["devices", "batch_axes", "profile_steps", "search_evals", "cache",
        "fp8_init"])
def test_accelerate_refuses_later_slice_keywords(kw, match, tmp_path):
    """fp8 raises naming its item; ``devices`` (this process's one device)
    and ``batch_axes`` came with the mesh slice (item 5a) and build, and
    several devices a process names item 5d.  The search keywords came with
    item 5b: with ``strategy="bo"`` or ``"auto"`` they build (a cache path
    gets the winner's entry)."""
    name = next(iter(kw))
    if match == "taken":
        if name == "cache":
            kw = {"cache": str(tmp_path / "strategies.json")}
        job = _job(strategy="bo" if name != "cache" else "auto",
                   grad_accum=1, **kw)
        assert job.mesh.describe() == "single" and job.search["winner"]
        if name == "cache":
            assert len(tss.StrategyCache(kw["cache"])._load()) == 1
        else:
            assert job.search["kind"] == "bo"
        return
    if match is None:
        job = _job(**kw)
        assert job.batch_axes == ("dp",) if name == "batch_axes" else \
            job.device == torch.device("cpu")
        with pytest.raises(NotImplementedError, match="item 5d"):
            _job(devices=["cpu", "cpu"])
        return
    with pytest.raises(NotImplementedError, match=f"{name}=.*{match}"):
        _job(**kw)


def _sharded_adam8bit():
    """An 8-bit Adam over a leaf tagged as this rank's box of an fsdp=2
    placement (a mesh seen from rank 0, no group needed)."""
    from dlrover_tpu_torch.checkpoint import tree_utils

    mesh = tmesh.Mesh(tmesh.MeshSpec(fsdp=2), np.arange(2), 0)
    w = tsharding.tag(torch.zeros(128, 2), tsharding.Placement(
        mesh, tsharding.PartitionSpec("fsdp"), (256, 2)))
    state = {"params": {"w": w}, "opt_state": tquant.adam8bit(1e-3)([w])}
    tree_utils.state_leaves(state)


def _ring_attention():
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    params = tllama.init_params(cfg, torch.Generator(), "cpu")
    loss = tllama.loss_fn(params, {"tokens": torch.zeros(1, 5,
                                                         dtype=torch.long)},
                          cfg, attn_impl="ring",
                          mesh=tmesh.Mesh(tmesh.MeshSpec(), np.arange(1), 0))
    assert torch.isfinite(loss)


def _taken_job(**kw):
    job = _job(grad_accum=1, **kw)
    assert job.search is not None and job.search["winner"]
    state = job.create_state(torch.Generator().manual_seed(0))
    _, metrics = job.train_step(state, {"x": np.ones((4, 4), np.float32)})
    assert torch.isfinite(metrics["loss"])
    return job


def _taken_sequence_axes():
    job = _job(batch_axes=tsharding.PartitionSpec("dp", "tp"))
    assert job.seq_axis == "tp" and job.reduce_axes == ("dp", "tp")


def _taken_elastic(**kw):
    core = telastic.ElasticTrainer(
        telastic.TrainerConfig(4, 2), loss_fn=None, init_fn=None,
        optimizer=None, fetch_batch=None, dataset_size=4, devices=["cpu"],
        **kw)
    assert core.base_strategy == kw["strategy"]
    assert core.strategy_cache is kw.get("strategy_cache")


def _saver_replicas():
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver

    AsyncCheckpointSaver.seed_from_replicas(None, {}, 1)


#: Every option of Queue A item 5 that stays refused, and the sub-item
#: whose text (``constants.QUEUE_A_ITEMS``) its refusal carries; ``None``
#: for the options of item 5b, which is ported: their cases take the
#: option and build.
ITEM5_REFUSALS = {
    "accelerate_strategy_auto": (lambda: _taken_job(strategy="auto"), None),
    "accelerate_profile_steps": (lambda: _taken_job(
        strategy=[tacc.Strategy(), tacc.Strategy(remat="full")],
        profile_steps=2), None),
    "accelerate_search_evals": (lambda: _taken_job(strategy="bo",
                                                   search_evals=3), None),
    "accelerate_cache": (lambda: _taken_job(strategy="auto",
                                            cache=_MemoryCache()), None),
    "accelerate_devices": (lambda: _job(devices=["cpu", "cpu"]), "5d"),
    "accelerate_sequence_batch_axes": (_taken_sequence_axes, None),
    "remat_offload": (lambda: _job(strategy=tacc.Strategy(
        remat="offload")), "5c"),
    "offload_opt": (lambda: _job(strategy=tacc.Strategy(
        offload_opt=True)), "5c"),
    "quant_grads": (lambda: _job(strategy=tacc.Strategy(
        quant_grads=True)), "5c"),
    "adam8bit_over_shards": (_sharded_adam8bit, "5c"),
    "mesh_two_devices": (lambda: tmesh.build_mesh(
        tmesh.MeshSpec(), devices=["cpu", "cpu"]), "5d"),
    "constraint": (lambda: tsharding.constraint(torch.zeros(1), ("batch",)),
                   "5d"),
    "ring_attention": (_ring_attention, None),
    "elastic_strategy_auto": (lambda: _taken_elastic(strategy="auto"),
                              None),
    "elastic_strategy_cache": (lambda: _taken_elastic(
        strategy=tacc.Strategy(), strategy_cache=_MemoryCache()), None),
    "saver_replicas": (_saver_replicas, "5e"),
}


class _MemoryCache:
    """A strategy cache in a dict (the ``get``/``put`` contract)."""

    def __init__(self):
        self.entries = {}

    def get(self, key):
        return self.entries.get(key)

    def put(self, key, strategy):
        self.entries[key] = strategy


@pytest.mark.parametrize("case", list(ITEM5_REFUSALS))
def test_item5_refusals_name_their_sub_item(case):
    """Item 5 is split into 5a and 5b (the mesh; sequence parallelism and
    the strategy search: ported, their options build) and 5c-5e; no
    refusal names the whole item or a ported sub-item."""
    make, key = ITEM5_REFUSALS[case]
    assert not {"5", "5a", "5b"} & set(tconst.QUEUE_A_ITEMS)
    if key is None:
        make()
        return
    with pytest.raises(NotImplementedError) as e:
        make()
    assert tconst.QUEUE_A_ITEMS[key] in str(e.value)


def test_accelerate_and_the_sdk_take_the_mesh_keywords():
    """``param_specs`` (a tree, a callable of the normalized strategy,
    ``"planner"``), ``batch_axes`` and ``devices`` build; the spec tree is
    reported after ``create_state``; the SDK passes ``param_specs`` and
    ``layout_planner`` to the core and normalizes a ``-1`` mesh."""
    seen = []

    def specs_of(strategy):
        seen.append(strategy.mesh)
        return {"w": tsharding.PartitionSpec("fsdp")}

    job = _job(param_specs=specs_of,
               strategy=tacc.Strategy(mesh=tmesh.MeshSpec(fsdp=-1)))
    assert seen == [] and job.mesh.describe() == "single"
    state = job.create_state(torch.Generator().manual_seed(0))
    assert seen == [tmesh.MeshSpec()]
    assert tuple(job.state_sharding["params"]["w"].spec) == ("fsdp",)
    assert _job(param_specs="planner").dp == 1
    job = _job(batch_axes={"x": tsharding.PartitionSpec(("dp", "fsdp"))},
               devices=["cpu"])
    assert job.batch_axes == ("dp", "fsdp") and job.batch_rank == (0, 1)
    del state
    core = telastic.ElasticTrainer(
        telastic.TrainerConfig(4, 4), loss_fn=None, init_fn=None,
        optimizer=None, fetch_batch=None, dataset_size=4,
        strategy=tacc.Strategy(mesh=tmesh.MeshSpec(fsdp=-1)),
        param_specs="planner", devices=["cpu"])
    assert core.param_specs == "planner"
    assert tacc.resolve_mesh(core.base_strategy.mesh, 4) == \
        tmesh.MeshSpec(fsdp=4)


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


# -- the control plane (the elastic loop) --------------------------------------

CONTROL_PLANE = [
    ("dlrover_tpu.master.master", "dlrover_tpu_torch.master.master",
     "LocalJobMaster.__init__"),
    ("dlrover_tpu.agent.training", "dlrover_tpu_torch.agent.training",
     "ElasticLaunchConfig"),
    ("dlrover_tpu.agent.training", "dlrover_tpu_torch.agent.training",
     "ElasticTrainingAgent.__init__"),
    ("dlrover_tpu.agent.training", "dlrover_tpu_torch.agent.training",
     "launch_agent"),
    ("dlrover_tpu.agent.ckpt_saver", "dlrover_tpu_torch.agent.ckpt_saver",
     "AsyncCheckpointSaver.__init__"),
    ("dlrover_tpu.common.rpc", "dlrover_tpu_torch.common.rpc",
     "RpcServer.__init__"),
    ("dlrover_tpu.common.rpc", "dlrover_tpu_torch.common.rpc",
     "RpcClient.__init__"),
    ("dlrover_tpu.common.rpc", "dlrover_tpu_torch.common.rpc",
     "RpcClient.call"),
    ("dlrover_tpu.agent.master_client",
     "dlrover_tpu_torch.agent.master_client", "build_master_client"),
    ("dlrover_tpu.common.env", "dlrover_tpu_torch.common.env",
     "get_master_standby_addr"),
    ("dlrover_tpu.common.env", "dlrover_tpu_torch.common.env",
     "get_master_state_dir"),
    ("dlrover_tpu.diagnosis.agent", "dlrover_tpu_torch.diagnosis.agent",
     "DiagnosisAgent.diagnose_training_failure"),
] + [
    (f"dlrover_tpu.{mod}", f"dlrover_tpu_torch.{mod}", name)
    for mod, names in (
        ("master.dataset_splitter", (
            "TableDatasetSplitter.__init__", "TextDatasetSplitter.__init__",
            "StreamingDatasetSplitter.__init__", "new_dataset_splitter")),
        ("master.task_manager", (
            "DatasetManager.__init__", "DatasetManager.get_task",
            "DatasetManager.restore", "TaskManager.__init__",
            "TaskManager.new_dataset", "TaskManager.get_task",
            "TaskManager.report_task_result")),
        ("master.event_callback", (
            "TaskRescheduleCallback.__init__",
            "AllReduceNodeHandlingCallback.__init__")),
        ("data.sharding", ("ShardingClient.__init__",
                           "IndexShardingClient.iter_batches")),
        ("agent.node_check", ("node_health_check",)),
        ("diagnosis.data", ("DiagnosisDataManager.__init__",
                            "DiagnosisDataManager.store_data")),
        ("diagnosis.operators", (
            "CheckTrainingHangOperator.__init__",
            "CheckFailureNodeOperator.__init__",
            "CheckStragglerOperator.__init__")),
        ("diagnosis.manager", ("DiagnosisManager.__init__",
                               "DiagnosisManager.enqueue_broadcast")),
        ("trainer.elastic", (
            "resolve_grad_accum", "TrainerConfig", "ElasticTrainer.__init__",
            "ElasticTrainer.build", "ElasticDataLoader.__init__")),
        ("trainer.trainer", (
            "TrainingArgs", "TrainerState", "TrainerControl",
            "build_lr_schedule", "build_optimizer", "Trainer.__init__",
            "Trainer.save", "Trainer.train")),
        ("master.state", (
            "JournalBound.bind_journal", "write_addr", "read_addr",
            "read_lease", "read_state_dir", "JournalTail.__init__",
            "JournalTail.poll", "ControlStateJournal.__init__",
            "ControlStateJournal.append", "ControlStateJournal.snapshot",
            "ControlStateJournal.maybe_snapshot", "MasterState.__init__",
            "MasterState.apply", "MasterState.replay", "recover_into",
            "JournalKeeper.__init__", "attach_state")),
        ("master.standby", (
            "RpcJournalSource.__init__", "RpcJournalSource.sync",
            "StandbyMaster.__init__", "StandbyMaster.watch",
            "StandbyMaster.take_over", "StandbyMaster.rebootstrap",
            "StandbyMaster.run")),
        ("master.statecheck", ("check_state_dir", "main")),
        ("master.main", ("run_standby",)),
        ("run", ("_master_cmd", "_launch_local_master",
                 "_launch_standby_master", "_supervise_ha_masters")),
    )
    for name in names
] + [
    ("dlrover_tpu.agent.master_client",
     "dlrover_tpu_torch.agent.master_client", f"MasterClient.{name}")
    for name in sorted(
        n for n, v in vars(importlib.import_module(
            "dlrover_tpu.agent.master_client").MasterClient).items()
        if callable(v) and (not n.startswith("_") or n == "__init__"))
]


@pytest.mark.parametrize("ref_mod,port_mod,name", CONTROL_PLANE,
                         ids=[n for _, _, n in CONTROL_PLANE])
def test_control_plane_takes_every_reference_keyword(ref_mod, port_mod,
                                                     name):
    """Every keyword of the reference's signature is taken, with the same
    default; what the port does not have yet raises by name when used
    (``tests/test_torch_{master,agent}.py``)."""
    ref = inspect.signature(_attr(importlib.import_module(ref_mod), name))
    port = inspect.signature(_attr(importlib.import_module(port_mod), name))
    assert list(port.parameters) == list(ref.parameters), name
    for k, p in ref.parameters.items():
        assert port.parameters[k].default == p.default, (name, k)


# -- the serving fleet ---------------------------------------------------------

SERVING_MODULES = ("serving.gateway", "serving.replica", "serving.draft",
                   "serving.kvseg", "serving.autoscale", "agent.metrics",
                   "serving.tier", "serving.spillover", "common.hashring",
                   "master.job_auto_scaler")


def _public_callables(mod_name):
    """(module, dotted name) of every public function and class method of
    the port's module that the reference's module also has."""
    port = importlib.import_module(f"dlrover_tpu_torch.{mod_name}")
    ref = importlib.import_module(f"dlrover_tpu.{mod_name}")
    out = []
    for name, obj in sorted(vars(port).items()):
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                port.__name__ or not hasattr(ref, name):
            continue
        if inspect.isfunction(obj):
            out.append((mod_name, name))
        elif inspect.isclass(obj):
            out.append((mod_name, f"{name}.__init__"))
            for m, v in sorted(vars(obj).items()):
                if callable(v) and not m.startswith("_") and \
                        hasattr(getattr(ref, name), m):
                    out.append((mod_name, f"{name}.{m}"))
    return out


SERVING = [c for m in SERVING_MODULES for c in _public_callables(m)]


@pytest.mark.parametrize("mod_name,name", SERVING,
                         ids=[f"{m}:{n}" for m, n in SERVING])
def test_serving_takes_every_reference_keyword(mod_name, name):
    """The fleet's classes and functions take the reference's parameters,
    in its order, with its defaults."""
    ref = inspect.signature(_attr(importlib.import_module(
        f"dlrover_tpu.{mod_name}"), name))
    port = inspect.signature(_attr(importlib.import_module(
        f"dlrover_tpu_torch.{mod_name}"), name))
    assert list(port.parameters) == list(ref.parameters), name
    for k, p in ref.parameters.items():
        assert port.parameters[k].default == p.default, (name, k)


def test_serving_covers_the_fleet():
    names = {n for _, n in SERVING}
    for want in ("GatewayCore.submit", "GatewayCore.poll", "Gateway.__init__",
                 "ReplicaRunner.__init__", "CompletionJournal.append",
                 "DraftWorker.propose", "RemoteDraftClient.propose",
                 "connect_remote_draft", "KvSegmentStore.put",
                 "pull_kv_segment", "Histogram.percentile",
                 "pack_proposals", "decide", "ServeClient.submit"):
        assert want in names, want


def test_serving_covers_the_tier():
    names = {n for _, n in SERVING}
    for want in ("ring_hash", "HashRing.owner", "ServeRegistry.__init__",
                 "ServeRegistry.announce_replica", "RegistryServer.handle",
                 "GatewayTierNode.__init__", "TierClient.submit",
                 "TierClient.result", "TierReplicaLink.call",
                 "merge_snapshots", "TierActuator.__init__",
                 "pick_drain_victim_merged", "SpilloverPolicy.decide",
                 "CellSpillRouter.__init__", "GlobalClient.submit",
                 "merge_global_snapshots", "ServingFleetAutoScaler.__init__",
                 "new_job_auto_scaler", "Histogram.register_gauges",
                 "MetricsRegistry.render", "MetricsServer.__init__",
                 "Gateway.register_gauges"):
        assert want in names, want


def _parser(parse_args, argv, monkeypatch):
    import argparse

    got = {}
    orig = argparse.ArgumentParser.parse_args

    def spy(self, *a, **kw):
        got["parser"] = self
        return orig(self, *a, **kw)

    with monkeypatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, "parse_args", spy)
        parse_args(argv)
    return got["parser"]


@pytest.mark.parametrize("ref_mod,port_mod", [
    ("dlrover_tpu.run", "dlrover_tpu_torch.run"),
    ("dlrover_tpu.master.main", "dlrover_tpu_torch.master.main")])
def test_every_reference_flag_is_taken_or_refused_by_name(
        ref_mod, port_mod, monkeypatch):
    ref = importlib.import_module(ref_mod)
    port = importlib.import_module(port_mod)
    tail = ["train.py"] if ref_mod.endswith("run") else []
    for var in ("DLROVER_TPU_NODE_RANK", "DLROVER_TPU_MASTER_ADDR",
                "DLROVER_TPU_JOB_NAME", "DLROVER_TPU_NODE_ROLE"):
        monkeypatch.delenv(var, raising=False)
    parser = _parser(ref.parse_args, tail, monkeypatch)
    # The defaults are the reference's.
    assert vars(port.parse_args(tail)) == vars(ref.parse_args(tail))
    refuse = getattr(port, "refuse_later_options")
    seen = 0
    for act in parser._actions:
        if not act.option_strings or act.dest == "help":
            continue
        flag = act.option_strings[0]
        if act.nargs == 0:
            argv = [flag]
        elif act.choices:
            argv = [flag, [c for c in act.choices if c != act.default][0]]
        elif act.type in (int, float):
            argv = [flag, "2"]
        else:
            argv = [flag, "x"]
        try:
            got = port.parse_args(argv + tail)
            refuse(got)
        except NotImplementedError as e:
            assert "comes with" in str(e) and "ROADMAP" in str(e), argv
        else:
            want = ref.parse_args(argv + tail)
            assert getattr(got, act.dest) == getattr(want, act.dest), argv
        seen += 1
    assert seen >= 10


def test_serve_elastic_takes_the_reference_flags_and_device(monkeypatch):
    # The port's worker has the reference's flags and defaults, and only
    # ``--device`` besides (the model is the seeded tiny one in fp32).
    import sys

    ref = importlib.import_module("examples.llama_serve_elastic")
    from dlrover_tpu_torch import serve_elastic

    argv = ["--journal_dir", "j", "--slots", "3"]
    monkeypatch.setattr(sys, "argv", ["llama_serve_elastic.py", *argv])
    got = vars(serve_elastic.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(ref.parse_args())
