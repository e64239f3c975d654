"""Parity of the port's training path (``dlrover_tpu_torch/models/llama.py``
training functions, ``parallel/accelerate.py``, ``optim``, ``trainer/`` and
``train.py``) with the JAX package's ``dlrover_tpu/models/llama.py``,
``parallel/accelerate.py`` (``_build_train_step`` with ``optax.adamw``),
``trainer/sampler.py`` and ``examples/llama_train.py``, on
``LlamaConfig.tiny(dtype=float32)``.

Both sides take the same parameters: the JAX ``init_params`` tree carried
across by ``params_from_numpy`` as fp32 masters.  Inputs are drawn with
numpy from a seed.  The port runs on the CPU (plain versions of every
kernel); the JAX side runs its CPU path (reference attention under
autodiff, the custom-VJP RMSNorm and cross-entropy).

Tolerances: loss, logits and gradients atol 1e-5 (the same fp32
arithmetic, summed in another order); after each AdamW step, loss and
``grad_norm`` within 1e-5 and every parameter within 1e-5.  The last is
set by AdamW's normalised update ``g / (|g| + eps)`` at ``eps`` = 1e-8: a
gradient entry of about 1e-8 (a sum of cancelling terms) that differs
between the frameworks by a sum-order error of ~3e-10 moves that update
by ~3 %, i.e. by ~0.03 · ``lr`` = 1e-5 per step; larger gradients make
the update insensitive to such errors.
"""

import io
import contextlib
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu.trainer.sampler import ElasticSampler as JSampler
from dlrover_tpu_torch import train as ttrain
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.optim import adamw
from dlrover_tpu_torch.parallel import accelerate as tacc
from dlrover_tpu_torch.trainer import bootstrap
from dlrover_tpu_torch.trainer.sampler import ElasticSampler as TSampler

jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")
jexample = importlib.import_module("examples.llama_train")

ATOL = 1e-5
LR = 3e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    jp = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jcfg, jp, tcfg, tree


def _port_params(tcfg, tree):
    params = params_from_numpy(tree, tcfg, device="cpu",
                               param_dtype=torch.float32)
    for p in tacc.tree_leaves(params):
        p.requires_grad_(True)
    return params


def _batch(B=2, S=16, seed=0, vocab=256, seg=None):
    rng = np.random.RandomState(seed)
    b = {"tokens": rng.randint(0, vocab, size=(B, S + 1)).astype(np.int32)}
    if seg == "s+1":
        ids = np.repeat(np.arange(4), (S + 1 + 3) // 4)[: S + 1]
        b["segment_ids"] = np.tile(ids, (B, 1)).astype(np.int32)
        b["segment_ids"][:, -3:] = -1
    elif seg == "s":
        ids = np.repeat(np.arange(3), (S + 2) // 3)[:S]
        b["segment_ids"] = np.tile(ids, (B, 1)).astype(np.int32)
        b["segment_ids"][-1, -2:] = -1
    return b


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_forward_logits_match_jax(model):
    jcfg, jp, tcfg, tree = model
    b = _batch(seed=1)
    toks = b["tokens"][:, :-1]
    want, _ = jax.jit(lambda p, t: jllama.forward(p, t, jcfg))(
        jp, jnp.asarray(toks))
    got, aux = tllama.forward(_port_params(tcfg, tree),
                              torch.from_numpy(toks), tcfg)
    assert got.dtype == torch.float32 and float(aux["moe_aux"]) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused,seg", [
    (False, None), (True, None), (False, "s+1"), (True, "s"),
])
def test_loss_and_grads_match_jax(model, fused, seg):
    """``loss_fn`` and its gradient, both cross-entropy routes and both
    ``segment_ids`` forms with their ``valid`` masks."""
    jcfg, jp, tcfg, tree = model
    b = _batch(seed=2, seg=seg)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b_: jllama.loss_fn(p, b_, jcfg, fused_lm_head=fused)))(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    params = _port_params(tcfg, tree)
    loss = tllama.loss_fn(params, {k: torch.from_numpy(v)
                                   for k, v in b.items()}, tcfg,
                          fused_lm_head=fused)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= ATOL
    for got, want in zip(tacc.tree_leaves(params), _leaves_np(jgrads)):
        np.testing.assert_allclose(got.grad.numpy(), want, atol=ATOL,
                                   rtol=0)


def test_remat_block_gives_the_same_grads(model):
    _, _, tcfg, tree = model
    b = {k: torch.from_numpy(v) for k, v in _batch(seed=3, seg="s+1").items()}
    grads = []
    for remat in (False, True):
        cfg = tllama.LlamaConfig.tiny(dtype=torch.float32,
                                      remat_block=remat)
        params = _port_params(cfg, tree)
        tllama.loss_fn(params, b, cfg).backward()
        grads.append([p.grad for p in tacc.tree_leaves(params)])
    for a, c in zip(*grads):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)


def test_block_remat_strategy_rebuilds_the_loss(model):
    """``Strategy(remat="block")`` takes the model's per-block remat from
    ``loss_fn_builder``, as the reference does: the same step as without
    it."""
    _, _, tcfg, tree = model
    b = _batch(B=2, seed=5)
    built = []

    def builder(strategy):
        cfg = tllama.LlamaConfig.tiny(dtype=torch.float32,
                                      remat_block=strategy.remat == "block")
        built.append(cfg.remat_block)
        return lambda p, b_: tllama.loss_fn(p, b_, cfg)

    out = []
    for strategy in (tacc.Strategy(), tacc.Strategy(remat="block")):
        job = tacc.accelerate(
            loss_fn=None, loss_fn_builder=builder,
            init_fn=lambda g: params_from_numpy(tree, tcfg, device="cpu",
                                                param_dtype=torch.float32),
            optimizer=adamw(LR), sample_batch=b, strategy=strategy,
            device="cpu")
        state, m = job.train_step(job.create_state(torch.Generator()), b)
        out.append((float(m["loss"]), tacc.tree_leaves(state["params"])))
    assert built == [False, True] and out[0][0] == out[1][0]
    for a, c in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0)


def test_segment_positions_param_count_and_flops_match_jax(model):
    jcfg, jp, tcfg, tree = model
    seg = np.array([[0, 0, 1, 1, 1, 2, -1, -1], [5, 5, 5, 5, 0, 0, 0, 1]],
                   np.int32)
    np.testing.assert_array_equal(
        tllama.segment_positions(torch.from_numpy(seg)).numpy(),
        np.asarray(jax.jit(jllama.segment_positions)(jnp.asarray(seg))))
    assert tllama.num_params(_port_params(tcfg, tree)) == \
        jllama.num_params(jp)
    for name in ("tiny", "small_300m", "medium_800m", "llama2_7b"):
        assert tllama.flops_per_token(getattr(tllama.LlamaConfig, name)()) \
            == jllama.flops_per_token(getattr(jllama.LlamaConfig, name)())
        assert tllama.uses_fused_lm_head(
            getattr(tllama.LlamaConfig, name)()) == \
            jllama.uses_fused_lm_head(getattr(jllama.LlamaConfig, name)())


@pytest.mark.parametrize("accum", [1, 2])
def test_three_adamw_steps_match_jax(model, accum):
    """The port's ``accelerate(...).train_step`` with ``adamw(lr)`` against
    the reference's ``_build_train_step(loss_fn, optax.adamw(lr),
    Strategy(grad_accum=accum))``: loss, ``grad_norm`` and every parameter
    after each of 3 steps."""
    jcfg, jp, tcfg, tree = model
    batches = [_batch(B=4, seed=10 + i) for i in range(3)]
    jstep = jax.jit(jacc._build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(LR),
        jacc.Strategy(grad_accum=accum)))
    tx = optax.adamw(LR)
    jstate = {"params": jp, "opt_state": tx.init(jp), "step": 0}
    job = tacc.accelerate(
        loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
        init_fn=lambda g: params_from_numpy(tree, tcfg, device="cpu",
                                            param_dtype=torch.float32),
        optimizer=adamw(LR), sample_batch=batches[0],
        strategy=tacc.Strategy(grad_accum=accum), param_specs="planner",
        device="cpu")
    tstate = job.create_state(torch.Generator())
    for b in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
        tstate, tm = job.train_step(tstate, b)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= ATOL
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            ATOL * float(jm["grad_norm"])
        for got, want in zip(tacc.tree_leaves(tstate["params"]),
                             _leaves_np(jstate["params"])):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       atol=1e-5, rtol=0)
    assert tstate["step"] == 3


def test_sampler_yields_the_reference_indices():
    """Two epochs on two processes, then a reshard to one process in the
    middle of an epoch."""
    kw = dict(batch_size_per_process=3, num_processes=2, seed=5)
    for pid in (0, 1):
        j, t = JSampler(20, process_id=pid, **kw), \
            TSampler(20, process_id=pid, **kw)
        for _ in range(2):
            got, want = list(t), list(j)
            assert len(got) == len(want) == 3
            for a, c in zip(got, want):
                np.testing.assert_array_equal(a, c)
    j, t = JSampler(20, process_id=0, **kw), TSampler(20, process_id=0, **kw)
    jit, tit = iter(j), iter(t)
    next(jit), next(tit)
    assert t.state_dict() == j.state_dict()
    j2, t2 = j.reshard(1, 0), t.reshard(1, 0)
    for a, c in zip(t2, j2):
        np.testing.assert_array_equal(a, c)
    t3 = TSampler(20, batch_size_per_process=6, seed=5, drop_last=False)
    j3 = JSampler(20, batch_size_per_process=6, seed=5, drop_last=False)
    t3.load_state_dict({"epoch": 1, "completed_steps": 1})
    j3.load_state_dict({"epoch": 1, "completed_steps": 1})
    for a, c in zip(t3, j3):
        np.testing.assert_array_equal(a, c)


def test_synth_tokens_and_config_match_the_example():
    np.testing.assert_array_equal(
        ttrain.synth_tokens([0, 3, 7], 32, 256),
        jexample.synth_tokens([0, 3, 7], 32, 256))
    args = ttrain.parse_args(["--model", "800m", "--remat_block"])
    cfg = ttrain.build_config(args)
    assert cfg.remat_block and cfg.d_model == 1536 and cfg.n_layer == 24
    assert ttrain.build_config(ttrain.parse_args(
        ["--seq_len", "48"])).max_seq_len == 48


def test_train_cli_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert ttrain.main(["--device", "cpu", "--steps", "3",
                            "--seq_len", "16"]) == 0
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith("TRAIN_DONE step=3 ")
    stats = dict(kv.split("=", 1) for kv in line.split()[1:])
    assert np.isfinite(float(stats["loss"]))
    assert all(stats[f"{k}_launches"] == "0" for k in ttrain.KERNELS)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--steps", "1"])


@pytest.mark.parametrize("flags,match", [
    (["--strategy", "auto"], "strategy"), (["--fp8"], "fp8"),
    (["--quant_grads"], "quant_grads"), (["--lora_rank", "4"], "LoRA"),
    (["--init_from", "x"], "init_from"),
    (["--ckpt_dir", "gs://bucket/x"], "ckpt_dir"),
])
def test_train_cli_refuses_later_options(flags, match):
    with pytest.raises(NotImplementedError, match=match):
        ttrain.main(["--device", "cpu", "--steps", "1"] + flags)


@pytest.mark.parametrize("strategy,match", [
    (tacc.Strategy(mesh={"fsdp": 2}), "fsdp"),
    (tacc.Strategy(mesh={"dp": 2}), "dp"),
    (tacc.Strategy(mesh={"tp": 2}), "tp"),
    (tacc.Strategy(remat="full"), "remat"),
    (tacc.Strategy(remat="offload"), "remat"),
    (tacc.Strategy(offload_opt=True), "offload"),
    (tacc.Strategy(fp8=True), "fp8"),
    (tacc.Strategy(quant_grads=True), "quant"),
    ("auto", "search"),
])
def test_accelerate_refuses_later_strategies(strategy, match):
    with pytest.raises(NotImplementedError, match=match):
        tacc.accelerate(loss_fn=None, init_fn=None, optimizer=None,
                        sample_batch={"tokens": np.zeros((2, 3))},
                        strategy=strategy, device="cpu")


def test_accelerate_refuses_frozen_and_sharded_layouts():
    kw = dict(loss_fn=None, init_fn=None, optimizer=None,
              sample_batch={"tokens": np.zeros((2, 3))},
              strategy=tacc.Strategy(), device="cpu")
    with pytest.raises(NotImplementedError, match="LoRA"):
        tacc.accelerate(frozen={"w": torch.zeros(1)}, **kw)
    with pytest.raises(NotImplementedError, match="param_specs"):
        tacc.accelerate(param_specs={"w": ("fsdp",)}, **kw)
    with pytest.raises(ValueError, match="loss_fn_builder"):
        tacc.accelerate(**dict(kw, strategy=tacc.Strategy(remat="block")))
    with pytest.raises(ValueError, match="grad_accum"):
        tacc.accelerate(**dict(kw, strategy=tacc.Strategy(grad_accum=3)))


def test_bootstrap_runs_one_process_and_refuses_a_world(monkeypatch):
    ctx = bootstrap.init()
    assert ctx.num_processes == 1 and ctx.process_id == 0 and ctx.is_leader
    assert ctx.report_step(1) is None
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "2")
    with pytest.raises(NotImplementedError, match="launcher"):
        bootstrap.init()
    monkeypatch.setenv("DLROVER_TPU_NUM_PROCESSES", "1")
    monkeypatch.setenv("DLROVER_TPU_MASTER_ADDR", "127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="master"):
        bootstrap.init()
    assert bootstrap.init(connect_master=False).master_addr == "127.0.0.1:1"


def test_model_refuses_fp8_states(model):
    _, _, tcfg, tree = model
    b = {"tokens": torch.from_numpy(_batch(seed=4)["tokens"])}
    with pytest.raises(NotImplementedError, match="fp8"):
        tllama.loss_fn(_port_params(tcfg, tree), b, tcfg, fp8_states=[{}])
