"""Parity of the port's quantization ops (``dlrover_tpu_torch/ops/quant.py``)
with the JAX package's ``dlrover_tpu/ops/quant.py``.

Inputs and noise are drawn with numpy (or by JAX and handed over as numpy
arrays) and go through both sides; the port runs on the CPU, where its
blockwise quantize is the plain version.

Tolerances, each with its reason:

- Blockwise codes and scales: exactly equal to the Pallas kernel in
  interpret mode and to the jnp path.  Both sides take the scale as
  ``max|x| * fp32(1/127)`` (XLA compiles the reference's ``/ 127.0`` so),
  then one IEEE fp32 division and one round-half-to-even per element;
  the maximum and the clip are exact.  Dequantized values: equal bit for bit (one fp32
  product each).
- Dynamic codes: equal, or one level apart where the value before the
  rounding lies within 1e-5 of a .5 boundary.  ``log10`` (and ``10**t``)
  of torch and XLA may differ by an ulp; the scales are exact (a
  maximum).  Dequantized dynamic values: within 3e-6 relative, checked on
  every one of the 256 codes of each map.  XLA folds ``/ (L - 1) * 7``
  into one rounded constant, and its fp32 ``pow`` and torch's differ by
  ulps, which the exponent's range (7 decades) multiplies.
- 8-bit Adam with the reference's noise handed to the port: the first
  update, from moments of exact zero, within 1e-6 of the largest; the
  later ones within 4e-6, the difference of the dequantized moments
  above carried through ``mu / sqrt(nu)``; the
  parameters within that plus one ulp of their sum; the moments' scales
  exact after the first update and within 4e-6 after it; their codes as
  above.
- Training a tiny Llama (one block) for 10 steps at lr 3e-3, which move
  the loss from 5.54 to 3.09: with the reference's noise schedule handed
  to the port, losses within 5e-5 (the dequantization difference above,
  and the fp32 sum order of the gradients, carried through 10 updates);
  with the port's own generator, which draws other bits, within 4e-3.
  That bound is as wide as the effect of quantizing the moments at all,
  so this case checks only that the port trains as the reference does;
  the shared-noise case checks the arithmetic.
"""

import functools
import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.ops import quant as tq
from dlrover_tpu_torch.optim import adam8bit
from dlrover_tpu_torch.parallel import accelerate as tacc

jq = importlib.import_module("dlrover_tpu.ops.quant")
jacc = importlib.import_module("dlrover_tpu.parallel.accelerate")

BLOCK = 128


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tie_block() -> np.ndarray:
    """max 127, so the scale is exactly 1.0, and every other value on a .5
    tie: a kernel that rounds half away from zero or truncates differs."""
    halves = np.arange(63, dtype=np.float32) + 0.5
    vals = np.concatenate([[127.0, -127.0], halves, -halves])
    return vals.astype(np.float32)


def _input(case, dtype):
    rng = np.random.RandomState(zlib.crc32(str(case).encode()))
    if case == "zero_block":
        x = 3.0 * rng.randn(3, BLOCK)
        x[1] = 0.0
    elif case == "ties":
        x = _tie_block()
    else:
        x = 5.0 * rng.randn(*((case,) if isinstance(case, int) else case))
    x = np.asarray(x, np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16))
    return x


BLOCKWISE_CASES = [1, 127, 128, 1000, (3, 77), "zero_block", "ties"]
DTYPES = ["float32", "bfloat16"]


def _to_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == np.float32:
        return torch.from_numpy(x.copy())
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


@jax.jit
def _jax_blockwise(xs):
    """For each input: the reference's Pallas kernel (interpret mode) and
    jnp path, and the kernel's codes dequantized."""
    out = []
    for x in xs:
        codes, scale = jq.quantize_blockwise(x, backend="pallas",
                                             interpret=True)
        codes2, scale2 = jq.quantize_blockwise(x, backend="jnp")
        back = jq.dequantize_blockwise(codes, scale, x.shape)
        out.append((codes, scale, codes2, scale2, back))
    return out


@pytest.fixture(scope="module")
def jax_blockwise():
    """Every case of the reference in one compiled call (one compile for
    all of them): ``{(case, dtype): (input, reference outputs)}``."""
    keys = [(c, d) for d in DTYPES for c in BLOCKWISE_CASES]
    xs = [_input(c, d) for c, d in keys]
    outs = _jax_blockwise([jnp.asarray(x) for x in xs])
    return {k: (x, [np.asarray(o) for o in out])
            for k, x, out in zip(keys, xs, outs)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", BLOCKWISE_CASES)
def test_blockwise_matches_pallas_kernel_and_jnp_exactly(case, dtype,
                                                          jax_blockwise):
    x, (jc, js, jc2, js2, jback) = jax_blockwise[(case, dtype)]
    tx = _to_torch(x)
    tc, ts = tq.quantize_blockwise(tx)
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    for c, s in ((jc, js), (jc2, js2)):
        np.testing.assert_array_equal(tc.numpy(), c)
        np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                      s.view(np.int32))
    back = tq.dequantize_blockwise(tc, ts, tx.shape)
    assert tuple(back.shape) == x.shape and back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy().view(np.int32),
                                  jback.view(np.int32))
    # The reference smoke's round-trip bound, which truncation breaks.
    xf = np.asarray(x, np.float32)
    err = float(np.max(np.abs(back.numpy() - xf)))
    assert err <= float(np.max(np.abs(xf))) / 254.0 * 1.01


def test_tie_block_rounds_half_to_even():
    codes, scale = tq.quantize_blockwise(torch.from_numpy(_tie_block()))
    assert float(scale[0]) == 1.0
    got = dict(zip(_tie_block()[2:5].tolist(), codes[0, 2:5].tolist()))
    assert got == {0.5: 0, 1.5: 2, 2.5: 2}
    assert codes[0, 2 + 63 + 2].item() == -2  # -2.5 -> -2


def test_blockwise_dequantize_casts_and_unpads():
    x = torch.from_numpy(_input((3, 77), "float32"))
    c, s = tq.quantize_blockwise(x, backend="plain")
    jback = jq.dequantize_blockwise(jnp.asarray(c.numpy()),
                                    jnp.asarray(s.numpy()), (3, 77),
                                    jnp.bfloat16)
    back = tq.dequantize_blockwise(c, s, (3, 77), torch.bfloat16)
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(),
                                  np.asarray(jback, np.float32))


def test_blockwise_stochastic_matches_with_the_same_noise():
    x = _input(1000, "float32")
    key = jax.random.PRNGKey(3)
    jc, js = jq.quantize_blockwise(jnp.asarray(x), stochastic=True, key=key)
    noise = np.array(jax.random.uniform(key, (8, BLOCK)) - 0.5)
    blocks, _ = tq._pad_to_block(torch.from_numpy(x))
    tc, ts = tq._quantize_plain(blocks, torch.from_numpy(noise))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    # With a generator, on the plain path: unbiased to within the noise.
    g = torch.Generator().manual_seed(0)
    y = torch.full((64, BLOCK), 0.3)
    y[:, 0] = 127.0  # scale 1.0 in every block
    c, s = tq.quantize_blockwise(y, stochastic=True, generator=g)
    assert bool((s == 1.0).all())
    mean = float(c[:, 1:].float().mean())
    assert abs(mean - 0.3) < 0.03, mean


def test_blockwise_refusals():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="stochastic"):
        tq.quantize_blockwise(x, stochastic=True, backend="cuda")
    with pytest.raises(ValueError, match="Generator"):
        tq.quantize_blockwise(x, stochastic=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.quantize_blockwise(x, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tq.quantize_blockwise(x, backend="pallas")
    with pytest.raises(ValueError, match="device"):
        tq.quantize_blockwise(x, device="cpu")
    before = tq.quantize_blockwise.launches
    c, s = tq.quantize_blockwise(np.ones(300, np.float32), device="cpu")
    assert c.shape == (3, BLOCK) and tq.quantize_blockwise.launches == before


def _pre_round(x: np.ndarray, signed: bool, noise=None) -> np.ndarray:
    """The reference's log level before its rounding, in float64 from the
    fp32 magnitudes, ``[ceil(n/128), 128]``."""
    flat = np.asarray(x, np.float32).reshape(-1)
    flat = np.concatenate([flat, np.zeros((-flat.size) % BLOCK, np.float32)])
    blocks = flat.reshape(-1, BLOCK)
    scale = np.maximum(np.abs(blocks).max(-1), np.float32(1e-30))
    mag = (np.abs(blocks) / scale[:, None]).astype(np.float64)
    pos = (np.log10(np.maximum(mag, 1e-30)) + 7.0) / 7.0
    t = pos * ((127.0 if signed else 255.0) - 1.0)
    return t if noise is None else t + np.asarray(noise, np.float64)


def _assert_codes_match(got, want, t):
    """Equal, or one level apart only where ``t`` is within 1e-5 of a .5
    boundary (``log10`` differs by an ulp between the frameworks)."""
    got = np.asarray(got, np.int32)
    want = np.asarray(want, np.int32)
    diff = got != want
    if diff.any():
        assert np.abs(got - want)[diff].max() == 1
        near = np.abs(t - np.floor(t) - 0.5) < 1e-5
        assert near[diff].all(), t[diff & ~near][:5]


_jit_deq_dyn = jax.jit(jq.dequantize_dynamic, static_argnums=2,
                       static_argnames="signed")
_jit_dyn_nokey = jax.jit(lambda x, signed: jq.quantize_dynamic(
    x, signed=signed), static_argnums=1)


def _moment_like(shape, signed, seed):
    """Values that span the code map's 7 decades, with exact zeros."""
    rng = np.random.RandomState(seed)
    x = np.exp(rng.uniform(-20, 2, size=shape)) * (
        np.sign(rng.randn(*shape)) if signed else 1.0)
    x[rng.rand(*shape) < 0.05] = 0.0
    return x.astype(np.float32)


DYNAMIC_CASES = [(shape, signed, noisy) for shape in [(1000,), (3, 300)]
                 for signed in (True, False) for noisy in (False, True)]


@functools.partial(jax.jit, static_argnums=1)
def _jax_dynamic(xs, cases):
    """For each case: the reference's codes and scales (with ``PRNGKey(7)``
    when noisy), its noise, and its codes dequantized."""
    out = []
    for x, (shape, signed, noisy) in zip(xs, cases):
        key = jax.random.PRNGKey(7) if noisy else None
        jc, js = jq.quantize_dynamic(x, signed=signed, key=key)
        noise = (jax.random.uniform(key, jc.shape) - 0.5 if noisy
                 else jnp.zeros(()))
        back = jq.dequantize_dynamic(jc, js, shape, signed=signed)
        out.append((jc, js, noise, back))
    return out


@pytest.fixture(scope="module")
def jax_dynamic():
    """Every case of the reference in one compiled call: ``{case:
    (input, codes, scales, noise or None, dequantized codes)}``."""
    xs = [_moment_like(shape, signed, seed=len(shape) + 2 * signed)
          for shape, signed, _ in DYNAMIC_CASES]
    outs = _jax_dynamic([jnp.asarray(x) for x in xs], tuple(DYNAMIC_CASES))
    res = {}
    for case, x, (jc, js, noise, back) in zip(DYNAMIC_CASES, xs, outs):
        res[case] = (x, np.array(jc), np.asarray(js),
                     np.array(noise) if case[2] else None, np.asarray(back))
    return res


@pytest.mark.parametrize("case", DYNAMIC_CASES,
                         ids=[f"{s}-{g}-{n}" for s, g, n in DYNAMIC_CASES])
def test_dynamic_codes_match(case, jax_dynamic):
    shape, signed, noisy = case
    x, jc, js, noise, jback = jax_dynamic[case]
    rows = -(-x.size // BLOCK)
    if noisy:
        tc, ts = tq._quantize_dynamic(torch.from_numpy(x), signed,
                                      torch.from_numpy(noise))
    else:
        tc, ts = tq.quantize_dynamic(torch.from_numpy(x), signed=signed)
    assert tc.dtype == torch.int8 and tuple(tc.shape) == (rows, BLOCK)
    np.testing.assert_array_equal(ts.numpy(), js)
    _assert_codes_match(tc.numpy(), jc, _pre_round(x, signed, noise))
    # Dequantize the reference's codes on both sides.
    back = tq.dequantize_dynamic(torch.from_numpy(jc), ts, shape,
                                 signed=signed)
    np.testing.assert_allclose(back.numpy(), jback, rtol=3e-6, atol=0)


def test_dynamic_zero_threshold_and_fill_codes():
    """``mag < 10**-7`` compares in fp32 on both sides: a magnitude of
    exactly fp32(1e-7) keeps a code, the next fp32 below it is zero.  The
    unsigned code of exact zero is -128 and decodes to 0."""
    lo = np.float32(1e-7)
    below = np.nextafter(lo, np.float32(0))
    x = np.zeros(BLOCK, np.float32)
    x[:3] = [1.0, lo, below]
    for signed in (True, False):
        jc, _ = _jit_dyn_nokey(jnp.asarray(x), signed)
        tc, ts = tq.quantize_dynamic(torch.from_numpy(x), signed=signed)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        zero = 0 if signed else -128
        assert tc[0, 1].item() != zero and tc[0, 2].item() == zero
        assert tc[0, 3].item() == zero
        back = tq.dequantize_dynamic(tc, ts, x.shape, signed=signed)
        assert float(back[3]) == 0.0 and float(back[2]) == 0.0
    fill = torch.full((1, BLOCK), -128, dtype=torch.int8)
    assert float(tq.dequantize_dynamic(fill, torch.ones(1), (BLOCK,),
                                       signed=False).abs().max()) == 0.0


@functools.partial(jax.jit, static_argnums=1)
def _jax_noise(count, rows_per_leaf):
    keys = jax.random.split(
        jax.random.fold_in(jax.random.PRNGKey(0), count),
        2 * len(rows_per_leaf))
    return [jax.random.uniform(keys[2 * i + j], (rows, BLOCK)) - 0.5
            for i, rows in enumerate(rows_per_leaf) for j in (0, 1)]


@pytest.mark.parametrize("signed", [True, False])
def test_dequantize_dynamic_every_code(signed):
    """Every code of the map, through both sides' dequantization."""
    codes = np.arange(-128, 128, dtype=np.int8).reshape(2, BLOCK)
    scale = np.array([1.0, 3.5], np.float32)
    jback = _jit_deq_dyn(jnp.asarray(codes), jnp.asarray(scale), (256,),
                         signed=signed)
    back = tq.dequantize_dynamic(torch.from_numpy(codes),
                                 torch.from_numpy(scale), (256,),
                                 signed=signed)
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=3e-6,
                               atol=0)
    zero = 0 if signed else -128
    assert float(back[zero + 128]) == 0.0


def _reference_noise(count: int, rows_per_leaf):
    """The reference's ``adam8bit`` noise for one update: ``fold_in(
    PRNGKey(0), count)`` split into two keys a leaf (mu, then nu)."""
    return [torch.from_numpy(np.array(n))
            for n in _jax_noise(count, tuple(rows_per_leaf))]


def _feed_noise(opt, noises):
    it = iter(noises)
    opt._noise = lambda shape, device: next(it)


def _capture_updates(opt):
    """The updates ``opt`` adds to its parameters in its next step."""
    got = []
    per_leaf = opt._per_leaf

    def capture(*args):
        out = per_leaf(*args)
        got.append(out[0].clone())
        return out

    opt._per_leaf = capture
    return got


def _ema(jstate, name, g, b):
    """The reference's moment after this step's EMA, before it is
    requantized: it places the rounding boundaries of the new codes."""
    q = getattr(jstate, name)["w"]
    prev = np.asarray(_jit_deq_dyn(q.codes, q.scale, g.shape,
                                   signed=name == "mu"))
    term = g if name == "mu" else np.square(g)
    return np.float32(b) * prev + np.float32(1 - b) * term


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam8bit_three_steps_match_reference(wd):
    """One leaf of 350 values (three blocks, the last ragged) through three
    updates of the reference's ``adam8bit`` and of the port's, the
    reference's noise handed to the port."""
    lr = 1e-2
    shape = (7, 50)
    w0 = np.random.RandomState(0).randn(*shape).astype(np.float32)
    tx = jq.adam8bit(lr, weight_decay=wd)
    jparams = {"w": jnp.asarray(w0)}
    jstate = tx.init(jparams)
    jupdate = jax.jit(tx.update)
    p = torch.from_numpy(w0.copy()).requires_grad_(True)
    opt = adam8bit(lr, weight_decay=wd)([p])
    for count in (1, 2, 3):
        g = (np.random.RandomState(10 + count).randn(*shape)
             * 10.0 ** -count).astype(np.float32)
        ema = {"mu": _ema(jstate, "mu", g, 0.9),
               "nu": _ema(jstate, "nu", g, 0.999)}
        upd, jstate = jupdate({"w": jnp.asarray(g)}, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        noises = _reference_noise(count, [3])
        _feed_noise(opt, noises)
        got = _capture_updates(opt)
        p.grad = torch.from_numpy(g)
        opt.step()
        want = np.asarray(upd["w"])
        tol = (1e-6 if count == 1 else 4e-6) * np.abs(want).max()
        np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=tol)
        # p + update rounds to within one ulp of the reference's sum.
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=2 ** -22,
                                   atol=tol)
        for name, signed, noise in (("mu", True, noises[0]),
                                    ("nu", False, noises[1])):
            jm = getattr(jstate, name)["w"]
            tm = opt.state[p][name]
            # max|moment|: exact from zero moments, then it carries the
            # dequantization difference.
            np.testing.assert_allclose(tm.scale.numpy(), np.asarray(jm.scale),
                                       rtol=0 if count == 1 else 4e-6,
                                       atol=0)
            _assert_codes_match(tm.codes.numpy(), np.asarray(jm.codes),
                                _pre_round(ema[name], signed, noise))
    assert opt.count == 3


def test_adam8bit_learns():
    """The reference's ``test_adam8bit_learns`` (``tests/test_ops.py``)."""
    w = torch.tensor([2.0, -3.0, 1.0], requires_grad=True)
    opt = adam8bit(0.1)([w])
    for _ in range(50):
        opt.zero_grad()
        torch.sum(w ** 2).backward()
        opt.step()
    assert float(torch.sum(w.detach() ** 2)) < 0.05


def test_adam8bit_state_is_int8():
    """The reference's ``test_adam8bit_state_is_int8``, and the fills that
    decode to exact zero."""
    w = torch.zeros(300, requires_grad=True)
    opt = adam8bit(0.01)([w])
    mu, nu = opt.state[w]["mu"], opt.state[w]["nu"]
    assert mu.codes.dtype == torch.int8 and nu.codes.dtype == torch.int8
    assert tuple(mu.codes.shape) == (3, BLOCK)  # ceil(300/128) blocks
    assert bool((mu.codes == 0).all()) and bool((nu.codes == -128).all())
    assert bool((mu.scale == 0).all()) and mu.scale.dtype == torch.float32
    assert opt.state_bytes() == 2 * (3 * BLOCK + 4 * 3)


def test_adam8bit_updates_a_parameter_without_gradient():
    """A leaf without a gradient moves as if its gradient were zero, as
    every leaf does in the reference: with weight decay it decays."""
    a = torch.ones(5, requires_grad=True)
    b = torch.ones(5, requires_grad=True)
    opt = adam8bit(0.1, weight_decay=0.5)([a, b])
    a.grad = torch.ones(5)
    opt.step()
    assert b.grad is None and opt.count == 1
    # mu = nu = 0, so the update is the decay alone: -lr * wd * b.
    np.testing.assert_allclose(b.detach().numpy(), 1.0 - 0.1 * 0.5,
                               rtol=1e-6)


LR = 3e-3
STEPS = 10


@pytest.fixture(scope="module")
def tiny_runs():
    """The reference's ``accelerate`` train step with ``adam8bit`` on the
    tiny fp32 Llama (one block), 10 steps on one repeated batch: ``(the
    initial parameters as numpy, the batch, the losses)``."""
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, n_layer=1)
    # The reference's parameter tree and scales (norms 1, matrices
    # N(0, 0.02)), drawn with numpy: no compile of its init.
    rng = np.random.RandomState(0)
    tree = jax.tree.map(
        lambda s: np.ones(s.shape, np.float32) if len(s.shape) == 1 else
        (0.02 * rng.randn(*s.shape)).astype(np.float32),
        jax.eval_shape(functools.partial(jllama.init_params, cfg=jcfg),
                       jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, tree)
    batch = {"tokens": np.random.RandomState(0).randint(
        0, 256, size=(4, 17)).astype(np.int32)}
    tx = jq.adam8bit(LR)
    jstep = jax.jit(jacc._build_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), tx, jacc.Strategy()))
    state = {"params": jp, "opt_state": tx.init(jp), "step": 0}
    losses = []
    for _ in range(STEPS):
        state, m = jstep(state, {"tokens": jnp.asarray(batch["tokens"])})
        losses.append(float(m["loss"]))
    return tree, batch, losses


def _port_run(tree, batch, feed_reference_noise):
    tcfg = tllama.LlamaConfig.tiny(dtype=torch.float32, n_layer=1)
    job = tacc.accelerate(
        loss_fn=lambda p, b: tllama.loss_fn(p, b, tcfg),
        init_fn=lambda g: params_from_numpy(tree, tcfg, device="cpu",
                                            param_dtype=torch.float32),
        optimizer=adam8bit(LR), sample_batch=batch,
        strategy=tacc.Strategy(), device="cpu")
    state = job.create_state(torch.Generator())
    opt = state["opt_state"]
    rows = [st["mu"].codes.shape[0] for st in
            (opt.state[p] for p in tacc.tree_leaves(state["params"]))]
    before = tq.quantize_blockwise.launches
    losses = []
    for count in range(1, STEPS + 1):
        if feed_reference_noise:
            _feed_noise(opt, _reference_noise(count, rows))
        state, m = job.train_step(state, batch)
        losses.append(float(m["loss"]))
    assert tq.quantize_blockwise.launches == before
    return losses


def test_tiny_llama_trains_like_the_reference_with_its_noise(tiny_runs):
    tree, batch, want = tiny_runs
    got = _port_run(tree, batch, feed_reference_noise=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_tiny_llama_trains_like_the_reference_with_its_own_noise(tiny_runs):
    tree, batch, want = tiny_runs
    got = _port_run(tree, batch, feed_reference_noise=False)
    assert want[0] - want[-1] > 0.3
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3)
