"""Parity of the port's cross-entropy (``dlrover_tpu_torch/ops/
cross_entropy.py``) with the JAX package's ``dlrover_tpu/ops/
cross_entropy.py``.

On this CPU host the port runs its plain version; the JAX side runs its
Pallas kernel in interpret mode (``backend="pallas", interpret=True``) and
its custom VJP.  The fused lm-head cross-entropy is plain code on both
sides.  The CUDA kernel is held against the plain version on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Inputs come from numpy with a seed.  Tolerances: fp32 atol 1e-5 (the same
fp32 arithmetic, summed in another order); bf16 gradients within 2 bf16
ulps of the reference plus 1e-6 (fp32 compute, one rounding each side).
The fused loss's bf16 dx adds one more term: both sides round dlogits to
bf16 before the ``dlogits @ wᵀ`` product (``_linear_xent_bwd``), so a
dlogit whose fp32 value lies on a rounding boundary may round the other
way, which moves dx by up to ``2**-8 · (|dlogits| @ |w|ᵀ)``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu_torch.ops import cross_entropy as txe

jxe = importlib.import_module("dlrover_tpu.ops.cross_entropy")

ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_close(got: np.ndarray, want: np.ndarray, what: str, extra=0.0):
    a = np.maximum(np.abs(want.astype(np.float64)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(a)) - 7)
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= 2 * ulp + 1e-6 + extra), (what, float(err.max()))


def _logits(shape, seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, shape[-1], size=shape[:-1]).astype(np.int32)
    labels.reshape(-1)[0] = -1  # outside [0, V): the target is 0
    w = rng.randn(*shape[:-1]).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    return x, labels, w


@pytest.mark.parametrize("shape,dtype", [
    ((3, 13, 256), "float32"), ((19, 64), "bfloat16"),
])
def test_softmax_cross_entropy_matches_pallas(shape, dtype):
    """Loss and the gradient of sum(loss * w)."""
    x, labels, w = _logits(shape, seed=sum(shape), dtype=dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def f(lg):
        loss = jxe.softmax_cross_entropy(lg, jnp.asarray(labels),
                                         backend="pallas", interpret=True)
        return jnp.sum(loss * w), loss

    (_, j_loss), j_grad = jax.value_and_grad(f, has_aux=True)(
        jnp.asarray(x, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    t_loss = txe.softmax_cross_entropy(tx, torch.from_numpy(labels))
    torch.sum(t_loss * torch.from_numpy(w)).backward()
    assert t_loss.dtype == torch.float32 and tx.grad.dtype == tdt
    np.testing.assert_allclose(t_loss.detach().numpy(), np.asarray(j_loss),
                               atol=ATOL, rtol=0)
    got = tx.grad.float().numpy()
    want = np.asarray(j_grad, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        _bf16_close(got, want, "dlogits")


def test_int64_labels_and_the_plain_reference():
    x, labels, _ = _logits((5, 40), seed=3)
    a = txe.softmax_cross_entropy(torch.from_numpy(x),
                                  torch.from_numpy(labels).long())
    b = txe._reference(torch.from_numpy(x), torch.from_numpy(labels))
    assert torch.equal(a, b)
    # jax.nn.log_softmax-based reference on in-range labels
    ok = labels >= 0
    want = jxe._reference(jnp.asarray(x[ok]), jnp.asarray(labels[ok]))
    np.testing.assert_allclose(b.numpy()[ok], np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear_cross_entropy_matches_jax(dtype):
    """Loss, dx and dw with ``chunk_rows`` not dividing the rows (18 rows
    in chunks of 8: the last chunk is zero-padded)."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 9, 32).astype(np.float32)
    w = (0.2 * rng.randn(32, 300)).astype(np.float32)
    labels = rng.randint(0, 300, size=(2, 9)).astype(np.int32)
    gw = rng.randn(2, 9).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    if dtype == "bfloat16":
        x, w = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                for a in (x, w))

    def f(x_, w_):
        loss = jxe.linear_softmax_cross_entropy(
            x_, w_, jnp.asarray(labels), chunk_rows=8)
        return jnp.sum(loss * gw), loss

    (_, j_loss), (j_dx, j_dw) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x, jdt),
                                         jnp.asarray(w, jdt))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    t_loss = txe.linear_softmax_cross_entropy(
        tx, tw, torch.from_numpy(labels), chunk_rows=8)
    torch.sum(t_loss * torch.from_numpy(gw)).backward()
    assert t_loss.shape == (2, 9) and t_loss.dtype == torch.float32
    assert tx.grad.dtype == tw.grad.dtype == tdt
    np.testing.assert_allclose(t_loss.detach().numpy(), np.asarray(j_loss),
                               atol=ATOL, rtol=0)
    # |dlogits| @ |w|^T in fp32: the reach of one bf16 rounding flip of
    # the dlogits entering the dx product (module docstring).
    xf, wf = torch.from_numpy(x).reshape(-1, 32), torch.from_numpy(w)
    p = torch.softmax(xf @ wf, dim=-1)
    onehot = torch.nn.functional.one_hot(
        torch.from_numpy(labels).reshape(-1).long(), 300).float()
    dl = (p - onehot) * torch.from_numpy(gw).reshape(-1, 1)
    reach = {"dx": (2.0 ** -8 * dl.abs() @ wf.abs().t()).reshape(2, 9, 32)
             .numpy(), "dw": 0.0}
    for got, want, what in ((tx.grad, j_dx, "dx"), (tw.grad, j_dw, "dw")):
        got, want = got.float().numpy(), np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0,
                                       err_msg=what)
        else:
            _bf16_close(got, want, what, reach[what])


def test_linear_cross_entropy_equals_the_unfused_loss():
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(21, 16).astype(np.float32))
    w = torch.from_numpy((0.3 * rng.randn(16, 50)).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 50, size=21))
    fused = txe.linear_softmax_cross_entropy(x, w, labels, chunk_rows=4)
    plain = txe.softmax_cross_entropy(x @ w, labels)
    torch.testing.assert_close(fused, plain, atol=ATOL, rtol=0)


def test_fused_logits_are_not_rounded_to_bf16():
    """The reference's fp32-output dot on bf16 operands: the port's loss
    equals the loss of the exact fp32 logits, not of bf16-rounded ones."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(6, 64).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randn(64, 40).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rng.randint(0, 40, size=6))
    got = txe.linear_softmax_cross_entropy(x, w, labels)
    exact = txe._reference(x.float() @ w.float(), labels)
    rounded = txe._reference((x @ w).float(), labels)
    torch.testing.assert_close(got, exact, atol=ATOL, rtol=0)
    assert not torch.allclose(got, rounded, atol=ATOL, rtol=0)


def test_cpu_path_launches_nothing_and_other_devices_raise():
    x, labels, _ = _logits((4, 32), seed=1)
    before = txe.xent_fwd.launches
    txe.softmax_cross_entropy(torch.from_numpy(x), torch.from_numpy(labels))
    assert txe.xent_fwd.launches == before
    meta = torch.empty((4, 32), device="meta")
    with pytest.raises(ValueError, match="cuda"):
        txe.xent_fwd(meta, torch.empty((4,), dtype=torch.long,
                                       device="meta"))
    with pytest.raises(ValueError, match="chunk_rows"):
        txe.linear_softmax_cross_entropy(torch.ones(2, 3), torch.ones(3, 4),
                                         torch.zeros(2, dtype=torch.long),
                                         chunk_rows=0)
