"""The port's ``attn_impl`` values against the JAX package's.

``dlrover_tpu/models/llama.py`` ``_attention`` passes ``attn_impl`` to
``flash_attention`` as ``backend=``: ``"reference"`` takes the plain jnp
softmax (``reference_attention``), ``"pallas"`` the flash kernels, and
``"auto"`` the kernels on a TPU and the plain softmax elsewhere.  The port
takes the same values (``dlrover_tpu_torch/models/llama.py``
``_attention``): ``"reference"`` runs its ``reference_attention`` under
autograd, ``"auto"`` and ``"pallas"`` its flash attention (on the CPU the
kernels' plain versions).  Both are held here against the reference's
``loss_fn(attn_impl="reference")`` on ``LlamaConfig.tiny(dtype=float32)``
with the JAX parameters carried across by ``models/convert.py``, with and
without packed segments: loss and every gradient within atol 1e-5 (the same
fp32 arithmetic, summed in another order).  ``"ring"`` and ``"ulysses"``
(sequence parallelism over a mesh) are refused with ``NotImplementedError``
and any other value with ``ValueError``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlrover_tpu.models import llama as jllama
from dlrover_tpu_torch.models import llama as tllama
from dlrover_tpu_torch.models.convert import params_from_numpy
from dlrover_tpu_torch.parallel.accelerate import tree_leaves

ATOL = 1e-5


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
    return jcfg, jp, tcfg, jax.tree.map(np.asarray, jp)


def _batch(segmented: bool):
    B, S = 2, 16
    rng = np.random.RandomState(7)
    b = {"tokens": rng.randint(0, 256, size=(B, S + 1)).astype(np.int32)}
    if segmented:
        ids = np.repeat(np.arange(3), 6)[:S + 1]
        b["segment_ids"] = np.tile(ids, (B, 1)).astype(np.int32)
        b["segment_ids"][-1, -3:] = -1
    return b


@pytest.fixture(scope="module")
def reference(model):
    """``segmented -> (loss, [gradient leaves])`` of the reference's
    ``loss_fn(attn_impl="reference")``, one jitted call each."""
    jcfg, jp, _, _ = model

    @functools.lru_cache(maxsize=None)
    def loss_and_grads(segmented):
        b = {k: jnp.asarray(v) for k, v in _batch(segmented).items()}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b_: jllama.loss_fn(p, b_, jcfg,
                                         attn_impl="reference")))(jp, b)
        return float(loss), [np.asarray(g) for g in
                             jax.tree_util.tree_leaves(grads)]

    return loss_and_grads


@pytest.mark.parametrize("segmented", [False, True])
@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_attn_impl_matches_the_reference(model, reference, impl, segmented):
    _, _, tcfg, tree = model
    want_loss, want_grads = reference(segmented)
    params = params_from_numpy(tree, tcfg, device="cpu",
                               param_dtype=torch.float32)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    b = {k: torch.from_numpy(v) for k, v in _batch(segmented).items()}
    loss = tllama.loss_fn(params, b, tcfg, attn_impl=impl)
    loss.backward()
    assert abs(loss.item() - want_loss) <= ATOL
    got = tree_leaves(params)
    assert len(got) == len(want_grads)
    for p, want in zip(got, want_grads):
        np.testing.assert_allclose(p.grad.numpy(), want, atol=ATOL, rtol=0)


def test_attn_impl_refuses_other_values(model):
    _, _, tcfg, tree = model
    params = params_from_numpy(tree, tcfg, device="cpu",
                               param_dtype=torch.float32)
    b = {k: torch.from_numpy(v) for k, v in _batch(False).items()}
    for impl in ("ring", "ulysses"):
        with pytest.raises(NotImplementedError, match=impl):
            tllama.loss_fn(params, b, tcfg, attn_impl=impl)
    for impl in ("flash", "", "Reference"):
        with pytest.raises(ValueError, match="attn_impl"):
            tllama.loss_fn(params, b, tcfg, attn_impl=impl)
