"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips on a host without a CUDA
device.  The file imports neither JAX nor the JAX package, so on the GPU
machine (which has no JAX) it runs without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: fp32 atol 1e-5 (fp32 throughout; the kernel sums in another
order and uses the hardware rsqrt); bf16 at most 1 bf16 ulp of the plain
value (fp32 compute, one rounding on both sides).
"""

import numpy as np
import pytest
import torch

from dlrover_tpu_torch.models import llama, llama_infer
from dlrover_tpu_torch.ops import rmsnorm as rms_mod
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the GPU: pytest --noconftest "
                    "-m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.double().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (256, 4096), (5, 100),
                                   (2, 3, 64)])
def test_rmsnorm_kernel_matches_plain(card, dtype, shape):
    g = torch.Generator(device=card).manual_seed(sum(shape))
    x = (2.0 * torch.randn(shape, generator=g, device=card)).to(dtype)
    w = 1.0 + 0.1 * torch.randn(shape[-1], generator=g, device=card)
    before = rmsnorm.launches
    out = rmsnorm(x, w, eps=1e-5)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    ref = rms_mod._reference(x, w, 1e-5)
    err = (out.double() - ref.double()).abs()
    if dtype == torch.float32:
        assert float(err.max()) <= 1e-5
    else:
        assert bool((err <= _bf16_ulp(ref)).all()), float(err.max())


def test_rmsnorm_kernel_refuses_what_it_does_not_take(card):
    x = torch.randn(4, 64, device=card)
    w = torch.ones(64, device=card)
    with pytest.raises(TypeError):
        rmsnorm(x.half(), w)
    with pytest.raises(TypeError):
        rmsnorm(x, w.bfloat16())
    with pytest.raises(ValueError):
        rmsnorm(x.t(), torch.ones(4, device=card))
    with pytest.raises(ValueError):
        rmsnorm(x, w.cpu())


def test_tiny_model_on_the_card_matches_the_cpu(card):
    """A tiny fp32 model: logits and greedy serving on the card (through
    the kernel, 2 * n_layer + 1 launches per forward) equal the CPU's."""
    cfg = llama.LlamaConfig.tiny(dtype=torch.float32)
    cpu = llama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    dev = to(cpu, card)
    toks = torch.randint(1, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1))
    logits = []
    for p, d in ((cpu, "cpu"), (dev, card)):
        cache = llama_infer.init_cache(cfg, 2, 16, device=d)
        logits.append(llama_infer.forward_step(p, toks.to(d), cfg,
                                               cache)[0].cpu())
    assert float((logits[0] - logits[1]).abs().max()) <= 1e-4

    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 12, 3)]
    before = rmsnorm.launches
    srv = llama_infer.DecodeServer(dev, cfg, slots=2, max_len=32,
                                   prompt_buckets=(8, 16))
    out = srv.serve(prompts, 6)
    assert rmsnorm.launches - before == \
        (2 * cfg.n_layer + 1) * srv.last_stats["forwards"]
    ref = llama_infer.DecodeServer(cpu, cfg, slots=2, max_len=32,
                                   prompt_buckets=(8, 16)).serve(prompts, 6)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
