"""Quantization ops: int8 blockwise quantize/dequantize with a hand-written
CUDA kernel, the dynamic (log-spaced) 8-bit codes, and 8-bit Adam.

Held against ``dlrover_tpu/ops/quant.py``:

- :func:`_quantize_plain` is the jnp path of its ``quantize_blockwise``:
  per 128-element block ``scale = max(max|x| / 127, 1e-12)`` and ``codes =
  clip(round(x / scale [+ noise]), -127, 127)`` in fp32, rounding half to
  even; the CUDA kernel ``csrc/quant.cu`` replaces its Pallas
  ``_quant_kernel`` (launched by ``_quantize_pallas``) and gives the same
  codes and scales bit for bit.  The division by the constant 127 is
  taken as XLA compiles it, a product with fp32 ``1/127`` (its algebraic
  simplifier rewrites ``x / c`` so, in the jnp path and the Pallas kernel
  alike): a true division gives a scale one ulp apart in some blocks,
  which moves codes that sit on a .5 tie.  The division of
  each value by its scale stays a true IEEE division, as in XLA;
- :func:`quantize_blockwise` / :func:`dequantize_blockwise` are the public
  op.  ``backend="auto"`` launches the kernel for a CUDA tensor and runs
  the plain version for a CPU tensor; ``"cuda"`` (or the reference's
  ``"pallas"``) launches the kernel or raises; ``"plain"`` (or ``"jnp"``)
  forces the plain version.  Stochastic rounding stays plain on both
  devices, as in the reference, and takes an explicit ``torch.Generator``
  where the reference takes a PRNG key;
- :func:`quantize_dynamic` / :func:`dequantize_dynamic` are its dynamic
  8-bit codes (signed level ``m`` in [-127, 127] or unsigned in [1, 255]
  stored as ``m - 128``; ``|value| = scale * 10**((|m|-1)/(L-1)*7 - 7)``,
  ``m = 0`` exact zero), in plain PyTorch on both devices as the reference
  computes them in plain jnp;
- :func:`adam8bit` is its optax ``adam8bit`` as an optimizer factory
  (``params -> torch.optim.Optimizer``, the form ``parallel.accelerate``
  takes): the same per-parameter arithmetic (``per_leaf``) on moments
  held as dynamic 8-bit codes with fp32 block scales.

``quantize_blockwise.launches`` counts the kernel's launches; the launch
takes the lean host call of ``ops/_launch.py``.  The 8-bit
Adam update runs in plain PyTorch on the card and launches no kernel of
this module: its moments use the dynamic codes, never the blockwise ones.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops import _backend, _launch
from dlrover_tpu_torch.ops._launch import LO

SOURCES = ("quant.cu", "launch.cuh")
BLOCK = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BACKENDS = ("auto", "cuda", "plain")
# The reference's names for the two forced paths.
_ALIASES = {"pallas": "cuda", "jnp": "plain"}
# The reference's ``max|x| / 127.0`` as XLA compiles it: times fp32(1/127).
_INV_127 = 1.0 / 127.0


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """x -> (the flat values zero-padded to ``[ceil(n / 128), 128]``, n)."""
    n = x.numel()
    pad = (-n) % BLOCK
    flat = x.reshape(-1)
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, BLOCK), n


def _unpad(vals: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = math.prod(shape)
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


def _quantize_plain(blocks: torch.Tensor,
                    noise: Optional[torch.Tensor] = None):
    """fp32 ``[R, 128]`` -> (int8 codes ``[R, 128]``, fp32 scales
    ``[R]``); ``noise`` (uniform in [-0.5, 0.5)) is added before the
    rounding for stochastic rounding."""
    scale = torch.amax(blocks.abs(), dim=-1) * _INV_127
    scale = torch.clamp_min(scale, 1e-12)
    scaled = blocks / scale[:, None]
    if noise is not None:
        scaled = scaled + noise
    codes = torch.clamp(torch.round(scaled), -127, 127)
    return codes.to(torch.int8), scale


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def build() -> None:
    """Compile (if needed) and load the kernel's library."""
    _kernel_fn()


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    return _launch.bind("quant", SOURCES, "dlr_quant_blockwise")


def _launch_kernel(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        raise ValueError(
            f"the blockwise quantize kernel runs on CUDA tensors, got one on "
            f"{x.device} (backend='auto' or 'plain' quantizes a CPU tensor)"
        )
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        # The reference casts every input to fp32 first; fp32 and bf16 are
        # read as they are (bf16 is widened in registers).
        x, code = x.float(), _DTYPE_CODES[torch.float32]
    x = x.contiguous()
    n = x.numel()
    rows = -(-n // BLOCK)
    codes = x.new_empty((rows, BLOCK), dtype=torch.int8)
    scale = x.new_empty((rows,), dtype=torch.float32)
    if n == 0:
        return codes, scale
    fn = _kernel_fn()
    dev = x.get_device()
    xp, cp, sp, st = x.data_ptr(), codes.data_ptr(), scale.data_ptr(), \
        _launch.stream(dev)
    rc = fn(xp & LO, xp >> 32, cp & LO, cp >> 32, sp & LO, sp >> 32, n & LO,
            n >> 32, code, dev, st & LO, st >> 32)
    if rc != 0:
        raise RuntimeError(
            f"blockwise quantize kernel launch failed: CUDA error {rc}"
        )
    quantize_blockwise.launches += 1
    return codes, scale


def _refuse_key(key, name: str) -> None:
    if key is not None:
        raise ValueError(
            f"{name}(key=...): the reference's JAX PRNG key has no torch "
            "meaning; pass a torch.Generator as generator="
        )


def quantize_blockwise(x, *, stochastic: bool = False,
                       generator: Optional[torch.Generator] = None,
                       backend: str = "auto",
                       device: DeviceLike = None,
                       key=None, interpret: bool = False):
    """x -> (int8 codes ``[ceil(n/128), 128]``, fp32 scales
    ``[ceil(n/128)]``).

    ``x`` is a tensor of any shape and type (read as fp32), or an array
    that is first put on ``device`` (default: the CUDA device; ``"cpu"``
    to run the plain version).  ``backend``: ``"auto"`` launches the
    kernel for a CUDA tensor and runs the plain version for a CPU tensor;
    ``"cuda"`` launches the kernel or raises; ``"plain"`` runs the plain
    version.  ``stochastic=True`` adds uniform noise before the rounding,
    drawn from ``generator`` (required), on the plain path on either
    device.  The reference's ``"pallas"`` and ``"jnp"`` are taken as
    ``"cuda"`` and ``"plain"``; its ``key=`` and ``interpret=True``
    raise."""
    _refuse_key(key, "quantize_blockwise")
    _backend.check_interpret(interpret, "quantize_blockwise")
    backend = _ALIASES.get(backend, backend)
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS} or "
                         f"{tuple(_ALIASES)}, got {backend!r}")
    if backend == "cuda" and stochastic:
        raise ValueError(
            "stochastic rounding runs the plain path only (it needs a "
            "torch.Generator); don't force backend='cuda' with "
            "stochastic=True"
        )
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, device=resolve_device(device))
    elif device is not None:
        raise ValueError("device= places an array input; a tensor is "
                         "quantized where it lies")
    if backend == "cuda" or (backend == "auto" and not stochastic
                             and x.device.type == "cuda"):
        return _launch_kernel(x)
    if backend == "auto" and x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"quantize_blockwise runs on cuda (kernel) or cpu (plain), got "
            f"{x.device}"
        )
    blocks, _ = _pad_to_block(x.float())
    noise = None
    if stochastic:
        if generator is None:
            raise ValueError("stochastic rounding needs a torch.Generator")
        noise = torch.rand(blocks.shape, generator=generator,
                           device=blocks.device) - 0.5
    return _quantize_plain(blocks, noise)


quantize_blockwise.launches = 0


def dequantize_blockwise(codes: torch.Tensor, scale: torch.Tensor, shape,
                         dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _unpad(codes.float() * scale[:, None], tuple(shape), dtype)


class Quantized(NamedTuple):
    codes: torch.Tensor  # int8 [blocks, 128]
    scale: torch.Tensor  # fp32 [blocks]


# ---------------------------------------------------------------------------
# Dynamic (log-spaced) 8-bit codes
# ---------------------------------------------------------------------------

_DYN_DECADES = 7.0


def _quantize_dynamic(x: torch.Tensor, signed: bool,
                      noise: Optional[torch.Tensor]):
    """The reference's ``quantize_dynamic`` with its noise given: ``noise``
    is ``[ceil(n/128), 128]`` uniform in [-0.5, 0.5) added to the log
    level before the rounding, or None."""
    blocks, _ = _pad_to_block(x.float())
    scale = torch.clamp_min(torch.amax(blocks.abs(), dim=-1), 1e-30)
    mag = blocks.abs() / scale[:, None]
    levels = 127.0 if signed else 255.0
    pos = (torch.log10(torch.clamp_min(mag, 1e-30)) + _DYN_DECADES) \
        / _DYN_DECADES
    t = pos * (levels - 1.0)
    if noise is not None:
        t = t + noise
    m = torch.round(t) + 1.0
    m = torch.clamp(m, 1.0, levels)
    m = torch.where(mag < 10.0 ** (-_DYN_DECADES), 0.0, m)
    if signed:
        codes = (m * torch.sign(blocks)).to(torch.int8)
    else:
        codes = (m - 128.0).to(torch.int8)  # shift to the int8 range
    return codes, scale


def quantize_dynamic(x: torch.Tensor, *, signed: bool = True,
                     generator: Optional[torch.Generator] = None,
                     key=None):
    """x -> (int8 log-codes ``[ceil(n/128), 128]``, fp32 per-block scale
    ``[ceil(n/128)]``).  With ``generator`` the log level is rounded
    stochastically (uniform noise from it), so that small EMA increments
    accumulate in expectation instead of freezing at the nearest code.
    The reference's ``key=`` raises."""
    _refuse_key(key, "quantize_dynamic")
    noise = None
    if generator is not None:
        rows = -(-x.numel() // BLOCK)
        noise = torch.rand((rows, BLOCK), generator=generator,
                           device=x.device) - 0.5
    return _quantize_dynamic(x, signed, noise)


def dequantize_dynamic(codes: torch.Tensor, scale: torch.Tensor, shape, *,
                       signed: bool = True,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    cf = codes.float()
    if signed:
        m = cf.abs()
        sign = torch.sign(cf)
        levels = 127.0
    else:
        m = cf + 128.0
        sign = 1.0
        levels = 255.0
    mag = torch.pow(10.0, (m - 1.0) / (levels - 1.0) * _DYN_DECADES
                    - _DYN_DECADES)
    vals = torch.where(m == 0.0, 0.0, sign * mag) * scale[:, None]
    return _unpad(vals, tuple(shape), dtype)


# ---------------------------------------------------------------------------
# 8-bit Adam
# ---------------------------------------------------------------------------


def _zero_codes(p: torch.Tensor, fill: int) -> Quantized:
    """Moments of exact zero for ``p``: ``fill`` is the zero code (0
    signed, -128 unsigned), the scales 0."""
    rows = -(-p.numel() // BLOCK)
    return Quantized(
        torch.full((rows, BLOCK), fill, dtype=torch.int8, device=p.device),
        torch.zeros((rows,), dtype=torch.float32, device=p.device))


class Adam8bit(torch.optim.Optimizer):
    """The reference's ``adam8bit`` transform and ``optax.apply_updates``
    as one optimizer.  Its state: per parameter ``mu``, a
    :class:`Quantized` of signed dynamic codes (filled 0), and ``nu``, of
    unsigned codes (filled -128, the code of exact zero), each with fp32
    scales 0; one step count; one ``torch.Generator`` on the parameters'
    device, seeded 0, for the stochastic rounding of the moments (the
    reference's fixed ``PRNGKey(0)``; the two draw different bits).

    Each step, per parameter in order: dequantize, fp32 EMA, bias
    correction with ``b ** count`` in fp32, ``mu_hat / (sqrt(nu_hat) +
    eps)`` plus ``weight_decay * p``, requantize ``mu`` then ``nu`` with
    fresh noise, and add ``-lr * update`` cast to the parameter's type.  A
    parameter without a gradient is updated as if its gradient were
    zero, as the reference updates every leaf."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))
        self.count = 0
        device = self.param_groups[0]["params"][0].device
        self.generator = torch.Generator(device=device).manual_seed(0)
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {"mu": _zero_codes(p, 0),
                                 "nu": _zero_codes(p, -128)}

    def _noise(self, shape, device) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator,
                          device=device) - 0.5

    def state_bytes(self) -> int:
        """Bytes of the moments: every code and every scale."""
        return sum(t.numel() * t.element_size()
                   for st in self.state.values()
                   for q in (st["mu"], st["nu"]) for t in q)

    def _per_leaf(self, g: torch.Tensor, st: dict, p: torch.Tensor,
                  group: dict, bc1: float, bc2: float, lr: float):
        """The reference's ``per_leaf``: (the update in ``g``'s type, the
        new ``mu``, the new ``nu``)."""
        b1, b2, wd = group["b1"], group["b2"], group["weight_decay"]
        gf = g.float()
        mu = dequantize_dynamic(*st["mu"], g.shape, signed=True)
        nu = dequantize_dynamic(*st["nu"], g.shape, signed=False)
        mu = b1 * mu + (1 - b1) * gf
        nu = b2 * nu + (1 - b2) * torch.square(gf)
        upd = (mu / bc1) / (torch.sqrt(nu / bc2) + group["eps"])
        if wd:
            upd = upd + wd * p.float()
        rows = st["mu"].codes.shape
        new_mu = Quantized(*_quantize_dynamic(mu, True,
                                              self._noise(rows, p.device)))
        new_nu = Quantized(*_quantize_dynamic(nu, False,
                                              self._noise(rows, p.device)))
        return (-lr * upd).to(g.dtype), new_mu, new_nu

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        self.count += 1
        count = torch.tensor(float(self.count), dtype=torch.float32)
        for group in self.param_groups:
            lr = group["lr"]
            lr_now = lr(self.count) if callable(lr) else lr
            # 1 - b ** count in fp32, as the reference computes it.
            bc1, bc2 = (float(1 - torch.tensor(b, dtype=torch.float32)
                              ** count) for b in (group["b1"], group["b2"]))
            for p in group["params"]:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                st = self.state[p]
                upd, st["mu"], st["nu"] = self._per_leaf(g, st, p, group,
                                                         bc1, bc2, lr_now)
                p.add_(upd)  # optax.apply_updates
        return loss


def adam8bit(learning_rate: Union[float, Callable[[int], float]],
             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
             weight_decay: float = 0.0
             ) -> Callable[[List[torch.Tensor]], torch.optim.Optimizer]:
    """Adam with 8-bit moments: a factory ``params -> Adam8bit``, as
    ``optim.adamw`` is.  ``learning_rate`` is a number or a schedule of
    the step count (from 1)."""

    def make(params: List[torch.Tensor]) -> torch.optim.Optimizer:
        return Adam8bit(params, learning_rate, b1=b1, b2=b2, eps=eps,
                        weight_decay=weight_decay)

    return make
