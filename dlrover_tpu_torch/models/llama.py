"""Llama-family decoder blocks, in PyTorch.

Held against ``dlrover_tpu/models/llama.py``: :class:`LlamaConfig` and its
presets (``llama2_7b``, ``tiny``, ``small_300m``, ``medium_800m``),
:func:`init_params` (the same parameter tree, names, shapes and stds, with
fp32 norm gains), :func:`_rope`, :func:`_swiglu` and :func:`block_apply`.

Parameters are a plain dict of tensors with the reference's tree, so
``models/convert.py`` carries a JAX parameter tree across one leaf per leaf.
Projection weights are stored in ``cfg.dtype``: the reference stores fp32
and casts with ``w.astype(dt)`` at every use, which rounds exactly as the
one-time cast here.  The norm gains stay fp32.

This slice ports the dense decode path.  MoE layers, fp8 projections and
the training attention (the flash-attention kernel behind ``attn_fn=None``)
come with the training slice and are refused here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

TRAINING_SLICE = "the training slice of the port (see ROADMAP.md)"


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 32
    n_head: int = 32
    n_kv_head: int = 32
    d_model: int = 4096
    d_ff: int = 11008
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # MoE layers are not ported yet; any value above 0 is refused.
    num_experts: int = 0
    # >0: each position attends only the last `sliding_window` positions.
    sliding_window: int = 0

    def __post_init__(self):
        if self.num_experts > 0:
            raise NotImplementedError(
                "MoE layers (num_experts > 0) are not ported yet; they "
                f"come with {TRAINING_SLICE}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @classmethod
    def llama2_7b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, **over) -> "LlamaConfig":
        base = dict(
            vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
            d_ff=128, max_seq_len=128,
        )
        base.update(over)
        return cls(**base)

    @classmethod
    def small_300m(cls) -> "LlamaConfig":
        return cls(
            vocab_size=32000, n_layer=12, n_head=16, n_kv_head=16,
            d_model=1024, d_ff=2816, max_seq_len=2048,
        )

    @classmethod
    def medium_800m(cls) -> "LlamaConfig":
        return cls(
            vocab_size=32000, n_layer=24, n_head=16, n_kv_head=16,
            d_model=1536, d_ff=4096, max_seq_len=2048,
        )


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Dict:
    """Random parameters with the reference's tree: normal(0, 0.02)
    projections drawn in fp32 on the device from ``generator`` (which must
    live on that device) and stored in ``cfg.dtype``; fp32 ones for the
    norm gains."""
    dev = resolve_device(device)

    def dense(fan_in: int, fan_out: int) -> torch.Tensor:
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=dev, dtype=torch.float32) * 0.02
        return w.to(cfg.dtype)

    def gain() -> torch.Tensor:
        return torch.ones((cfg.d_model,), dtype=torch.float32, device=dev)

    hd = cfg.head_dim
    params: Dict = {
        "embed": dense(cfg.vocab_size, cfg.d_model),
        "lm_head": dense(cfg.d_model, cfg.vocab_size),
        "ln_f": gain(),
        "layers": [],
    }
    for _ in range(cfg.n_layer):
        params["layers"].append({
            "ln1": gain(),
            "wq": dense(cfg.d_model, cfg.n_head * hd),
            "wk": dense(cfg.d_model, cfg.n_kv_head * hd),
            "wv": dense(cfg.d_model, cfg.n_kv_head * hd),
            "wo": dense(cfg.n_head * hd, cfg.d_model),
            "ln2": gain(),
            "mlp": {
                "w_gate": dense(cfg.d_model, cfg.d_ff),
                "w_up": dense(cfg.d_model, cfg.d_ff),
                "w_down": dense(cfg.d_ff, cfg.d_model),
            },
        })
    return params


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """x: [B, S, H, D]; rotate pairs (d, d + D/2) by fp32 angles of the
    fp32 ``positions`` [B, S]; cast back to ``x.dtype``."""
    D = x.shape[-1]
    half = D // 2
    freqs = 1.0 / (theta ** (
        torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    ))
    angles = positions[:, :, None].float() * freqs[None, None, :]
    cos = torch.cos(angles)[:, :, None, :]  # [B, S, 1, half]
    sin = torch.sin(angles)[:, :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat(
        [xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1
    ).to(x.dtype)


def _swiglu(x: torch.Tensor, mlp: Dict, dt: torch.dtype) -> torch.Tensor:
    g = x @ mlp["w_gate"].to(dt)
    u = x @ mlp["w_up"].to(dt)
    return (F.silu(g) * u) @ mlp["w_down"].to(dt)


AttnFn = Callable[[torch.Tensor, Dict, LlamaConfig, torch.Tensor],
                  torch.Tensor]


def block_apply(layer: Dict, x: torch.Tensor, cfg: LlamaConfig,
                positions: torch.Tensor, *,
                attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """One dense transformer block: ``x + attn(norm1(x))``, then
    ``+ swiglu(norm2(.))``.  ``attn_fn(h, layer, cfg, positions)`` is the
    attention (the KV-cache decoder plugs in here).  The reference's second
    return value, the MoE aux loss, is always zero for a dense block and is
    not returned."""
    if attn_fn is None:
        raise NotImplementedError(
            "block_apply without attn_fn is the training attention path "
            f"(the flash-attention kernel), which comes with {TRAINING_SLICE}"
        )
    if "moe" in layer:
        raise NotImplementedError(
            f"MoE layers are not ported yet; they come with {TRAINING_SLICE}"
        )
    h = rmsnorm(x, layer["ln1"], eps=cfg.rms_eps)
    x = x + attn_fn(h, layer, cfg, positions)
    h = rmsnorm(x, layer["ln2"], eps=cfg.rms_eps)
    return x + _swiglu(h, layer["mlp"], cfg.dtype)
