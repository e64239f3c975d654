"""Llama-family decoder LM, in PyTorch.

Held against ``dlrover_tpu/models/llama.py``: :class:`LlamaConfig` and its
presets (``llama2_7b``, ``tiny``, ``small_300m``, ``medium_800m``),
:func:`init_params` (the same parameter tree, names, shapes and stds, with
fp32 norm gains), :func:`_rope`, :func:`_swiglu`, :func:`block_apply`,
:func:`_attention` (the flash and reference paths), :func:`segment_positions`,
:func:`forward_hidden`, :func:`forward`, :func:`uses_fused_lm_head`,
:func:`split_batch`, :func:`loss_fn`, :func:`num_params` and
:func:`flops_per_token`.

Parameters are a plain dict of tensors with the reference's tree, so
``models/convert.py`` carries a JAX parameter tree across one leaf per leaf.
Every projection is cast to ``cfg.dtype`` at use (``w.to(dt)``), as the
reference's ``w.astype(dt)``.  Serving stores the projections in
``cfg.dtype`` (the one-time cast rounds exactly as the cast at use);
training keeps fp32 masters (``init_params(..., param_dtype=float32)``) and
the cast at use carries the gradient back to them.  The norm gains stay
fp32.

``cfg.remat_block`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant), the reference's per-block
``jax.checkpoint``.  Not ported yet, and refused with an error: MoE layers,
fp8 projections and the ring/Ulysses attention backends.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.ops.cross_entropy import (
    linear_softmax_cross_entropy,
    softmax_cross_entropy,
)
from dlrover_tpu_torch.ops.flash_attention import flash_attention, \
    reference_attention
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

TRAINING_SLICE = "a later training slice of the port (see ROADMAP.md)"


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
    # Recompute each block's internals in the backward pass, saving only
    # the residual stream at block boundaries.
    remat_block: bool = False

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
                device: DeviceLike = None,
                param_dtype: Optional[torch.dtype] = None) -> Dict:
    """Random parameters with the reference's tree: normal(0, 0.02)
    projections drawn in fp32 on the device from ``generator`` (which must
    live on that device) and stored in ``param_dtype`` (default
    ``cfg.dtype``; training passes ``torch.float32`` for fp32 masters);
    fp32 ones for the norm gains."""
    dev = resolve_device(device)
    store = cfg.dtype if param_dtype is None else param_dtype

    def dense(fan_in: int, fan_out: int) -> torch.Tensor:
        w = torch.randn((fan_in, fan_out), generator=generator,
                        device=dev, dtype=torch.float32) * 0.02
        return w.to(store)

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


def _attention(x: torch.Tensor, layer: Dict, cfg: LlamaConfig,
               positions: torch.Tensor, attn_impl: str = "auto",
               segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training attention: q/k/v projections, rope, attention (causal, GQA,
    the config's sliding window, ``segment_ids`` for packed sequences),
    ``wo``.  ``attn_impl`` takes the reference's ``backend`` values:
    ``"auto"`` and ``"pallas"`` run :func:`flash_attention` (the kernels on
    the card, their plain versions on the CPU); ``"reference"`` runs
    :func:`reference_attention`, the plain softmax differentiated by
    autograd."""
    if attn_impl in ("ring", "ulysses"):
        raise NotImplementedError(
            f"attn_impl={attn_impl!r} (sequence-parallel attention over a "
            f"mesh) comes with the multi-card slice of the port (see "
            f"ROADMAP.md)"
        )
    if attn_impl in ("auto", "pallas"):
        attend = flash_attention
    elif attn_impl == "reference":
        attend = reference_attention
    else:
        raise ValueError(
            f"attn_impl must be 'auto', 'pallas' or 'reference', got "
            f"{attn_impl!r}"
        )
    B, S, _ = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype
    q = (x @ layer["wq"].to(dt)).reshape(B, S, H, D)
    k = (x @ layer["wk"].to(dt)).reshape(B, S, KV, D)
    v = (x @ layer["wv"].to(dt)).reshape(B, S, KV, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
               causal=True, segment_ids=segment_ids,
               window=cfg.sliding_window)
    out = o.transpose(1, 2).reshape(B, S, H * D)
    return out @ layer["wo"].to(dt)


def block_apply(layer: Dict, x: torch.Tensor, cfg: LlamaConfig,
                positions: torch.Tensor, *,
                attn_fn: Optional[AttnFn] = None, attn_impl: str = "auto",
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One dense transformer block: ``x + attn(norm1(x))``, then
    ``+ swiglu(norm2(.))``.  ``attn_fn(h, layer, cfg, positions)`` swaps
    the attention (the KV-cache decoder plugs in here); without it the
    block takes the flash path.  The reference's second return value, the
    MoE aux loss, is always zero for a dense block and is not returned."""
    if "moe" in layer:
        raise NotImplementedError(
            f"MoE layers are not ported yet; they come with {TRAINING_SLICE}"
        )
    h = rmsnorm(x, layer["ln1"], eps=cfg.rms_eps)
    if attn_fn is not None:
        attn = attn_fn(h, layer, cfg, positions)
    else:
        attn = _attention(h, layer, cfg, positions, attn_impl, segment_ids)
    x = x + attn
    h = rmsnorm(x, layer["ln2"], eps=cfg.rms_eps)
    return x + _swiglu(h, layer["mlp"], cfg.dtype)


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] segment ids -> [B, S] within-segment positions (rope resets
    at every packed-sequence boundary)."""
    S = segment_ids.shape[-1]
    idx = torch.arange(S, device=segment_ids.device)
    change = torch.ones_like(segment_ids, dtype=torch.bool)
    change[..., 1:] = segment_ids[..., 1:] != segment_ids[..., :-1]
    start = torch.cummax(torch.where(change, idx, torch.zeros_like(idx)),
                         dim=-1).values
    return idx - start


def forward_hidden(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   attn_impl: str = "auto",
                   segment_ids: Optional[torch.Tensor] = None,
                   fp8_states=None):
    """tokens [B, S] -> (final-norm hidden [B, S, D], aux dict).

    ``segment_ids`` [B, S] enables packed-sequence training: attention is
    restricted to same-segment pairs and rope positions reset at each
    segment boundary."""
    if fp8_states is not None:
        raise NotImplementedError(
            f"fp8 projections (fp8_states) come with {TRAINING_SLICE}"
        )
    B, S = tokens.shape
    x = params["embed"].to(cfg.dtype)[tokens]
    if segment_ids is not None:
        positions = segment_positions(segment_ids)
    else:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    apply = functools.partial(block_apply, attn_impl=attn_impl,
                              segment_ids=segment_ids)
    for layer in params["layers"]:
        if cfg.remat_block:
            x = checkpoint(apply, layer, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = apply(layer, x, cfg, positions)
    x = rmsnorm(x, params["ln_f"], eps=cfg.rms_eps)
    return x, {"moe_aux": torch.zeros((), dtype=torch.float32,
                                      device=x.device)}


def forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            attn_impl: str = "auto",
            segment_ids: Optional[torch.Tensor] = None, fp8_states=None):
    """tokens [B, S] -> (logits [B, S, vocab] fp32, aux dict)."""
    x, aux = forward_hidden(params, tokens, cfg, attn_impl=attn_impl,
                            segment_ids=segment_ids, fp8_states=fp8_states)
    return (x @ params["lm_head"].to(cfg.dtype)).float(), aux


def uses_fused_lm_head(cfg: LlamaConfig) -> bool:
    """The loss goes through the chunked fused lm-head cross-entropy at
    large vocabularies (the reference's single policy)."""
    return cfg.vocab_size >= 4096


def split_batch(batch: Dict) -> tuple:
    """{"tokens": [B,S+1]} or {"tokens","targets"} -> (tokens, targets)."""
    if "targets" in batch:
        return batch["tokens"], batch["targets"]
    return batch["tokens"][:, :-1], batch["tokens"][:, 1:]


def loss_fn(params: Dict, batch: Dict, cfg: LlamaConfig, *,
            attn_impl: str = "auto", moe_aux_weight: float = 1e-2,
            fused_lm_head: Optional[bool] = None,
            fp8_states=None) -> torch.Tensor:
    """Next-token loss (fp32 scalar).  ``fused_lm_head`` (default: on for
    vocabularies of 4096 and more) routes the projection through the
    chunked fused lm-head cross-entropy; otherwise the fp32 logits go
    through the cross-entropy kernel.  A ``batch["segment_ids"]`` entry
    ([B, S+1] or [B, S]) enables packed-sequence training with the
    reference's ``valid`` masks: pairs that cross a segment boundary, and
    padding (segment < 0), carry no loss; the [B, S] form also masks the
    last position, whose target segment it cannot see."""
    tokens, targets = split_batch(batch)
    seg_full = batch.get("segment_ids")
    seg = valid = None
    if seg_full is not None:
        S = tokens.shape[-1]
        if seg_full.shape[-1] == S + 1:
            seg = seg_full[:, :-1]
            valid = ((seg_full[:, 1:] == seg_full[:, :-1])
                     & (seg_full[:, :-1] >= 0)).float()
        else:
            seg = seg_full
            valid = torch.cat([
                ((seg[:, 1:] == seg[:, :-1]) & (seg[:, :-1] >= 0)).float(),
                torch.zeros(seg.shape[:-1] + (1,), dtype=torch.float32,
                            device=seg.device),
            ], dim=-1)
    if fused_lm_head is None:
        fused_lm_head = uses_fused_lm_head(cfg)
    if fused_lm_head:
        x, aux = forward_hidden(params, tokens, cfg, attn_impl=attn_impl,
                                segment_ids=seg, fp8_states=fp8_states)
        per_tok = linear_softmax_cross_entropy(
            x, params["lm_head"].to(cfg.dtype), targets)
    else:
        logits, aux = forward(params, tokens, cfg, attn_impl=attn_impl,
                              segment_ids=seg, fp8_states=fp8_states)
        per_tok = softmax_cross_entropy(logits, targets)
    if valid is not None:
        ce = torch.sum(per_tok * valid) / torch.clamp_min(torch.sum(valid),
                                                          1.0)
    else:
        ce = torch.mean(per_tok)
    return ce + moe_aux_weight * aux["moe_aux"]


def num_params(params: Dict) -> int:
    def count(node) -> int:
        if isinstance(node, dict):
            return sum(count(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        return math.prod(node.shape)

    return count(params)


def flops_per_token(cfg: LlamaConfig) -> float:
    """~6 * non-embedding params + attention FLOPs (for MFU accounting)."""
    p_layer = (
        cfg.d_model * cfg.n_head * cfg.head_dim  # wq
        + 2 * cfg.d_model * cfg.n_kv_head * cfg.head_dim  # wk, wv
        + cfg.n_head * cfg.head_dim * cfg.d_model  # wo
        + 3 * cfg.d_model * cfg.d_ff  # swiglu
    )
    dense = cfg.n_layer * p_layer + 2 * cfg.vocab_size * cfg.d_model
    attn = 2 * cfg.n_layer * cfg.max_seq_len * cfg.n_head * cfg.head_dim
    return 6.0 * dense + 6.0 * attn
