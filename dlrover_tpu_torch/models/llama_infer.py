"""KV-cache decoding and the continuous-batching server for Llama, in PyTorch.

Held against ``dlrover_tpu/models/llama_infer.py``: :func:`init_cache`,
:func:`_quantize_kv`, :func:`_cached_attention`, :func:`forward_step`,
:func:`_filter_logits`, :func:`_make_sampler`, :func:`generate`,
:func:`generate_ragged`, :func:`prefix_fingerprint` (its own copy of
``serving/replica.py`` ``_prompt_hash``), the KV-segment wire format
(:class:`KvSegmentError`, :func:`pack_kv_segment`,
:func:`unpack_kv_segment`, byte for byte), the paged-KV helpers
(:func:`_paged_block_split`, :func:`_paged_dense_view`,
:func:`_paged_scatter_back`, :func:`_paged_row_view`,
:func:`_paged_row_scatter`, :func:`init_paged_pool`,
:class:`PagedKvArena`) and :class:`DecodeServer` without speculation
(``submit``/``cancel``/``abort``, the single-token step and the
``decode_chunk`` chunk step, slotted or paged, ``check_capacity``,
``block_stats``, ``serve`` with ``shared_prefix``, ``serve_incremental``,
the prefix-template store, ``prefill_request``/``export_kv``/``import_kv``
and every non-speculative branch of ``_run``, templated and imported
admission included).

The reference is functional: every step returns a new cache.  Here the
cache tensors are updated in place (the step writes the new keys and
values into its slots and returns the same layer dicts with a new
offset), which keeps one copy of the cache on the card.  The paged helpers
write the pool in place the same way.

Numerics kept from the reference: attention scores are taken in fp32 from
the cache's values and divided by ``sqrt(D)`` after the product; masks use
the finite ``-1e30``; the probabilities are rounded to the cache dtype
before the PV product, which accumulates in fp32; the attention output is
cast to ``cfg.dtype`` before ``wo``; logits are fp32.  The int8 cache
(``quant_kv``) stores codes with one fp32 absmax scale per (sequence, head,
slot), reads the codes in ``cfg.dtype`` and applies the scales to the fp32
scores (after the ``1/sqrt(D)``) and to the probabilities (before their
rounding).  A sliding-window model decodes through a ring of
``min(max_len, ring_len)`` slots with a per-slot position array (-1 =
unwritten); ``ring=False`` keeps a dense cache, which the server and the
ragged path use.

On a CUDA device the server's decode dispatch is one CUDA graph, captured
once and replayed every round (``models/decode_graph.py``); on the CPU the
same dispatch runs eagerly.

A template, an imported segment and a paged block copy are written into
the server's own cache or pool in place (``copy_``, ``index_copy_``): the
captured graph holds their addresses.  Staged prefill rows and unpacked
segments are CPU tensors (bf16 as ``uint16`` bits on the wire).

Not ported yet, and refused with ``NotImplementedError``: speculative
decoding (``draft``, ``spec_remote``) and :func:`serve_journaled`.
"""

from __future__ import annotations

import collections
import hashlib
import math
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.common.tensor_bytes import (
    byte_view,
    dtype_key,
    torch_dtype,
)
from dlrover_tpu_torch.models.decode_graph import DecodeGraph
from dlrover_tpu_torch.models.llama import LlamaConfig, _rope, block_apply
from dlrover_tpu_torch.ops import rmsnorm as _rmsnorm_mod
from dlrover_tpu_torch.ops.rmsnorm import rmsnorm

SERVING_SLICE = "a later serving slice of the port (see ROADMAP.md)"
NEG_INF = -1e30
# The reference's ``max|x| / 127.0`` as XLA compiles it: times fp32(1/127).
_INV_127 = 1.0 / 127.0

Offset = Union[int, torch.Tensor]


def _kv_arrays(cfg: LlamaConfig, lead: Tuple[int, ...], dev: torch.device,
               quant_kv: bool) -> Dict[str, torch.Tensor]:
    """Zeroed k/v arrays ``[*lead, head_dim]`` in ``cfg.dtype``, or int8
    codes plus fp32 scales ``[*lead]`` under ``quant_kv``."""
    shape = lead + (cfg.head_dim,)
    if quant_kv:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v": torch.zeros(shape, dtype=torch.int8, device=dev),
            "ks": torch.zeros(lead, dtype=torch.float32, device=dev),
            "vs": torch.zeros(lead, dtype=torch.float32, device=dev),
        }
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=dev),
    }


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, *,
               device: DeviceLike = None, ring_len: Optional[int] = None,
               quant_kv: bool = False, ring: bool = True) -> Dict:
    """Zeroed per-layer k/v cache ``[batch, n_kv_head, L, head_dim]`` plus
    the write offset (an int; a ``[batch]`` tensor puts
    :func:`forward_step` in ragged mode).

    ``quant_kv``: int8 ``k``/``v`` codes and fp32 ``ks``/``vs`` scales
    ``[batch, n_kv_head, L]``.  A sliding-window model with ``ring`` gets a
    rolling buffer of ``L = min(max_len, ring_len)`` slots (``max_len``
    when ``ring_len`` is None) and ``pos`` [L], the absolute position each
    slot holds (-1 = unwritten); ``ring=False`` gives it a dense
    ``max_len`` cache, with the window applied as a mask."""
    dev = resolve_device(device)
    L = max_len
    if cfg.sliding_window > 0 and ring and ring_len is not None:
        L = min(max_len, ring_len)
    cache = {
        "layers": [
            _kv_arrays(cfg, (batch, cfg.n_kv_head, L), dev, quant_kv)
            for _ in range(cfg.n_layer)
        ],
        "offset": 0,
    }
    if cfg.sliding_window > 0 and ring:
        cache["pos"] = torch.full((L,), -1, dtype=torch.long, device=dev)
    return cache


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, KV, T, D] -> (int8 codes, fp32 absmax scale [B, KV, T]).  The
    scale is ``max(max|x|, 1e-8) * fp32(1/127)``, the reference's division
    by 127 as XLA compiles it; the codes round half to even."""
    xf = x.float()
    scale = torch.amax(xf.abs(), dim=-1).clamp(min=1e-8) * _INV_127
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def _cached_attention(x: torch.Tensor, layer: Dict, cfg: LlamaConfig,
                      cache_layer: Dict, offset: Offset,
                      positions: torch.Tensor,
                      slot_pos: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                      ) -> torch.Tensor:
    """x: [B, T, C] new tokens; writes their k/v (int8 codes and scales
    under ``quant_kv``) into ``cache_layer`` in place and attends to the
    cache up to each query's position.

    ``offset`` is an int (every row writes at ``offset..offset+T-1``) or a
    ``[B]`` tensor (ragged: row b writes at its own ``offset[b]..``).
    ``slot_pos`` (ring mode) is ``(slots [T], pos [L])``: the ring slots
    the chunk writes and the already-updated absolute position of every
    slot, which the masks read (-1 is masked).  A dense write past the
    cache's length raises; the caller checks capacity."""
    B, T, _ = x.shape
    H, KV, D = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype
    q = (x @ layer["wq"].to(dt)).reshape(B, T, H, D)
    k = (x @ layer["wk"].to(dt)).reshape(B, T, KV, D)
    v = (x @ layer["wv"].to(dt)).reshape(B, T, KV, D)
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    L = cache_layer["k"].shape[2]

    def write(cur: torch.Tensor, new: torch.Tensor) -> None:
        """``new`` [B, KV, T, ...] into ``cur`` [B, KV, L, ...] at the
        mode's slots: one spelling for codes, scales and plain k/v."""
        if torch.is_tensor(offset):
            slots = offset[:, None] + torch.arange(T, device=x.device)
            rows = torch.arange(B, device=x.device)[:, None]
            # cur[rows, :, slots] is [B, T, KV, ...] (advanced dims first).
            cur[rows, :, slots] = new.transpose(1, 2).to(cur.dtype)
        elif slot_pos is not None:
            cur[:, :, slot_pos[0]] = new.to(cur.dtype)
        else:
            if offset + T > L:
                raise IndexError(
                    f"cache write [{offset}, {offset + T}) past its {L} "
                    "slots"
                )
            cur[:, :, offset:offset + T] = new.to(cur.dtype)

    k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)  # [B, KV, T, D]
    quant = "ks" in cache_layer
    if quant:
        k_codes, k_scale = _quantize_kv(k_t)
        v_codes, v_scale = _quantize_kv(v_t)
        write(cache_layer["k"], k_codes)
        write(cache_layer["v"], v_codes)
        write(cache_layer["ks"], k_scale)
        write(cache_layer["vs"], v_scale)
    else:
        write(cache_layer["k"], k_t)
        write(cache_layer["v"], v_t)
    kc, vc = cache_layer["k"], cache_layer["v"]

    rep = H // KV
    # Grouped attention against the compact cache: query heads g*rep..
    # (g+1)*rep-1 read kv head g.  Scores in fp32 (the reference's
    # preferred_element_type=float32) of operands in cfg.dtype (int8 codes
    # are exact there), scaled after the product.
    qg = q.transpose(1, 2).reshape(B, KV, rep * T, D).to(dt)
    s = torch.matmul(qg.float(), kc.float().transpose(-1, -2))
    s = (s / math.sqrt(D)).view(B, KV, rep, T, L)
    if quant:
        # (q . codes_k) * scale_k == q . (codes_k * scale_k)
        s = s * cache_layer["ks"][:, :, None, None, :]
    qpos = positions[:, None, None, :, None]
    if slot_pos is not None:
        kpos = slot_pos[1]
        hidden = (kpos < 0) | (kpos > qpos)
    else:
        kpos = torch.arange(L, device=x.device)
        hidden = kpos > qpos
    if cfg.sliding_window > 0:
        hidden = hidden | (qpos - kpos >= cfg.sliding_window)
    s = s.masked_fill(hidden, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if quant:
        # sum_k p_k (codes_vk scale_vk) == sum_k (p_k scale_vk) codes_vk
        p = p * cache_layer["vs"][:, :, None, None, :]
    p = p.to(dt)
    out = torch.matmul(p.view(B, KV, rep * T, L).float(), vc.float())
    out = (
        out.view(B, H, T, D).transpose(1, 2).reshape(B, T, H * D).to(dt)
    )
    return out @ layer["wo"].to(dt)


def forward_step(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                 cache: Dict, *, assume_empty_cache: bool = False
                 ) -> Tuple[torch.Tensor, Dict]:
    """Score ``tokens`` [B, T] continuing the cached context.  Returns
    (logits [B, T, vocab] fp32, cache with the same layers, written in
    place, and ``offset + T``; in ring mode ``pos`` updated in place).

    Ring mode (a cache with ``pos``) needs ``T <= L`` and, for a chunk of
    ``T > 1`` on a non-empty ring, ``window + T - 1 <= L``;
    ``assume_empty_cache=True`` declares the offset-0 prefill, which may
    fill the whole ring.  Ragged offsets with a ring raise."""
    B, T = tokens.shape
    dt = cfg.dtype
    offset = cache["offset"]
    x = params["embed"].to(dt)[tokens]
    steps = torch.arange(T, device=tokens.device)
    if torch.is_tensor(offset):
        if "pos" in cache:
            raise ValueError(
                "ragged offsets are not supported with the sliding-window "
                "ring cache"
            )
        positions = offset[:, None] + steps[None, :]
    else:
        positions = (offset + steps)[None, :].expand(B, T)
    ring = None
    if "pos" in cache:
        L = cache["pos"].shape[0]
        W = cfg.sliding_window
        if T > L:
            raise ValueError(
                f"chunk of {T} tokens exceeds the {L}-slot ring cache"
            )
        if T > 1 and W + T - 1 > L and not assume_empty_cache:
            raise ValueError(
                f"continuation chunk of {T} tokens needs ring_len >= "
                f"window + T - 1 = {W + T - 1}, have {L}; pass "
                "assume_empty_cache=True only for the offset-0 prefill"
            )
        absolute = offset + steps
        slots = absolute % L
        cache["pos"][slots] = absolute
        ring = (slots, cache["pos"])
    for layer, cache_layer in zip(params["layers"], cache["layers"]):
        def attn_fn(h, layer_, cfg_, positions_, _cache=cache_layer):
            return _cached_attention(h, layer_, cfg_, _cache, offset,
                                     positions_, slot_pos=ring)

        x = block_apply(layer, x, cfg, positions, attn_fn=attn_fn)
    x = rmsnorm(x, params["ln_f"], eps=cfg.rms_eps)
    logits = (x @ params["lm_head"].to(dt)).float()
    new_cache = {"layers": cache["layers"], "offset": offset + T}
    if ring is not None:
        new_cache["pos"] = cache["pos"]
    return logits, new_cache


def _filter_logits(scaled: torch.Tensor, top_k: int,
                   top_p: float) -> torch.Tensor:
    """[B, V] temperature-scaled logits -> the same with everything
    outside the top-k / top-p nucleus set to -inf (ties with the k-th
    value survive; the top token always survives)."""
    if top_k > 0:
        kth = torch.sort(scaled, dim=-1).values[:, -top_k, None]
        scaled = scaled.masked_fill(scaled < kth, -math.inf)
    if top_p > 0.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep_sorted = cum - probs < top_p
        n_keep = keep_sorted.sum(dim=-1).clamp(min=1)
        cutoff = torch.gather(srt, -1, (n_keep - 1)[:, None])
        scaled = scaled.masked_fill(scaled < cutoff, -math.inf)
    return scaled


Picker = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _make_sampler(temperature: float, top_k: int, top_p: float) -> Picker:
    """(logits [B, V], generator) -> [B] token ids: the first maximum at
    temperature 0, else a categorical draw from ``generator`` over the
    top-k / top-p filtered distribution.

    The draw is ``argmax(p / q)`` with ``q ~ Exp(1)`` from ``generator``:
    what ``torch.multinomial(p, 1)`` computes after its checks, whose
    ``.item()`` calls a CUDA graph cannot capture."""

    def pick(logits: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(
            _filter_logits(logits / temperature, top_k, top_p), dim=-1
        )
        q = torch.empty_like(probs).exponential_(1.0, generator=generator)
        return torch.argmax(probs / q, dim=-1)

    return pick


def _generator(device: torch.device,
               generator: Optional[torch.Generator]) -> torch.Generator:
    if generator is not None:
        return generator
    g = torch.Generator(device=device)
    g.manual_seed(0)
    return g


@torch.inference_mode()
def generate(params: Dict, cfg: LlamaConfig, prompts: torch.Tensor, *,
             max_new_tokens: int,
             generator: Optional[torch.Generator] = None,
             temperature: float = 0.0, top_k: int = 0,
             top_p: float = 0.0, quant_kv: bool = False) -> torch.Tensor:
    """[B, P + max_new_tokens]: prompt + continuation.  The prompt is
    scored in one pass, then one token per step against the cache (a ring
    of ``max(P, window)`` slots for a sliding-window model)."""
    if max_new_tokens == 0:
        return prompts
    B, P = prompts.shape
    ring_len = None
    if cfg.sliding_window > 0:
        ring_len = max(P, cfg.sliding_window)
    cache = init_cache(cfg, B, P + max_new_tokens, device=prompts.device,
                       ring_len=ring_len, quant_kv=quant_kv)
    pick = _make_sampler(temperature, top_k, top_p)
    gen = _generator(prompts.device, generator)
    logits, cache = forward_step(params, prompts, cfg, cache,
                                 assume_empty_cache=True)
    tok = pick(logits[:, -1, :], gen)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits, cache = forward_step(params, tok[:, None], cfg, cache)
        tok = pick(logits[:, -1, :], gen)
        out.append(tok)
    return torch.cat([prompts, torch.stack(out, 1).to(prompts.dtype)], 1)


@torch.inference_mode()
def generate_ragged(params: Dict, cfg: LlamaConfig, prompts: torch.Tensor,
                    prompt_lens: torch.Tensor, *, max_new_tokens: int,
                    eos_token: int = -1, pad_token: int = 0,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 0.0, top_k: int = 0,
                    top_p: float = 0.0, quant_kv: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ragged batched decode over right-padded ``prompts`` [B, P] with
    true lengths ``prompt_lens`` [B]: per-row offsets (on a dense cache,
    ``ring=False``) and a per-row stop on ``eos_token``; the loop ends
    once every row has emitted it.  Returns ``(tokens [B, P +
    max_new_tokens], lengths [B])``: row b is its prompt, its continuation
    right after it (EOS kept), then ``pad_token``."""
    B, P = prompts.shape
    N = max_new_tokens
    dev = prompts.device
    prompt_lens = prompt_lens.to(dev, torch.long)
    if N == 0:
        return prompts, prompt_lens
    cache = init_cache(cfg, B, P + N, device=dev, quant_kv=quant_kv,
                       ring=False)
    pick = _make_sampler(temperature, top_k, top_p)
    gen = _generator(dev, generator)
    logits, cache = forward_step(params, prompts, cfg, cache)
    rows = torch.arange(B, device=dev)
    tok = pick(logits[rows, prompt_lens - 1, :], gen)
    cache["offset"] = prompt_lens.clone()

    buf = torch.full((B, N), pad_token, dtype=prompts.dtype, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    i = 0
    while i < N and not bool(done.all()):
        # ``done`` means the row's EOS is already recorded: the EOS token
        # itself lands in the buffer before the row freezes.
        buf[:, i] = torch.where(done, pad_token, tok).to(buf.dtype)
        done_next = done | (tok == eos_token) if eos_token >= 0 else done
        logits, new_cache = forward_step(params, tok[:, None], cfg, cache)
        nxt = pick(logits[:, -1, :], gen)
        new_cache["offset"] = torch.where(
            done_next, cache["offset"], new_cache["offset"]
        )
        cache = new_cache
        tok = torch.where(done_next, tok, nxt)
        done = done_next
        i += 1

    if eos_token >= 0:
        is_eos = buf == eos_token
        written = torch.where(
            is_eos.any(dim=1),
            is_eos.int().argmax(dim=1) + 1,
            torch.full((B,), i, device=dev),
        ).clamp(max=i)
    else:
        written = torch.full((B,), i, device=dev)
    j = torch.arange(P + N, device=dev)[None, :]
    gen_idx = (j - prompt_lens[:, None]).clamp(0, N - 1)
    gen_vals = torch.gather(buf, 1, gen_idx)
    prompt_padded = torch.nn.functional.pad(prompts, (0, N))
    lens = prompt_lens + written
    out = torch.where(j < prompt_lens[:, None], prompt_padded, gen_vals)
    out = torch.where(j < lens[:, None], out,
                      torch.full_like(out, pad_token))
    return out, lens


# -- prefix fingerprints and the KV-segment wire format -----------------------


def prefix_fingerprint(tokens) -> str:
    """Fingerprint of a shared prefix template: what requests carry for
    prefix-aware routing and what keys the server's template store.  The
    first 16 hex digits of the SHA-1 of the tokens' int32 bytes, the
    reference's ``serving/replica.py`` ``_prompt_hash``."""
    return hashlib.sha1(
        np.asarray(tokens, np.int32).tobytes()
    ).hexdigest()[:16]


class KvSegmentError(ValueError):
    """A packed KV segment failed verification (torn bytes, a CRC
    mismatch, or a shape, dtype or config that disagrees with the
    importing server).  Such a segment is never admitted; the fleet
    prefills the request again."""

    #: Marker the replica runner branches on without importing this module.
    KV_REJECT = True


KV_SEGMENT_VERSION = 1


def _host_tensor(arr) -> torch.Tensor:
    """A CPU tensor of ``arr`` (a tensor anywhere, or a numpy array)."""
    if torch.is_tensor(arr):
        return arr.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(arr))


def pack_kv_segment(layers, n: int, first_token: int, quant: bool,
                    block_size: int = 0) -> Tuple[bytes, int]:
    """Pack a prefilled KV segment for the prefill-to-decode handoff.
    ``layers`` is the per-layer list of arrays (tensors or numpy arrays)
    sliced to the ``n`` written slots: ``[1, KV, n, D]`` codes (int8
    with fp32 ``[1, KV, n]`` scales when ``quant``, the model dtype
    otherwise).

    ``block_size > 0`` (paged servers) frames the data as a block list:
    the slot axis is cut into ``ceil(n / block_size)`` blocks (the last
    zero-padded), each block's bytes contiguous with its own CRC-32 in
    the meta.  :func:`unpack_kv_segment` gives the same trimmed layers
    from either framing.

    Returns ``(payload, fp32_bytes)``: the msgpack blob (the data's CRC-32
    inside; bytes equal to the reference's ``pack_kv_segment`` for the
    same arrays: keys sorted, dtypes named as numpy names them, a bf16
    array as its ``uint16`` bits under ``"bfloat16"``) and the k/v
    codes' size at 4 bytes an element."""
    layers = [{kk: _host_tensor(a) for kk, a in lay.items()}
              for lay in layers]
    keys = sorted(layers[0]) if layers else []
    shapes: Dict[str, list] = {}
    if block_size > 0:
        bs = int(block_size)
        nblk = -(-int(n) // bs)
        for kk in keys:
            arr = layers[0][kk]
            shapes[kk] = [list(arr.shape[:2]) + [bs] + list(arr.shape[3:]),
                          dtype_key(arr.dtype)]

        def units(a: torch.Tensor, kk: str) -> torch.Tensor:
            """[1, KV, slots(, D)] -> its zero-padded blocks, block major:
            [nblk, 1, KV, bs(, D)], so a block's piece is a view."""
            a = a[:, :, :nblk * bs]
            if a.shape[2] < nblk * bs:
                full = a.new_zeros(a.shape[:2] + (nblk * bs,) + a.shape[3:])
                full[:, :, :a.shape[2]] = a
                a = full
            return a.reshape(a.shape[:2] + (nblk, bs)
                             + a.shape[3:]).movedim(2, 0).contiguous()
    else:
        nblk = 1
        for kk in keys:
            arr = layers[0][kk]
            shapes[kk] = [list(arr.shape), dtype_key(arr.dtype)]

        def units(a: torch.Tensor, kk: str) -> torch.Tensor:
            if list(a.shape) != shapes[kk][0]:
                raise ValueError(
                    f"ragged KV segment: layer {kk} shape {tuple(a.shape)} "
                    f"!= {shapes[kk][0]}"
                )
            return a.contiguous()[None]

    arrays = []
    for lay in layers:
        for kk in keys:
            arrays.append(units(lay[kk], kk))
    # Block major, then layer, then key: the reference's frame order.
    data = b"".join(byte_view(x[b]) for b in range(nblk) for x in arrays)
    meta_extra: Dict[str, Any] = {}
    if block_size > 0:
        frame = len(data) // nblk if nblk else 0
        view = memoryview(data)
        meta_extra = {"bs": bs, "nblk": nblk,
                      "bcrc": [zlib.crc32(view[b * frame:(b + 1) * frame])
                               for b in range(nblk)]}
    # The k/v codes at 4 bytes an element (the scales of the int8 layout
    # have no fp32 counterpart).
    fp32_bytes = 0
    for kk in ("k", "v"):
        if kk in shapes:
            fp32_bytes += nblk * len(layers) * int(
                np.prod(shapes[kk][0])) * 4
    meta = {
        "v": KV_SEGMENT_VERSION,
        "n": int(n),
        "first": int(first_token),
        "quant": bool(quant),
        "layers": len(layers),
        "keys": keys,
        "shapes": shapes,
        **meta_extra,
    }
    payload = msgpack_lite.packb(
        {"meta": meta, "crc": zlib.crc32(data), "data": data})
    return payload, fp32_bytes


def unpack_kv_segment(payload: bytes) -> Dict[str, Any]:
    """Verify and unpack a :func:`pack_kv_segment` blob (the port's or the
    reference's).  Raises :class:`KvSegmentError` on any damage (an
    unparseable envelope, a CRC mismatch, sizes or types that disagree): a
    torn segment is rejected, never decoded from.  Returns ``{"layers":
    [...], "n", "first", "quant"}`` (and ``"block_size"``, ``"blocks"``
    for a block list) with per-layer CPU tensors."""
    try:
        obj = msgpack_lite.unpackb(payload)
        meta = obj["meta"]
        crc = int(obj["crc"])
        data = obj["data"]
        keys = list(meta["keys"])
        shapes = meta["shapes"]
        n_layers = int(meta["layers"])
    except Exception as e:  # any malformed envelope is a torn segment
        raise KvSegmentError(f"undecodable KV segment: {e}") from None
    if meta.get("v") != KV_SEGMENT_VERSION:
        raise KvSegmentError(
            f"KV segment version {meta.get('v')} != {KV_SEGMENT_VERSION}"
        )
    if not isinstance(data, bytes) or zlib.crc32(data) != crc:
        raise KvSegmentError("KV segment CRC mismatch (torn payload)")
    try:
        sizes = {
            kk: int(np.prod([int(d) for d in shapes[kk][0]]))
            * torch.empty((), dtype=torch_dtype(shapes[kk][1])).element_size()
            for kk in keys
        }
        n = int(meta["n"])
        first = int(meta["first"])
        quant = bool(meta["quant"])
    except Exception as e:  # a meta that names no size is a torn segment
        raise KvSegmentError(f"KV segment meta incoherent: {e}") from None
    frame_size = sum(sizes.values()) * n_layers
    blocks = "bs" in meta
    if blocks:
        # Block list: each block's CRC first (a torn transfer is found in
        # the block that tore), then the blocks join along the slot axis
        # and are trimmed to ``n``.
        bs = int(meta["bs"])
        nblk = int(meta["nblk"])
        bcrc = list(meta["bcrc"])
        if bs < 1 or nblk < 1 or len(bcrc) != nblk or \
                not (nblk - 1) * bs < n <= nblk * bs:
            raise KvSegmentError(
                f"KV segment block meta incoherent: n={n} bs={bs} "
                f"nblk={nblk} crcs={len(bcrc)}"
            )
        if frame_size * nblk != len(data):
            raise KvSegmentError(
                f"KV segment size mismatch: {nblk} blocks of {frame_size} "
                f"bytes promised, have {len(data)}"
            )
        view = memoryview(data)
        for b in range(nblk):
            if zlib.crc32(view[b * frame_size:(b + 1) * frame_size]) != \
                    int(bcrc[b]):
                raise KvSegmentError(
                    f"KV segment block {b}/{nblk} CRC mismatch (torn block)"
                )
    else:
        # Monolithic: one frame holding whole arrays.
        nblk = 1
        if frame_size != len(data):
            raise KvSegmentError(
                f"KV segment size mismatch: meta promises {frame_size} "
                f"bytes, have {len(data)}"
            )
    # Read-only: every array below is a copy of its columns.
    frames = np.frombuffer(data, np.uint8).reshape(nblk, frame_size)
    layers = []
    off = 0
    try:
        for _ in range(n_layers):
            lay = {}
            for kk in keys:
                shape, dt = shapes[kk]
                # Column ``off`` of every frame: [nblk, *shape], joined
                # along the slot axis (axis 2).
                t = torch.from_numpy(
                    frames[:, off:off + sizes[kk]].copy()).view(
                    torch_dtype(dt)).view([nblk] + list(shape))
                off += sizes[kk]
                if blocks:
                    t = t.movedim(0, 2)
                    t = t.reshape(tuple(t.shape[:2]) + (nblk * t.shape[3],)
                                  + tuple(t.shape[4:]))[:, :, :n]
                else:
                    t = t[0]
                lay[kk] = t
            layers.append(lay)
    except (TypeError, ValueError, RuntimeError, IndexError) as e:
        raise KvSegmentError(f"KV segment arrays incoherent: {e}") from None
    seg = {"layers": layers, "n": n, "first": first, "quant": quant}
    if blocks:
        seg.update(block_size=bs, blocks=nblk)
    return seg


# -- paged KV ----------------------------------------------------------------
#
# The pool holds fixed-size blocks; a per-slot block table maps logical
# block i of slot s to a physical block.  The decode step gathers
# ``pool[table]`` into the same dense [B, KV, max_len, D] view the slotted
# step computes on, runs the same attention program, and scatters the view
# back through the table, so greedy output is byte-identical to the slotted
# server's.  Stale bytes in block slots not yet written are invisible: the
# causal mask sends every position past the query to -1e30 before the
# softmax, an exact 0.0 weight on both the score*ks and p*vs paths.
#
# Duplicate indices.  A table holds the scratch block (row ``n_blocks``) at
# every unassigned entry, and (with prefix sharing) a block shared by
# several slots, so the scatter writes some pool rows more than once.
# JAX's ``.at[].set`` keeps any one of the writes; torch's ``index_put_``
# without ``accumulate`` leaves the winner undefined as well (on the card
# each element is written by one of the competing threads).  Neither
# matters: a shared block only ever receives the values it already holds
# (a slot writes at or past its first owned position, so the shared
# prefix is written back unchanged), and the scratch block is read only at
# positions the causal mask hides, where any finite value gives weight 0.


def _paged_block_split(x: torch.Tensor, n_blocks: int,
                       block_size: int) -> torch.Tensor:
    """[KV, L(, D)] -> [n_blocks, KV, block_size(, D)] (L >= nb*bs)."""
    x = x[:, : n_blocks * block_size]
    x = x.reshape((x.shape[0], n_blocks, block_size) + tuple(x.shape[2:]))
    return x.movedim(0, 1)


def _paged_dense_view(pool_layers: List[Dict],
                      table: torch.Tensor) -> List[Dict]:
    """Gather the per-slot dense cache view through the block table:
    pool [NB+1, KV, BS, ...] + table [B, MB] -> [B, KV, MB*BS, ...] (a
    copy)."""
    out = []
    for pl in pool_layers:
        lay = {}
        for kk, arr in pl.items():
            g = arr[table].movedim(2, 1)        # [B, KV, MB, BS, ...]
            lay[kk] = g.reshape(
                tuple(g.shape[:2]) + (g.shape[2] * g.shape[3],)
                + tuple(g.shape[4:])
            )
        out.append(lay)
    return out


def _paged_scatter_back(pool_layers: List[Dict], dense_layers: List[Dict],
                        table: torch.Tensor) -> List[Dict]:
    """Inverse of :func:`_paged_dense_view`: write the dense view back
    through the table, into the pool in place (see the note above on
    repeated entries).  Returns ``pool_layers``."""
    MB = table.shape[1]
    for pl, dl in zip(pool_layers, dense_layers):
        for kk, arr in pl.items():
            d = dl[kk]                          # [B, KV, MB*BS, ...]
            d = d.reshape(
                tuple(d.shape[:2]) + (MB, d.shape[2] // MB)
                + tuple(d.shape[3:])
            ).movedim(1, 2)                     # [B, MB, KV, BS, ...]
            arr[table] = d
    return pool_layers


def _paged_row_view(pool_layers: List[Dict],
                    table_s: torch.Tensor) -> List[Dict]:
    """One slot's dense [1, KV, MB*BS, ...] view (table_s: [MB]), a copy."""
    out = []
    for pl in pool_layers:
        lay = {}
        for kk, arr in pl.items():
            g = arr[table_s].movedim(0, 1)      # [KV, MB, BS, ...]
            lay[kk] = g.reshape(
                (g.shape[0], g.shape[1] * g.shape[2]) + tuple(g.shape[3:])
            )[None]
        out.append(lay)
    return out


def _paged_row_scatter(pool_layers: List[Dict], dense_layers: List[Dict],
                       table_s: torch.Tensor) -> List[Dict]:
    """Write one slot's dense [1, KV, MB*BS, ...] rows back through its
    table row, into the pool in place (the same duplicate-index argument
    as the batch scatter).  Returns ``pool_layers``."""
    MB = table_s.shape[0]
    for pl, dl in zip(pool_layers, dense_layers):
        for kk, arr in pl.items():
            d = dl[kk][0]                       # [KV, MB*BS, ...]
            arr[table_s] = _paged_block_split(d, MB, d.shape[1] // MB)
    return pool_layers


def init_paged_pool(cfg: LlamaConfig, n_blocks: int, block_size: int, *,
                    quant_kv: bool = False,
                    device: DeviceLike = None) -> Dict:
    """Zeroed paged KV pool: per-layer [n_blocks + 1, KV, block_size, D]
    arrays (+ absmax scales under ``quant_kv``), one block-id space shared
    by every layer.  Row ``n_blocks`` is the scratch block: never
    allocated; unassigned table entries point here so stray writes land
    somewhere harmless."""
    dev = resolve_device(device)
    lead = (n_blocks + 1, cfg.n_kv_head, block_size)
    return {"layers": [_kv_arrays(cfg, lead, dev, quant_kv)
                       for _ in range(cfg.n_layer)]}


class PagedKvArena:
    """Host-side allocator for the paged KV pool: the free list, the
    per-slot block table, and the per-block refcounts that make
    copy-on-write prefix sharing safe.  Pure bookkeeping; the serve loop
    uploads ``table`` before each dispatch.

    Conservation law: every block is either on the free list or
    referenced (by a slot table or a held template):
    ``free_blocks + used_blocks == n_blocks``, where ``used_blocks``
    counts each physical block once however many tables share it.
    :meth:`scavenge`, run every serve-loop turn, rebuilds the free list
    from the refcounts.  (The reference's fault-injection site in
    ``_drop_ref``, ``serving.block_leak``, is not ported.)"""

    def __init__(self, n_blocks: int, block_size: int, slots: int,
                 max_len: int):
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size} (the gathered dense view must match the "
                "slotted cache shape exactly for byte-identity)"
            )
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        self.slots = int(slots)
        self.max_blocks = max_len // block_size
        #: Scratch sentinel: one past the last allocatable block (the
        #: pool arrays carry an extra physical row for it).
        self.scratch = self.n_blocks
        self.leaks_repaired = 0
        self.reset()

    def reset(self) -> None:
        self.table = np.full(
            (self.slots, self.max_blocks), self.scratch, np.int32
        )
        self.lens = np.zeros((self.slots,), np.int64)
        self.ref = np.zeros((self.n_blocks,), np.int64)
        self._free = list(range(self.n_blocks - 1, -1, -1))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        """Physical blocks referenced at least once (a shared block counts
        once)."""
        return int((self.ref > 0).sum())

    def table_tokens(self) -> int:
        """Logical tokens of table capacity mapped now (the sum of the
        table lengths in blocks, times ``block_size``)."""
        return int(self.lens.sum()) * self.block_size

    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_size)

    def conserved(self) -> bool:
        """``free_blocks + used_blocks == n_blocks`` and the free list
        agrees with the refcounts."""
        return (
            len(self._free) + self.used_blocks == self.n_blocks
            and all(self.ref[b] == 0 for b in self._free)
        )

    def scavenge(self) -> int:
        """Rebuild the free list from the refcounts, reclaiming any block
        whose free was dropped.  Returns the number of leaked blocks
        repaired."""
        free = [b for b in range(self.n_blocks) if self.ref[b] == 0]
        leaked = len(free) - len(self._free)
        if leaked > 0:
            self.leaks_repaired += leaked
        self._free = free
        return max(0, leaked)

    def _take(self) -> int:
        blk = self._free.pop()
        self.ref[blk] = 1
        return blk

    def alloc_upto(self, s: int, tokens: int) -> bool:
        """Grow slot ``s``'s table to cover ``tokens`` logical positions
        (grow on demand: a request holds only the blocks its current
        offset and this round's writes need).  False, with no change, when
        the pool cannot cover it."""
        need = min(self.blocks_for(tokens), self.max_blocks)
        add = need - int(self.lens[s])
        if add <= 0:
            return True
        if add > len(self._free):
            return False
        for _ in range(add):
            self.table[s, self.lens[s]] = self._take()
            self.lens[s] += 1
        return True

    def share(self, s: int, blocks: list) -> None:
        """Map slot ``s``'s first logical blocks onto ``blocks`` (prefix
        sharing: refcount up, no copy).  Only on an empty slot row."""
        assert self.lens[s] == 0
        for i, b in enumerate(blocks):
            self.table[s, i] = b
            self.ref[b] += 1
        self.lens[s] = len(blocks)

    def hold(self, n: int) -> Optional[list]:
        """Allocate ``n`` blocks owned by a prefix template (the refcount
        is held by the store, not a slot).  None if the pool is too
        tight."""
        if n > len(self._free):
            return None
        return [self._take() for _ in range(n)]

    def release(self, blocks: list) -> None:
        """Drop a template's hold on ``blocks``."""
        for b in blocks:
            self._drop_ref(int(b))

    def _drop_ref(self, blk: int) -> None:
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            self._free.append(blk)

    def free_slot(self, s: int) -> None:
        """Return slot ``s``'s blocks (abort, finish, preemption):
        refcount down, back on the free list at zero; shared blocks
        survive for their other holders."""
        for i in range(int(self.lens[s])):
            self._drop_ref(int(self.table[s, i]))
        self.table[s, :] = self.scratch
        self.lens[s] = 0


class DecodeServer:
    """Continuous-batching greedy/sampled decode over fixed slots: new
    prompts are admitted into slots as sequences finish, so a stream of
    requests keeps every slot busy.

    One decode dispatch runs over all ``slots`` (ragged per-slot offsets):
    a single-token step, or ``decode_chunk`` steps at once; admission
    scores a new prompt, right-padded to its bucket, into one slot's cache
    rows.  On a CUDA device the dispatch is one CUDA graph replay
    (``models/decode_graph.py``); its inputs (tokens, offsets, the active
    mask and, when paged, the block table) are static device buffers that
    live as long as the server and are zeroed at every ``serve`` call.

        srv = DecodeServer(params, cfg, slots=8, max_len=512, eos_token=2)
        outs = srv.serve(list_of_prompt_arrays, max_new_tokens=128)

    ``quant_kv``: the int8 cache.  ``decode_chunk = K > 1``: K tokens a
    dispatch; a slot that finishes mid-chunk waits out the chunk and its
    up to K - 1 extra writes are covered by the capacity check's headroom.
    ``paged``: the cache is a pool of ``pool_blocks`` blocks of
    ``block_size`` tokens (default: the slotted layout's memory) with a
    block table per slot; admission takes only the blocks a prompt needs,
    slots grow before each dispatch, and when the pool runs dry the
    youngest admission is preempted and re-queued at the front.

    Prefix caching: ``serve(shared_prefix=)`` prefills the prefix once into
    a template and ``submit(prefix_len=)`` keeps one template per prefix
    fingerprint (an LRU of ``prefix_cache_cap``).  A template is a 1-row
    cache of ``max_len`` rows; an admission copies its rows into the slot
    (paged: shares its whole blocks below the first re-scored position and
    copies the rest) and scores only from the first chunk that holds its
    own tokens.  The handoff: ``prefill_request`` prefills one request
    alone and stages its rows, ``export_kv`` packs them
    (:func:`pack_kv_segment`) and another server's ``import_kv`` verifies
    the segment and admits the request from it with no prefill.

    The cache lives on the device of ``params``.  ``draft`` and
    ``spec_remote`` raise ``NotImplementedError``.
    """

    def __init__(
        self,
        params: Dict,
        cfg: LlamaConfig,
        *,
        slots: int = 8,
        max_len: int = 512,
        eos_token: int = -1,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        prompt_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256),
        seed: int = 0,
        quant_kv: bool = False,
        draft: Optional[Tuple[Dict, LlamaConfig]] = None,
        decode_chunk: int = 1,
        spec_remote: bool = False,
        prefix_cache_cap: int = 4,
        paged: bool = False,
        block_size: int = 16,
        pool_blocks: Optional[int] = None,
    ):
        if spec_remote and draft is not None:
            raise ValueError(
                "spec_remote does not compose with a local draft model "
                "(one proposal source per server)"
            )
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got "
                             f"{decode_chunk}")
        if decode_chunk > 1 and (draft is not None or spec_remote):
            raise ValueError(
                "decode_chunk > 1 does not compose with a draft model "
                "(speculative rounds already batch tokens per dispatch); "
                "set one or the other"
            )
        refused = {
            "draft (speculative decoding)": draft is not None,
            "spec_remote=True (remote-draft speculation)": spec_remote,
        }
        for what, asked in refused.items():
            if asked:
                raise NotImplementedError(
                    f"DecodeServer {what} comes with {SERVING_SLICE}"
                )
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.slots = slots
        self.max_len = max_len
        self.eos_token = eos_token
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.quant_kv = bool(quant_kv)
        self.decode_chunk = int(decode_chunk)
        self.buckets = tuple(
            b for b in sorted(prompt_buckets) if b <= max_len
        )
        self.paged = bool(paged)
        self.block_size = int(block_size)
        if self.paged:
            if block_size < 1:
                raise ValueError(f"block_size must be >= 1, got "
                                 f"{block_size}")
            if max_len % self.block_size:
                raise ValueError(
                    f"paged mode needs max_len ({max_len}) to be a "
                    f"multiple of block_size ({block_size}): the gathered "
                    "view must match the slotted cache shape exactly for "
                    "byte-identical output"
                )
        self.pool_blocks = (
            int(pool_blocks) if pool_blocks is not None
            else slots * (max_len // self.block_size)
        ) if self.paged else 0
        self.kv_arena: Optional[PagedKvArena] = (
            PagedKvArena(self.pool_blocks, self.block_size, slots, max_len)
            if self.paged else None
        )
        #: Preemptions in the last serve call.
        self.preemptions = 0
        #: rid -> tokens already delivered through on_token before a
        #: preemption (re-admission mutes that many).
        self._preempt_emitted: Dict[Any, int] = {}
        # Prefix templates: fp -> {"prefix", "p0", "layers"} in LRU order
        # (mutated under _pending_mu); hits and misses count lookups.
        self.prefix_cache_cap = max(1, int(prefix_cache_cap))
        self._prefix_store: "collections.OrderedDict" = \
            collections.OrderedDict()
        self.prefix_hits = 0
        self.prefix_misses = 0
        #: Forward calls spent prefilling templates, and by
        #: ``prefill_request``, over the server's life.
        self.template_forwards = 0
        self.prefill_forwards = 0
        #: Serve-call counter: a paged template's pool blocks belong to
        #: one run (the pool is zeroed at every serve call).
        self._paged_run_seq = 0
        # rid -> the prefilled rows staged for export_kv (CPU tensors).
        self._kv_exports: Dict[Any, Dict[str, Any]] = {}
        self._pick = _make_sampler(temperature, top_k, top_p)
        # One sampling stream for every prefill and step, on the device.
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        #: Telemetry of the last serve call (refreshed every loop turn).
        self.last_stats: Dict[str, Any] = {}
        # Incremental admission: ``submit`` enqueues (rid, prompt,
        # max_new_tokens); the serve loop admits as slots free.  The
        # lock makes submit/cancel/abort safe from another thread.
        self._pending: "collections.deque" = collections.deque()
        self._pending_mu = threading.Lock()
        self._abort_rids: set = set()
        # Live views for active_rids/free_slots while a loop runs.
        self._live_active: Optional[np.ndarray] = None
        self._live_slot_req: Optional[list] = None
        # Device state, made at the first serve call and kept for the
        # server's life (a captured graph holds these addresses).
        self._kv: Optional[List[Dict]] = None
        self.decode_graph: Optional[DecodeGraph] = None

    # -- device state and the decode dispatch --------------------------------

    def _ensure_state(self) -> bool:
        """Make the cache (or pool), the dispatch's static buffers and its
        :class:`DecodeGraph` on first use, and capture the graph on a CUDA
        device (before any admission: the warm-up run writes only at
        offset 0 of idle rows, or the scratch block); then zero every
        buffer.  Returns whether this call captured."""
        B, K, dev = self.slots, self.decode_chunk, self.device
        captured = False
        if self._kv is None:
            if self.paged:
                self._kv = init_paged_pool(
                    self.cfg, self.pool_blocks, self.block_size,
                    quant_kv=self.quant_kv, device=dev,
                )["layers"]
                self._table = torch.full(
                    (B, self.kv_arena.max_blocks), self.kv_arena.scratch,
                    dtype=torch.long, device=dev,
                )
            else:
                self._kv = init_cache(
                    self.cfg, B, self.max_len, device=dev,
                    quant_kv=self.quant_kv, ring=False,
                )["layers"]
            self._off = torch.zeros(B, dtype=torch.long, device=dev)
            self._toks = torch.zeros(B, dtype=torch.long, device=dev)
            self._act = torch.zeros(B, dtype=torch.bool, device=dev)
            self._out = torch.zeros((B, K), dtype=torch.long, device=dev)
            self._logits = torch.zeros((B, self.cfg.vocab_size),
                                       dtype=torch.float32, device=dev)
            self.decode_graph = DecodeGraph(
                self._dispatch, dev,
                generator=self._gen if self.temperature > 0.0 else None,
                counted=(_rmsnorm_mod.rmsnorm,),
            )
        if dev.type == "cuda" and not self.decode_graph.captured:
            self.decode_graph.capture()
            captured = True
        for lay in self._kv:
            for t in lay.values():
                t.zero_()
        for t in (self._off, self._toks, self._act):
            t.zero_()
        if self.paged:
            self._table.fill_(self.kv_arena.scratch)
        return captured

    def _dispatch(self) -> None:
        """The decode dispatch over every slot, on the static buffers: K =
        ``decode_chunk`` single-token steps (inactive slots keep their
        offset; their rows are rewritten at the same slot and stay unread),
        through the gathered dense view when paged.  Writes the new
        offsets and tokens back, each step's tokens into ``_out`` [B, K]
        and the last step's logits into ``_logits``."""
        if self.paged:
            layers = _paged_dense_view(self._kv, self._table)
        else:
            layers = self._kv
        off, toks = self._off, self._toks
        outs = []
        for _ in range(self.decode_chunk):
            logits, new = forward_step(
                self.params, toks[:, None], self.cfg,
                {"layers": layers, "offset": off},
            )
            last = logits[:, -1, :]
            toks = self._pick(last, self._gen)
            off = torch.where(self._act, new["offset"], off)
            outs.append(toks)
        if self.paged:
            _paged_scatter_back(self._kv, layers, self._table)
        self._logits.copy_(last)
        self._off.copy_(off)
        self._toks.copy_(toks)
        self._out.copy_(torch.stack(outs, 1))

    def _decode_round(self, active: np.ndarray,
                      table: Optional[np.ndarray] = None) -> np.ndarray:
        """Refresh the active mask (and the block table, when given), run
        the dispatch (a graph replay on the card) and return its tokens
        [B, K] on the host."""
        self._act.copy_(torch.from_numpy(active))
        if table is not None:
            self._table.copy_(torch.from_numpy(table))
        self.decode_graph()
        return self._out.cpu().numpy()

    # -- admission surface -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prompt of {n} tokens exceeds largest bucket "
            f"{self.buckets[-1]}"
        )

    def block_stats(self) -> Optional[Dict[str, Any]]:
        """Live block-pool telemetry (None on a slotted server)."""
        arena = self.kv_arena
        if arena is None:
            return None
        return {
            "total_blocks": arena.n_blocks,
            "free_blocks": arena.free_blocks,
            "block_occupancy": arena.used_blocks / max(1, arena.n_blocks),
            "preemptions": self.preemptions,
        }

    def pop_request_stats(self, rid) -> Optional[Dict[str, Any]]:
        """Per-request speculation telemetry; no path here speculates, so
        this is always None."""
        return None

    def _write_slack(self) -> int:
        """Cache-write headroom past the emission budget: a chunk writes up
        to ``decode_chunk - 1`` slots past a mid-chunk finish."""
        return self.decode_chunk - 1

    def check_capacity(self, prompt_len: int, max_new_tokens: int,
                       prefix_len: int = 0) -> None:
        """Raise ValueError if a request of this shape (after a shared
        prefix of ``prefix_len``) could write past ``max_len`` (a torch
        index out of range raises, or trips a device-side assert on CUDA,
        where JAX would drop the write), or, when paged, needs more blocks
        than the whole pool holds."""
        need = prefix_len + prompt_len + max_new_tokens + \
            self._write_slack()
        if need > self.max_len:
            raise ValueError(
                (f"prefix {prefix_len} + " if prefix_len else "")
                + f"prompt {prompt_len} + max_new_tokens {max_new_tokens} "
                f"+ headroom {self._write_slack()} = {need} exceeds "
                f"max_len {self.max_len}"
            )
        if self.paged:
            blocks = self.kv_arena.blocks_for(need)
            if blocks > self.pool_blocks:
                raise ValueError(
                    f"request needs {blocks} KV blocks ({need} tokens at "
                    f"block_size {self.block_size}) but the pool holds "
                    f"only {self.pool_blocks}"
                )

    def _as_prompt(self, prompt) -> np.ndarray:
        p = np.asarray(prompt, np.int32)
        if p.ndim != 1 or p.size == 0:
            raise ValueError(
                f"a prompt is a non-empty 1-D token array, got shape "
                f"{p.shape}"
            )
        if p.min() < 0 or p.max() >= self.cfg.vocab_size:
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
            )
        return p

    def _prefix_of(self, p: np.ndarray, prefix_len: int) -> int:
        p0 = int(prefix_len)
        if not 0 < p0 < len(p):
            raise ValueError(
                f"prefix_len {prefix_len} out of range for a {len(p)}-token "
                "prompt"
            )
        return p0

    def submit(self, rid, prompt, max_new_tokens: int,
               prefix_len: int = 0, prefix_fp: str = "") -> None:
        """Enqueue one request for incremental admission (any hashable
        ``rid``); the running ``serve_incremental`` loop admits it when a
        slot frees.  Raises ValueError at once if it can never fit.

        ``prefix_len > 0`` declares ``prompt[:prefix_len]`` a shared
        template, keyed by ``prefix_fp`` (default: its
        :func:`prefix_fingerprint`): a warm template admits with a row
        copy and the scoring of the request's own chunk, a cold one is
        prefilled once and kept.  Outputs equal the untemplated path's."""
        p = self._as_prompt(prompt)
        self.check_capacity(len(p), max_new_tokens)
        extra = None
        if prefix_len:
            p0 = self._prefix_of(p, prefix_len)
            extra = {"prefix_len": p0,
                     "prefix_fp": prefix_fp or prefix_fingerprint(p[:p0])}
        with self._pending_mu:
            self._pending.append((rid, p, int(max_new_tokens), extra))

    # -- prefix templates and the KV-segment handoff -------------------------

    def warm_prefix_fps(self) -> list:
        """Fingerprints of the templates held now, oldest first (what a
        replica reports so that the gateway routes matching requests
        here)."""
        with self._pending_mu:
            return list(self._prefix_store)

    def clear_prefix_templates(self) -> None:
        """Drop every template and zero the hit and miss counts."""
        with self._pending_mu:
            for entry in self._prefix_store.values():
                self._release_template_blocks(entry)
            self._prefix_store.clear()
            self.prefix_hits = 0
            self.prefix_misses = 0

    @torch.inference_mode()
    def _template_layers(self, prefix: np.ndarray) -> List[Dict]:
        """Prefill ``prefix`` in one forward into a fresh 1-row cache of
        ``max_len`` rows (zeros past the prefix) and return its layers: the
        template build of the batch path and of the store."""
        tc = init_cache(self.cfg, 1, self.max_len, device=self.device,
                        quant_kv=self.quant_kv, ring=False)
        toks = torch.from_numpy(prefix.astype(np.int64)).to(self.device)
        forward_step(self.params, toks[None], self.cfg, tc)
        self.template_forwards += 1
        return tc["layers"]

    def _ensure_prefix_template(self, prefix, fp: str) -> Dict[str, Any]:
        """The store's entry for ``fp``: a hit returns it (most recent in
        the LRU); a miss, or an entry whose prefix differs from
        ``prefix`` (a collision), prefills the template once and keeps it,
        evicting the oldest past ``prefix_cache_cap``."""
        prefix = np.asarray(prefix, np.int32)
        with self._pending_mu:
            entry = self._prefix_store.get(fp)
            if entry is not None and (
                entry["p0"] != len(prefix)
                or not np.array_equal(entry["prefix"], prefix)
            ):
                # Never serve another prefix's rows.
                del self._prefix_store[fp]
                self._release_template_blocks(entry)
                entry = None
            if entry is not None:
                self.prefix_hits += 1
                self._prefix_store.move_to_end(fp)
                return entry
            self.prefix_misses += 1
        # The build runs outside the lock.
        entry = {"prefix": prefix, "p0": len(prefix),
                 "layers": self._template_layers(prefix)}
        with self._pending_mu:
            self._prefix_store[fp] = entry
            while len(self._prefix_store) > self.prefix_cache_cap:
                _, old = self._prefix_store.popitem(last=False)
                self._release_template_blocks(old)
        return entry

    def _release_template_blocks(self, entry: Dict[str, Any]) -> None:
        """Drop the store's hold on an entry's pool blocks (paged, this
        run's only); blocks a slot still shares live on its refcount."""
        pb = entry.pop("_paged", None)
        if pb is not None and self.kv_arena is not None and \
                pb["run"] == self._paged_run_seq:
            self.kv_arena.release(pb["ids"])

    @torch.inference_mode()
    def prefill_request(self, rid, prompt, max_new_tokens: int,
                        prefix_len: int = 0, prefix_fp: str = "") -> int:
        """The prefill role of the handoff: score ``prompt`` into a fresh
        1-row cache (a template when ``prefix_len`` is given and the
        prompt is longer than the largest bucket; bucketed or chunked as
        the server's own admission), pick the first token and stage host
        copies of the written rows for :meth:`export_kv`.  Returns the
        first token."""
        p = self._as_prompt(prompt)
        n = len(p)
        self.check_capacity(n, max_new_tokens)
        C = self.buckets[-1]
        c_start = None
        if prefix_len and n > C:
            p0 = self._prefix_of(p, prefix_len)
            tmpl = self._ensure_prefix_template(
                p[:p0], prefix_fp or prefix_fingerprint(p[:p0]))
            # The template stays as it is: score on a copy.
            layers = [{k: t.clone() for k, t in lay.items()}
                      for lay in tmpl["layers"]]
            c_start = min(C * (p0 // C), n - C)
        else:
            layers = init_cache(self.cfg, 1, self.max_len,
                                device=self.device, quant_kv=self.quant_kv,
                                ring=False)["layers"]
        last, calls = self._score(p, lambda zero: layers, lambda rows: None,
                                  c_start)
        self.prefill_forwards += calls
        first = int(self._pick(last, self._gen)[0])
        self._kv_exports[rid] = {
            "layers": [{k: t[:, :, :n].contiguous().cpu()
                        for k, t in lay.items()} for lay in layers],
            "n": n, "first": first,
        }
        return first

    def export_kv(self, rid) -> Tuple[bytes, int]:
        """``(payload, fp32_bytes)`` of :func:`pack_kv_segment` for the
        rows :meth:`prefill_request` staged for ``rid`` (a paged server
        ships a block list).  The staged entry is consumed."""
        info = self._kv_exports.pop(rid, None)
        if info is None:
            raise ValueError(f"no staged prefill for request {rid!r}")
        return pack_kv_segment(
            info["layers"], info["n"], info["first"], self.quant_kv,
            block_size=self.block_size if self.paged else 0,
        )

    def import_kv(self, rid, payload: bytes, prompt,
                  max_new_tokens: int) -> None:
        """The decode role of the handoff: verify the segment (its CRCs;
        ``n`` against the prompt; quantization, layer count, keys, and
        every array's shape and dtype against this server's own layout,
        never the payload's) and queue the request for admission from its
        rows.  Raises :class:`KvSegmentError` on any mismatch."""
        seg = unpack_kv_segment(payload)
        p = self._as_prompt(prompt)
        n = seg["n"]
        if n != len(p):
            raise KvSegmentError(
                f"KV segment covers {n} tokens but the grant prompt has "
                f"{len(p)}"
            )
        if seg["quant"] != self.quant_kv:
            raise KvSegmentError(
                f"KV segment quant={seg['quant']} but this server has "
                f"quant_kv={self.quant_kv}"
            )
        self.check_capacity(n, max_new_tokens)
        cfg = self.cfg
        if len(seg["layers"]) != cfg.n_layer:
            raise KvSegmentError(
                f"KV segment has {len(seg['layers'])} layers, model has "
                f"{cfg.n_layer}"
            )
        want = _kv_arrays(cfg, (1, cfg.n_kv_head, n), torch.device("meta"),
                          self.quant_kv)
        # Paged admission writes whole blocks: pad to the block boundary.
        tail = (self.kv_arena.blocks_for(n) * self.block_size - n
                if self.paged else 0)
        rows = []
        for lay in seg["layers"]:
            if set(lay) != set(want):
                raise KvSegmentError(
                    f"KV segment keys {sorted(lay)} != {sorted(want)}"
                )
            out = {}
            for kk, arr in lay.items():
                ref = want[kk]
                if arr.shape != ref.shape or arr.dtype != ref.dtype:
                    raise KvSegmentError(
                        f"KV segment {kk}: shape {tuple(arr.shape)} dtype "
                        f"{arr.dtype} != expected {tuple(ref.shape)} "
                        f"{ref.dtype}"
                    )
                if tail:
                    arr = torch.cat([arr, arr.new_zeros(
                        arr.shape[:2] + (tail,) + arr.shape[3:])], dim=2)
                out[kk] = arr
            rows.append(out)
        extra = {"kv": {"layers": rows, "n": n, "first": seg["first"]}}
        with self._pending_mu:
            self._pending.append((rid, p, int(max_new_tokens), extra))

    def cancel(self, rid) -> bool:
        """Drop a not-yet-admitted request.  False when ``rid`` is unknown
        or already decoding."""
        with self._pending_mu:
            for i, item in enumerate(self._pending):
                if item[0] == rid:
                    del self._pending[i]
                    return True
        return False

    def abort(self, rid) -> bool:
        """A pending ``rid`` is dropped now; an active one is freed at the
        loop's next admission point, its partial output discarded (no
        ``on_finish``, no result).  False for an unknown or finished
        ``rid``."""
        if self.cancel(rid):
            return True
        if rid in self.active_rids():
            with self._pending_mu:
                self._abort_rids.add(rid)
            return True
        return False

    def _pop_pending(self):
        with self._pending_mu:
            return self._pending.popleft() if self._pending else None

    def pending_count(self) -> int:
        with self._pending_mu:
            return len(self._pending)

    def pending_rids(self) -> list:
        with self._pending_mu:
            return [item[0] for item in self._pending]

    def active_rids(self) -> list:
        """Request ids decoding in slots (live only while a loop runs)."""
        act, req = self._live_active, self._live_slot_req
        if act is None or req is None:
            return []
        return [req[s] for s in range(self.slots) if act[s]]

    def free_slots(self) -> int:
        """Slots a new admission could use now: total minus decoding minus
        already queued."""
        act = self._live_active
        busy = int(act.sum()) if act is not None else 0
        return max(0, self.slots - busy - self.pending_count())

    def _slot_rows(self, s: int):
        """``(rows_view, commit)`` over slot ``s``'s cache rows:
        ``rows_view(zero)`` gives per-layer ``[1, ...]`` rows (zeroed when
        asked) that a forward writes, and ``commit(rows)`` puts them back.
        Slotted: views of the cache, nothing to put back; paged: a copy
        gathered through the slot's table row (its blocks allocated) and
        scattered back."""
        if self.paged:
            tbl = torch.from_numpy(
                self.kv_arena.table[s].astype(np.int64)
            ).to(self.device)

            def rows_view(zero: bool) -> List[Dict]:
                rows = _paged_row_view(self._kv, tbl)
                if zero:
                    for c in rows:
                        for t in c.values():
                            t.zero_()
                return rows

            def commit(rows: List[Dict]) -> None:
                _paged_row_scatter(self._kv, rows, tbl)

            return rows_view, commit
        slot_rows = [{k: t[s:s + 1] for k, t in c.items()} for c in self._kv]

        def rows_view(zero: bool) -> List[Dict]:
            if zero:
                for c in slot_rows:
                    for t in c.values():
                        t.zero_()
            return slot_rows

        return rows_view, lambda rows: None

    def _score(self, prompt: np.ndarray, rows_view, commit,
               c_start: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """Score ``prompt`` into the rows of ``rows_view`` / ``commit`` (see
        :meth:`_slot_rows`); returns (the last position's logits [1, V],
        forward calls).

        ``c_start`` None: fresh rows.  A prompt that fits a bucket is
        right-padded to it and scored in one pass on zeroed rows (the pad
        keys sit past the prompt and are causally hidden until decode
        overwrites them); a longer one is scored in full chunks of the
        largest bucket, the rows zeroed before the first, the last chunk
        shifted back to end at the prompt's end.  ``c_start`` an int: the
        rows already hold a template's keys below it; the chunks start
        there and zero nothing."""
        n = len(prompt)
        C = self.buckets[-1]
        if c_start is None and n <= C:
            padded = np.zeros((1, self._bucket(n)), np.int64)
            padded[0, :n] = prompt
            rows = rows_view(True)
            logits, _ = forward_step(
                self.params, torch.from_numpy(padded).to(self.device),
                self.cfg, {"layers": rows, "offset": 0},
            )
            commit(rows)
            return logits[:, n - 1, :], 1
        # Every chunk is full; re-scoring the shifted-back positions
        # recomputes the same keys from the same complete prefix.
        calls = 0
        for c0 in range(c_start or 0, n, C):
            start = c0 if c0 + C <= n else n - C
            piece = torch.from_numpy(
                prompt[start:start + C].astype(np.int64)
            ).to(self.device)
            rows = rows_view(c_start is None and start == 0)
            logits, _ = forward_step(
                self.params, piece[None, :], self.cfg,
                {"layers": rows, "offset": start},
            )
            commit(rows)
            calls += 1
            if start + C >= n:
                last = logits[:, (n - 1) - start, :]
        return last, calls

    def _prefill(self, s: int, prompt: np.ndarray,
                 c_start: Optional[int] = None) -> Tuple[torch.Tensor, int]:
        """Score ``prompt`` into slot ``s``'s rows (:meth:`_score`), set the
        slot's offset to its length and pick its first token.  Returns
        (first token, forward calls)."""
        last, calls = self._score(prompt, *self._slot_rows(s), c_start)
        self._off[s] = len(prompt)
        return self._pick(last, self._gen)[0], calls

    def serve(self, prompts, max_new_tokens: int, on_finish=None,
              on_token=None, shared_prefix=None) -> list:
        """Decode every prompt (a list of 1-D int arrays); returns a list of
        1-D int32 arrays (prompt + continuation, EOS included).

        ``on_finish(rid, tokens)`` fires when request ``rid`` (its index)
        completes; ``on_token(rid, token)`` fires for every emitted token,
        the first (sampled at prefill) included.

        ``shared_prefix`` (a 1-D int array): prefix caching for one system
        prompt shared by every request.  The output is exactly
        ``serve([prefix + p for p in prompts])``; when some combined prompt
        is longer than the largest bucket, the prefix is prefilled once
        into a template and each such admission copies its rows (paged:
        shares its blocks) and scores only from the first chunk holding its
        own tokens."""
        prefix = None
        if shared_prefix is not None:
            prefix = np.asarray(shared_prefix, np.int32)
            if prefix.ndim != 1 or prefix.size == 0:
                raise ValueError(
                    "shared_prefix must be a non-empty 1-D token array"
                )
        P0 = 0 if prefix is None else len(prefix)
        items = []
        for rid, prompt in enumerate(prompts):
            try:
                if prefix is None:
                    p = self._as_prompt(prompt)
                else:
                    # The request's own tokens may be empty; the combined
                    # prompt is what is served.
                    p = np.asarray(prompt, np.int32)
                    if p.ndim != 1:
                        raise ValueError(
                            f"a prompt is a 1-D token array, got shape "
                            f"{p.shape}"
                        )
                    self._as_prompt(np.concatenate([prefix, p]))
                self.check_capacity(len(p), max_new_tokens, P0)
            except ValueError as e:
                raise ValueError(f"request {rid}: {e}") from None
            items.append((rid, p, int(max_new_tokens), None))
        with self._pending_mu:
            if self._pending:
                raise RuntimeError(
                    f"serve() cannot run with {len(self._pending)} "
                    "incremental submission(s) queued; drain or cancel "
                    "them first (serve()/serve_incremental are exclusive "
                    "modes)"
                )
        forwards0 = self.template_forwards
        template = None
        if prefix is not None and any(P0 + len(it[1]) > self.buckets[-1]
                                      for it in items):
            # (When every combined prompt fits one bucket, each admission
            # prefills from scratch and a template would go unused.)
            template = self._template_layers(prefix)
        with self._pending_mu:
            self._pending.extend(items)
        results = self._run(on_finish=on_finish, on_token=on_token,
                            prefix=prefix, template=template,
                            template_forwards0=forwards0)
        return [results[i] for i in range(len(items))]

    def serve_incremental(self, tick=None, on_finish=None, on_token=None,
                          idle_wait: float = 0.002) -> dict:
        """Serve requests fed in by :meth:`submit` and :meth:`import_kv`.
        ``tick()`` runs once per loop turn (the admission point); returning
        ``False`` drains the loop: admitted and already submitted requests
        finish, then the call returns.  Completions are delivered through
        ``on_finish`` only; returns {}."""
        return self._run(on_finish=on_finish, on_token=on_token,
                         tick=tick, idle_wait=idle_wait)

    @torch.inference_mode()
    def _run(self, on_finish=None, on_token=None, tick=None,
             idle_wait: float = 0.002, prefix: Optional[np.ndarray] = None,
             template: Optional[List[Dict]] = None,
             template_forwards0: Optional[int] = None) -> dict:
        """The decode loop of :meth:`serve` (the queue is filled up front
        and runs to drain) and :meth:`serve_incremental` (``tick`` feeds
        it).  Every request carries its own max_new_tokens budget.  Queue
        items are ``(rid, prompt, max_new_tokens, extra)``: ``extra`` is
        None, a prefix declaration (``prefix_len``, ``prefix_fp``) or a
        verified KV segment (``kv``).  ``prefix`` (with the batch path's
        ``template`` layers, if it built one) goes before every prompt."""
        self.last_stats = {}
        B, K = self.slots, self.decode_chunk
        C = self.buckets[-1]
        arena = self.kv_arena
        if template_forwards0 is None:
            template_forwards0 = self.template_forwards
        captured = self._ensure_state()
        replays0 = self.decode_graph.replays
        if self.paged:
            arena.reset()
            # The pool was just zeroed: a template's blocks of an earlier
            # run are gone.
            self._paged_run_seq += 1
            self.preemptions = 0
        P0 = 0 if prefix is None else len(prefix)
        off = np.zeros(B, np.int64)  # host copy of the slots' offsets
        active = np.zeros(B, bool)
        slot_req: list = [None] * B
        slot_prompt: list = [None] * B
        slot_out: list = [None] * B
        slot_item: list = [None] * B
        budget = [0] * B
        # Paged bookkeeping: admission order (preemption sheds the
        # youngest) and per-slot counts of already-delivered tokens to
        # mute after a preempted request re-admits.
        admit_seq = [0] * B
        slot_mute = [0] * B
        results: Dict[Any, np.ndarray] = {}
        counts = {"rounds": 0, "emitted": 0, "prefills": 0, "forwards": 0,
                  "admits": 0, "peak_blocks": 0, "templated": 0,
                  "imported": 0, "shared_blocks": 0}
        # The batch template's pool blocks (paged), as a store entry holds
        # its own.
        batch_memo: Dict[str, Any] = {}

        def free(s):
            if self.paged:
                arena.free_slot(s)
            active[s] = False
            slot_req[s] = slot_prompt[s] = slot_out[s] = None

        def finish(s):
            rid = slot_req[s]
            out = np.concatenate(
                [slot_prompt[s], np.asarray(slot_out[s], np.int32)]
            )
            if tick is None:
                # Batch mode returns the results; the incremental loop
                # delivers through on_finish only (a long-lived replica
                # would otherwise retain every completion).
                results[rid] = out
            free(s)
            if on_finish is not None:
                on_finish(rid, out)

        def preempt(victim):
            """Shed a slot when the pool runs dry: its blocks return at
            once and its request re-queues at the front; greedy decode
            regenerates the same stream, and the tokens already delivered
            are muted on re-admission."""
            rid = slot_req[victim]
            self.preemptions += 1
            self._preempt_emitted[rid] = len(slot_out[victim])
            with self._pending_mu:
                self._pending.appendleft(slot_item[victim])
            free(victim)

        def ensure_round_blocks(round_need: int) -> None:
            """Grow every active slot to cover this round's writes (the
            chunk's overshoot included), oldest admission first; when the
            pool cannot cover one, preempt the youngest until the rest
            fit."""
            order = sorted((s for s in range(B) if active[s]),
                           key=lambda s: admit_seq[s])
            for s in order:
                while active[s] and not arena.alloc_upto(
                        s, int(off[s]) + round_need):
                    if arena.scavenge():
                        continue
                    victim = max((v for v in range(B) if active[v]),
                                 key=lambda v: admit_seq[v])
                    preempt(victim)

        def write_blocks(rows_layers: List[Dict], ids: list) -> None:
            """The first ``len(ids)`` blocks of dense ``[1, KV, >= n*BS,
            ...]`` rows into pool blocks ``ids``, in place (template
            materialization and segment import)."""
            idx = torch.tensor(ids, dtype=torch.long, device=self.device)
            for pl, rl in zip(self._kv, rows_layers):
                for kk, arr in pl.items():
                    blocks = _paged_block_split(
                        rl[kk][0].to(self.device), len(ids), self.block_size)
                    arr.index_copy_(0, idx, blocks.to(arr.dtype))

        def paged_template_ids(tmpl_layers, p0, store_entry):
            """A template's pool blocks, written once a run from its dense
            layers and held (a refcount of the store) until it is evicted
            or the run ends.  None when the pool is too tight: the caller
            admits untemplated."""
            memo = store_entry if store_entry is not None else batch_memo
            pb = memo.get("_paged")
            if pb is not None and pb["run"] == self._paged_run_seq:
                return pb["ids"]
            ids = arena.hold(arena.blocks_for(p0))
            if ids is None:
                return None
            write_blocks(tmpl_layers, ids)
            memo["_paged"] = {"run": self._paged_run_seq, "ids": ids}
            return ids

        def drop_template_holds():
            """Release every template's blocks: the last resort when even
            an untemplated admission does not fit an empty batch
            (``check_capacity`` guarantees it fits the bare pool)."""
            with self._pending_mu:
                memos = [batch_memo] + list(self._prefix_store.values())
            for memo in memos:
                pb = memo.pop("_paged", None)
                if pb is not None and pb["run"] == self._paged_run_seq:
                    arena.release(pb["ids"])

        def paged_admit_need(item, bare=False) -> int:
            """Blocks this admission takes from the pool now; ``bare``
            prices it without its template."""
            _, prompt_, _, extra_ = item
            extra_ = extra_ or {}
            if "kv" in extra_:
                return arena.blocks_for(extra_["kv"]["n"])
            n = len(prompt_) + P0
            need = arena.blocks_for(n)
            if bare:
                return need
            p0, entry = 0, None
            if prefix is not None and n > C and template is not None:
                p0, entry = P0, batch_memo
            elif extra_.get("prefix_len") and len(prompt_) > C:
                p0 = int(extra_["prefix_len"])
                with self._pending_mu:
                    entry = self._prefix_store.get(
                        extra_.get("prefix_fp") or "")
            if p0:
                w0 = min(C * (p0 // C), n - C)
                if w0 > 0:
                    pb = (entry or {}).get("_paged")
                    if pb and pb["run"] == self._paged_run_seq:
                        # Warm: the shared blocks come free.
                        need -= w0 // self.block_size
                    else:
                        # Cold: writing the template takes its blocks too.
                        need += arena.blocks_for(p0)
            return max(0, need)

        def admit_paged(s, prompt, tmpl, p0, store_entry):
            """Share the template's whole blocks below the first re-scored
            position ``w0`` (refcount up, no copy), copy its blocks in
            ``[w0, p0)`` (they are about to be rewritten: copy on the first
            divergent write), allocate the rest the prompt needs, and
            score from ``w0``.  Returns (first token, forward calls,
            whether the template was used: not when ``w0 <= 0`` or the
            pool could not hold its blocks)."""
            n = len(prompt)
            BSZ = self.block_size
            ids, w0 = None, 0
            if tmpl is not None and p0:
                w0 = min(C * (p0 // C), n - C)
                if w0 > 0:
                    ids = paged_template_ids(tmpl, p0, store_entry)
            copy_src: list = []
            if ids is not None:
                share_n = w0 // BSZ
                arena.share(s, ids[:share_n])
                copy_src = ids[share_n:arena.blocks_for(p0)]
                counts["shared_blocks"] += share_n
            if not arena.alloc_upto(s, n):
                raise RuntimeError(
                    "paged admission allocation failed after the "
                    "free-block gate: arena accounting bug"
                )
            if copy_src:
                dst = arena.table[s, share_n:share_n + len(copy_src)]
                src_t = torch.tensor(copy_src, dtype=torch.long,
                                     device=self.device)
                dst_t = torch.from_numpy(dst.astype(np.int64)).to(
                    self.device)
                for lay in self._kv:
                    for arr in lay.values():
                        arr.index_copy_(0, dst_t, arr[src_t])
            first, calls = self._prefill(s, prompt,
                                         w0 if ids is not None else None)
            return first, calls, ids is not None

        def admit_slotted(s, prompt, tmpl, p0):
            """Copy the template's rows into the slot (zeros past the
            prefix included, which zeroes the slot) and score from the
            first chunk holding the request's own tokens.  Returns (first
            token, forward calls, whether the template saved a chunk: not
            when that first chunk is chunk 0)."""
            if tmpl is None:
                return (*self._prefill(s, prompt), False)
            for lay, tl in zip(self._kv, tmpl):
                for kk, t in lay.items():
                    t[s:s + 1].copy_(tl[kk])
            w0 = min(C * (p0 // C), len(prompt) - C)
            return (*self._prefill(s, prompt, w0), w0 > 0)

        def seat(s, item, prompt, first):
            """The slot goes live on ``prompt`` with its first token
            (sampled at prefill or shipped with a segment), which is
            emitted; EOS or a budget of one finishes it at once."""
            rid, mnt = item[0], item[2]
            slot_item[s] = item
            off[s] = len(prompt)
            self._toks[s] = first
            first = int(first)
            counts["admits"] += 1
            active[s] = True
            slot_req[s] = rid
            slot_prompt[s] = prompt
            slot_out[s] = [first]
            budget[s] = mnt - 1
            admit_seq[s] = counts["admits"]
            slot_mute[s] = self._preempt_emitted.pop(rid, 0)
            if slot_mute[s] > 0:
                slot_mute[s] -= 1
            elif on_token is not None:
                on_token(rid, first)
            if first == self.eos_token or budget[s] <= 0:
                finish(s)

        def admit_imported(s, item, kv):
            """Admission from a verified segment: its rows go straight into
            the slot (paged: exactly the blocks it covers), no prefill."""
            n = kv["n"]
            if self.paged:
                if not arena.alloc_upto(s, n):
                    raise RuntimeError(
                        "paged import allocation failed after the "
                        "free-block gate: arena accounting bug"
                    )
                ids = arena.table[s, :arena.blocks_for(n)]
                write_blocks(kv["layers"], [int(b) for b in ids])
            else:
                for lay, rows in zip(self._kv, kv["layers"]):
                    for kk, t in lay.items():
                        t[s, :, :n].copy_(rows[kk][0])
                        t[s, :, n:].zero_()
            self._off[s] = n
            counts["imported"] += 1
            seat(s, item, item[1], kv["first"])

        def admit(s, item, no_template=False):
            rid, prompt, mnt, extra = item
            extra = extra or {}
            if "kv" in extra:
                admit_imported(s, item, extra["kv"])
                return
            tmpl, p0, entry = None, 0, None
            if prefix is not None:
                # The output is serve([prefix + p]); a combined prompt that
                # fits one bucket prefills from scratch.
                prompt = np.concatenate([prefix, prompt])
                if len(prompt) > C and template is not None:
                    tmpl, p0 = template, P0
            elif extra.get("prefix_len") and len(prompt) > C:
                p0 = int(extra["prefix_len"])
                entry = self._ensure_prefix_template(
                    prompt[:p0],
                    extra.get("prefix_fp") or prefix_fingerprint(prompt[:p0]),
                )
                tmpl = entry["layers"]
            if no_template:
                tmpl = None
            if self.paged:
                first, calls, used = admit_paged(s, prompt, tmpl, p0, entry)
            else:
                first, calls, used = admit_slotted(s, prompt, tmpl, p0)
            counts["prefills"] += 1
            counts["forwards"] += calls
            counts["templated"] += used
            seat(s, item, prompt, first)

        def emit_rows(rows):
            """Append each active slot's new tokens until its EOS or budget,
            then finish the slot; its remaining tokens in the row are
            discarded.  Returns tokens appended."""
            appended = 0
            for s in range(B):
                if not active[s]:
                    continue
                for t in rows[s]:
                    t = int(t)
                    slot_out[s].append(t)
                    appended += 1
                    budget[s] -= 1
                    if slot_mute[s] > 0:
                        slot_mute[s] -= 1
                    elif on_token is not None:
                        on_token(slot_req[s], t)
                    if t == self.eos_token or budget[s] <= 0:
                        finish(s)
                        break
            return appended

        def publish_stats():
            rounds, emitted = counts["rounds"], counts["emitted"]
            self.last_stats = {
                "path": "decode_chunk" if K > 1 else "plain",
                "rounds": rounds,
                "emitted_tokens": emitted,
                "tokens_per_round": emitted / rounds if rounds else 0.0,
                "occupancy": float(active.sum()) / max(1, B),
                "prefills": counts["prefills"],
                "forwards": counts["forwards"],
                "graph_replays": self.decode_graph.replays - replays0,
                "graph_warmup_forwards": K if captured else 0,
                "templated": counts["templated"],
                "imported": counts["imported"],
                "template_forwards": (self.template_forwards
                                      - template_forwards0),
            }
            if self.paged:
                used = arena.used_blocks
                self.last_stats.update(
                    paged=True,
                    total_blocks=arena.n_blocks,
                    free_blocks=arena.free_blocks,
                    block_occupancy=used / max(1, arena.n_blocks),
                    occupancy=used / max(1, arena.n_blocks),
                    peak_blocks=counts["peak_blocks"],
                    shared_blocks=counts["shared_blocks"],
                    preemptions=self.preemptions,
                    leaks_repaired=arena.leaks_repaired,
                )

        self._live_active = active
        self._live_slot_req = slot_req
        try:
            while True:
                publish_stats()
                keep = True
                if tick is not None:
                    keep = tick() is not False
                if self._abort_rids:
                    with self._pending_mu:
                        doomed, self._abort_rids = self._abort_rids, set()
                    for s in range(B):
                        if active[s] and slot_req[s] in doomed:
                            free(s)
                if self.paged:
                    arena.scavenge()
                for s in range(B):
                    if not active[s]:
                        item = self._pop_pending()
                        if item is None:
                            break
                        no_template = False
                        if self.paged and \
                                arena.free_blocks < paged_admit_need(item):
                            if active.any():
                                # The blocks it needs now are not free:
                                # wait for decode to release some.
                                with self._pending_mu:
                                    self._pending.appendleft(item)
                                break
                            # An empty batch must admit: without the
                            # template, and if still tight, without any
                            # template's held blocks.
                            no_template = True
                            if arena.free_blocks < paged_admit_need(
                                    item, bare=True):
                                drop_template_holds()
                        admit(s, item, no_template)
                if not active.any():
                    if self.pending_count() == 0:
                        if tick is None or not keep:
                            break
                        time.sleep(idle_wait)
                    continue
                table = None
                if self.paged:
                    ensure_round_blocks(K)
                    if not active.any():
                        continue
                    table = arena.table
                    counts["peak_blocks"] = max(counts["peak_blocks"],
                                                arena.used_blocks)
                rows = self._decode_round(active, table)
                off[active] += K
                counts["rounds"] += 1
                counts["forwards"] += K
                counts["emitted"] += emit_rows(rows)
        finally:
            self._live_active = None
            self._live_slot_req = None
        publish_stats()
        return results


def serve_journaled(*args, **kwargs):
    """Crash-safe batch serving over a request journal."""
    raise NotImplementedError(
        f"serve_journaled comes with {SERVING_SLICE}"
    )
