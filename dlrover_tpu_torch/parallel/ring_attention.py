"""Ring attention over a sequence axis — the port's counterpart of
``dlrover_tpu/parallel/ring_attention.py`` (``_block_attn`` ``:23``,
``ring_attention`` ``:42``).

Rank ``i`` of the axis owns query block ``i`` and, at first, key/value
block ``i``.  The K/V blocks make ``n - 1`` hops around the ring
(:func:`~.collectives.ring_hop`: to rank ``i + 1``, from rank ``i - 1``)
while each rank keeps a running online-softmax accumulator (max, sum,
weighted values), so a rank never holds more than one block of the
sequence.  At hop ``h`` rank ``i`` holds block ``(i - h) mod n``; the
causal mask compares the global positions of the two blocks.

The reference's function is the whole ``shard_map``; the port's is its
body: it takes this rank's ``[B, S/n, H, D]`` blocks and the port's
:class:`~.mesh.Mesh` and returns this rank's output block.  The block
products and the merge run in fp32 whatever the input type, as the
reference's do; the output is cast back to ``q.dtype``.  ``batch_axes``
is taken for the reference's signature: each rank already holds only its
batch share, so the port needs no batch spec.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from dlrover_tpu_torch.parallel import collectives


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias_mask: torch.Tensor):
    """One q-block x kv-block partial attention with stable accumulators.

    q: [B, Sq, H, D]; k, v: [B, Sk, H, D]; ``bias_mask`` [Sq, Sk] bool
    (True = attend).  Returns ``(num [B, Sq, H, D], denom [B, Sq, H],
    m [B, Sq, H])``, all fp32."""
    # The fp32 value of 1 / sqrt(D), as the reference computes it.
    scale = float(np.float32(1.0) / np.sqrt(np.float32(q.shape[-1])))
    s = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) * scale
    s = torch.where(bias_mask[None, :, None, :], s, -math.inf)
    m = torch.amax(s, dim=-1)  # [B, Sq, H]
    # All-masked rows: exp(-inf - -inf) guard.
    finite_m = torch.isfinite(m)
    m_safe = torch.where(finite_m, m, 0.0)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    denom = torch.sum(p, dim=-1)
    num = torch.einsum("bqhk,bkhd->bqhd", p, v.float())
    return num, denom, torch.where(finite_m, m, -math.inf)


def _causal_mask(q_block: int, kv_block: int, Sb: int,
                 device: torch.device) -> torch.Tensor:
    """Global positions: q in block ``q_block``, kv in ``kv_block``."""
    qpos = q_block * Sb + torch.arange(Sb, device=device)[:, None]
    kpos = kv_block * Sb + torch.arange(Sb, device=device)[None, :]
    return qpos >= kpos


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, *, seq_axis: str = "tp", causal: bool = True,
                   batch_axes: Optional[tuple] = None) -> torch.Tensor:
    """This rank's blocks ``q, k, v`` [B, S/n, H, D] of a sequence sharded
    over ``seq_axis`` -> its output block [B, S/n, H, D].  With ``n == 1``
    the whole sequence is one block."""
    del batch_axes  # each rank holds its batch share already
    n = mesh.axis_size(seq_axis)
    if n == 1:
        Sq = q.shape[1]
        mask = torch.ones((Sq, Sq), dtype=torch.bool, device=q.device)
        if causal:
            mask = torch.tril(mask)
        num, denom, _ = _block_attn(q, k, v, mask)
        return (num / torch.clamp_min(denom, 1e-20)[..., None]).to(q.dtype)

    group = mesh.group((seq_axis,))
    ring = mesh.members((seq_axis,))
    i = mesh.coords[seq_axis]
    nxt, prev = ring[(i + 1) % n], ring[(i - 1) % n]
    B, Sb, H, D = q.shape
    ones = torch.ones((Sb, Sb), dtype=torch.bool, device=q.device)
    num = torch.zeros((B, Sb, H, D), dtype=torch.float32, device=q.device)
    denom = torch.zeros((B, Sb, H), dtype=torch.float32, device=q.device)
    m = torch.full((B, Sb, H), -math.inf, dtype=torch.float32,
                   device=q.device)
    kv = torch.stack([k, v])
    for hop in range(n):
        kv_idx = (i - hop) % n
        mask = _causal_mask(i, kv_idx, Sb, q.device) if causal else ones
        bnum, bdenom, bm = _block_attn(q, kv[0], kv[1], mask)
        # Online softmax merge.
        new_m = torch.maximum(m, bm)
        new_m_safe = torch.where(torch.isfinite(new_m), new_m, 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - new_m_safe),
                            0.0)
        beta = torch.where(torch.isfinite(bm), torch.exp(bm - new_m_safe),
                           0.0)
        num = num * alpha[..., None] + bnum * beta[..., None]
        denom = denom * alpha + bdenom * beta
        m = new_m
        if hop < n - 1:
            # Rotate K/V to the next rank (the last hop's would be unused).
            kv = collectives.ring_hop(kv, group, nxt, prev)
    return (num / torch.clamp_min(denom, 1e-20)[..., None]).to(q.dtype)
