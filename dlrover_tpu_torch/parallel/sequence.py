"""Ulysses sequence parallelism: head <-> sequence all-to-all attention —
the port's counterpart of ``dlrover_tpu/parallel/sequence.py``
(``_attn_core`` ``:23``, ``ulysses_attention`` ``:35``).

Outside attention each rank of the sequence axis holds its block of
positions.  At attention a tiled all-to-all (:func:`~.collectives.
all_to_all`) re-shards ``[B, S/n, H, D]`` -> ``[B, S, H/n, D]``, so each
rank sees the whole sequence for its ``H/n`` heads, runs the core on
them, and the inverse all-to-all brings the output back to
``[B, S/n, H, D]``.  The gradient of each all-to-all is the inverse one.

As in :mod:`.ring_attention`, the port's function is the reference's
``shard_map`` body: it takes this rank's blocks and the port's
:class:`~.mesh.Mesh`.  ``H`` must be divisible by the axis's size.
``_attn_core`` multiplies in the input type (a bf16 product rounds to
bf16, as the reference's ``einsum`` does), masks with the type's lowest
value and takes the softmax in fp32, cast back.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dlrover_tpu_torch.parallel import collectives


def _attn_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool) -> torch.Tensor:
    # q, k, v: [B, S, H_local, D]
    root = torch.sqrt(torch.tensor(float(q.shape[-1]), dtype=torch.float32))
    scale = (1.0 / root.to(q.dtype)).to(q.device)
    att = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if causal:
        S, T = att.shape[-2], att.shape[-1]
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                     device=att.device))
        att = torch.where(mask, att, torch.finfo(att.dtype).min)
    att = torch.softmax(att.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", att, v)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, seq_axis: str = "tp", causal: bool = True,
                      attn_fn: Optional[Callable] = None,
                      batch_axes: Optional[tuple] = None) -> torch.Tensor:
    """This rank's ``[B, S/n, H, D]`` blocks of a sequence sharded over
    ``seq_axis`` -> its ``[B, S/n, H, D]`` output block.

    ``attn_fn(q, k, v, causal)`` runs on the whole-sequence,
    head-sharded blocks (default :func:`_attn_core`).  ``batch_axes`` is
    taken for the reference's signature (each rank holds its batch share
    already)."""
    del batch_axes
    core = attn_fn or _attn_core
    n = mesh.axis_size(seq_axis)
    if n == 1:
        return core(q, k, v, causal)
    H = q.shape[2]
    if H % n:
        raise ValueError(f"ulysses_attention: {H} heads are not divisible "
                         f"by {seq_axis}={n}")
    group = mesh.group((seq_axis,))
    members = mesh.members((seq_axis,))
    ordered = sorted(members)
    order = [ordered.index(r) for r in members]  # group rank of place j

    def a2a_fwd(x):  # [B, S/n, H, D] -> [B, S, H/n, D]
        return collectives.all_to_all(x, group, order, 2, 1)

    def a2a_bwd(x):  # [B, S, H/n, D] -> [B, S/n, H, D]
        return collectives.all_to_all(x, group, order, 1, 2)

    out = core(a2a_fwd(q), a2a_fwd(k), a2a_fwd(v), causal)
    return a2a_bwd(out)
