"""Carry a ``dlrover_tpu`` Llama parameter tree into the port.

The reference keeps its parameters as a JAX pytree of fp32 arrays and casts
each projection with ``w.astype(cfg.dtype)`` at use; the embedding is cast
to ``cfg.dtype`` before its gather (``llama_infer.forward_step``).  The
port stores every projection and the embedding once in ``cfg.dtype`` — the
same round-to-nearest-even cast, made once — and keeps the norm gains
(``ln1``, ``ln2``, ``ln_f``) in fp32.

    tree = jax.tree.map(np.asarray, params)      # on the JAX side
    params_t = params_from_numpy(tree, cfg, device="cpu")

Training keeps fp32 masters: ``param_dtype=torch.float32`` stores every
leaf as the reference does.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dlrover_tpu_torch.common.constants import MODEL_ITEM
from dlrover_tpu_torch.common.device import DeviceLike, resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig

_GAINS = ("ln1", "ln2", "ln_f")


def params_from_numpy(tree: Dict, cfg: LlamaConfig,
                      device: DeviceLike = None,
                      param_dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's parameter tree as numpy arrays -> the port's, with
    the projections in ``param_dtype`` (default ``cfg.dtype``)."""
    dev = resolve_device(device)
    store = cfg.dtype if param_dtype is None else param_dtype

    def leaf(name: str, a) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(a, np.float32).copy())
        return t.to(dev, torch.float32 if name in _GAINS else store)

    def conv(node: Dict) -> Dict:
        return {
            k: conv(v) if isinstance(v, dict) else leaf(k, v)
            for k, v in node.items()
        }

    for i, layer in enumerate(tree["layers"]):
        if "moe" in layer:
            raise NotImplementedError(
                f"layer {i} is an MoE layer; MoE layers come with "
                f"{MODEL_ITEM}"
            )
    out = conv({k: v for k, v in tree.items() if k != "layers"})
    out["layers"] = [conv(layer) for layer in tree["layers"]]
    return out
