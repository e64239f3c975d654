"""The port's training state <-> the flat shard dict — the port's own
counterpart of ``dlrover_tpu/checkpoint/tree_utils.py``
(``flatten_to_shards``, ``restore_to_target``) on one process.

The state is what ``parallel/accelerate.py`` builds: ``{"params": nested
dict/list of tensors, "opt_state": torch.optim.Optimizer, "step": int}``;
any nested dict/list of tensors, ints and optimizers works.  Each leaf is
named by its path in ``jax.tree_util.keystr`` form (``['params']['layers']
[0]['wq']``, dict keys in sorted order as JAX flattens them), and its
shard key is ``"<path>|0"``: on one process every tensor is one whole box.

An optimizer's state is named by the *parameter's* path, not by the
optimizer's index: AdamW's ``exp_avg``, ``exp_avg_sq`` (and
``max_exp_avg_sq`` with amsgrad) and ``step`` under
``['opt_state']['exp_avg']['params']...``; ``Adam8bit``'s
``Quantized`` codes (int8 ``[rows, 128]``) and scales (fp32 ``[rows]``)
of ``mu`` and ``nu``, its step count and its rounding generator's state.
AdamW creates its state at the first step; both functions create it first
as torch would (zeros, ``step`` 0), so a fresh optimizer has the same
leaves as a trained one.

:func:`restore_to_target` copies **into** the live tensors: the
optimizer holds the parameters by identity, and a restore that built new
tensors would leave it updating orphans.  It does not go through
``Optimizer.load_state_dict``, which casts floating state to the
parameter's dtype and knows nothing of ``Quantized``.  A missing key, an
extra key, or a shape or dtype that differs raises before anything is
copied.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from dlrover_tpu_torch.ops.quant import Adam8bit

LATER_OPTIMIZERS = "a later checkpoint slice of the port (see ROADMAP.md)"


@dataclasses.dataclass
class _Leaf:
    path: str
    tensor: torch.Tensor  # the live tensor (a fresh one for an int leaf)
    assign: Callable[[torch.Tensor], None]


def _key(k) -> str:
    """One path entry as ``jax.tree_util.keystr`` writes it."""
    return f"[{k!r}]" if isinstance(k, str) else f"[{k}]"


def _set_item(container, k):
    def assign(src: torch.Tensor) -> None:
        container[k] = int(src.item())
    return assign


def _collect(node, path: str, parent, k, leaves: List[_Leaf],
             opts: List[Tuple[str, torch.optim.Optimizer]]) -> None:
    if isinstance(node, torch.optim.Optimizer):
        opts.append((path, node))
    elif isinstance(node, dict):
        for key in sorted(node):
            _collect(node[key], path + _key(key), node, key, leaves, opts)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _collect(v, path + _key(i), node, i, leaves, opts)
    elif torch.is_tensor(node):
        leaves.append(_Leaf(path, node, node.copy_))
    elif isinstance(node, int) and not isinstance(node, bool):
        leaves.append(_Leaf(path, torch.tensor(node, dtype=torch.int64),
                            _set_item(parent, k)))
    elif node is not None:
        raise TypeError(f"checkpoint state leaf {path} is a "
                        f"{type(node).__name__}")


def _scalar_dtype() -> torch.dtype:
    # torch.optim's _get_scalar_dtype for an optimizer that is not fused.
    return (torch.float64 if torch.get_default_dtype() == torch.float64
            else torch.float32)


def _init_adam_state(opt: torch.optim.Optimizer) -> None:
    """Create the state Adam/AdamW creates at its first step, where it
    does not exist yet (``torch.optim.Adam._init_group``)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            on_param = group.get("capturable") or group.get("fused")
            st["step"] = (torch.zeros((), dtype=_scalar_dtype(),
                                      device=p.device) if on_param
                          else torch.tensor(0.0, dtype=_scalar_dtype()))
            st["exp_avg"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
            if group.get("amsgrad"):
                st["max_exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)


def _optimizer_leaves(opath: str, opt: torch.optim.Optimizer,
                      names: Dict[int, str]) -> List[_Leaf]:
    params = [p for g in opt.param_groups for p in g["params"]]
    for p in params:
        if id(p) not in names:
            raise KeyError(f"{opath}: an optimizer parameter "
                           f"{tuple(p.shape)} is not a tensor of the state")
    rank = {pid: i for i, pid in enumerate(names)}
    params.sort(key=lambda p: rank[id(p)])  # the state tree's order
    out: List[_Leaf] = []
    if isinstance(opt, Adam8bit):
        out.append(_Leaf(
            opath + _key("count"), torch.tensor(opt.count, dtype=torch.int64),
            lambda src: setattr(opt, "count", int(src.item()))))
        out.append(_Leaf(
            opath + _key("generator"), opt.generator.get_state(),
            lambda src: opt.generator.set_state(src.clone())))
        for field in ("mu", "nu"):
            for p in params:
                q = opt.state[p][field]
                base = opath + _key(field) + names[id(p)]
                out.append(_Leaf(base + _key("codes"), q.codes, q.codes.copy_))
                out.append(_Leaf(base + _key("scale"), q.scale, q.scale.copy_))
        return out
    if isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
        _init_adam_state(opt)
        fields = sorted({f for p in params for f in opt.state[p]})
        for field in fields:
            for p in params:
                t = opt.state[p][field]
                out.append(_Leaf(opath + _key(field) + names[id(p)], t,
                                 t.copy_))
        return out
    raise NotImplementedError(
        f"checkpointing a {type(opt).__name__} comes with {LATER_OPTIMIZERS}")


def state_leaves(state: Any) -> List[_Leaf]:
    """Every leaf of ``state`` with its path, optimizers' state included."""
    leaves: List[_Leaf] = []
    opts: List[Tuple[str, torch.optim.Optimizer]] = []
    _collect(state, "", None, None, leaves, opts)
    names = {id(leaf.tensor): leaf.path for leaf in leaves}
    for opath, opt in opts:
        leaves.extend(_optimizer_leaves(opath, opt, names))
    return leaves


def flatten_to_shards(state: Any
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, dict]]:
    """``(tensors, info)``: ``tensors["<path>|0"]`` is the live tensor of
    leaf ``path`` (on its device), ``info["<path>|0"]`` its placement as
    the reference records it (global shape, the whole box as index, the
    owning process for a card tensor, ``host`` for a CPU one)."""
    tensors: Dict[str, torch.Tensor] = {}
    info: Dict[str, dict] = {}
    for leaf in state_leaves(state):
        key = f"{leaf.path}|0"
        shape = list(leaf.tensor.shape)
        tensors[key] = leaf.tensor
        info[key] = {"path": leaf.path, "global_shape": shape,
                     "index": [[0, d] for d in shape]}
        if leaf.tensor.device.type == "cpu":
            info[key]["host"] = True
        else:
            info[key]["owners"] = [0]
    return tensors, info


def source_from_shards(tensors: Dict[str, torch.Tensor],
                       info: Dict[str, dict]) -> Dict[str, torch.Tensor]:
    """``{path: tensor}`` from one shard's pieces.  Each piece must be its
    leaf's whole box; assembling boxes that several processes wrote
    comes with the multi-process slice (``KeyError``)."""
    out: Dict[str, torch.Tensor] = {}
    for key, t in tensors.items():
        meta = info.get(key)
        if meta is None:
            raise KeyError(f"shard tensor {key!r} has no placement info")
        whole = [[0, int(d)] for d in meta.get("global_shape", [])]
        if [[int(a), int(b)] for a, b in meta.get("index", [])] != whole:
            raise KeyError(
                f"{meta['path']}: a partial box {meta.get('index')}; "
                "restoring boxes of several processes comes with Queue A "
                "item 3 of the port")
        out[meta["path"]] = t
    return out


def restore_to_target(source: Dict[str, torch.Tensor], target: Any) -> Any:
    """Copy ``source`` (``{path: tensor}``) into the live leaves of
    ``target`` and return ``target``.  Raises ``KeyError`` when a path is
    missing or extra and ``ValueError`` when a shape or dtype differs,
    before anything is copied."""
    leaves = state_leaves(target)
    want = {leaf.path for leaf in leaves}
    missing = sorted(want - source.keys())
    extra = sorted(source.keys() - want)
    if missing or extra:
        raise KeyError(
            f"checkpoint does not match the target: {len(missing)} "
            f"missing {missing[:3]}, {len(extra)} extra {extra[:3]}")
    for leaf in leaves:
        src = source[leaf.path]
        if tuple(src.shape) != tuple(leaf.tensor.shape) \
                or src.dtype != leaf.tensor.dtype:
            raise ValueError(
                f"{leaf.path}: checkpoint has {src.dtype} "
                f"{tuple(src.shape)}, target {leaf.tensor.dtype} "
                f"{tuple(leaf.tensor.shape)}")
    with torch.no_grad():
        for leaf in leaves:
            leaf.assign(source[leaf.path])
    return target
