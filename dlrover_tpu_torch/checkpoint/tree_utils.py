"""The port's training state <-> the flat shard dict — the port's own
counterpart of ``dlrover_tpu/checkpoint/tree_utils.py``
(``flatten_to_shards``, ``ShardSource``, ``restore_to_target``).

The state is what ``parallel/accelerate.py`` builds: ``{"params": nested
dict/list of tensors, "opt_state": torch.optim.Optimizer, "step": int}``;
any nested dict/list of tensors, ints and optimizers works.  Each leaf is
named by its path in ``jax.tree_util.keystr`` form (``['params']['layers']
[0]['wq']``, dict keys in sorted order as JAX flattens them), and its
shard key is ``"<path>|0"``: each process holds one box of each leaf.
A leaf that stays whole is one box held by every rank of the world
(``owners``), which is what lets the sliced persist split its bytes across
them (``dlrover_tpu/checkpoint/tree_utils.py:55-112``).  A box of a
sharded leaf (tagged with its :class:`~dlrover_tpu_torch.parallel.
sharding.Placement` by ``accelerate``) records the leaf's global shape,
the box as ``index`` and the ranks that hold the same box as ``owners``,
as the reference records a partial box.  An optimizer's moments take the
placement of their parameter.

An optimizer's state is named by the *parameter's* path, not by the
optimizer's index: AdamW's ``exp_avg``, ``exp_avg_sq`` (and
``max_exp_avg_sq`` with amsgrad) and ``step`` under
``['opt_state']['exp_avg']['params']...``; ``Adam8bit``'s
``Quantized`` codes (int8 ``[rows, 128]``) and scales (fp32 ``[rows]``)
of ``mu`` and ``nu``, its step count and its rounding generator's state.
AdamW creates its state at the first step; both functions create it first
as torch would (zeros, ``step`` 0), so a fresh optimizer has the same
leaves as a trained one.

:class:`ShardSource` gathers the pieces of one checkpoint from any number
of shard files: a sliced piece (a byte range of a box, as the sliced
persist wrote it) waits until its box's slices tile the box, then becomes
a whole piece; :meth:`ShardSource.assemble` builds any box from the pieces
(exact match, else the overlap copy).

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
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from dlrover_tpu_torch.common.constants import QUANT_OFFLOAD_ITEM
from dlrover_tpu_torch.common.tensor_bytes import torch_dtype
from dlrover_tpu_torch.ops.quant import Adam8bit
from dlrover_tpu_torch.parallel.sharding import Placement, placement_of

Box = Tuple[Tuple[int, int], ...]

LATER_OPTIMIZERS = "a later checkpoint slice of the port (see ROADMAP.md)"


@dataclasses.dataclass
class _Leaf:
    path: str
    tensor: torch.Tensor  # the live tensor (a fresh one for an int leaf)
    assign: Callable[[torch.Tensor], None]
    placement: Optional[Placement] = None  # None: a whole tensor


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
        leaves.append(_Leaf(path, node, node.copy_, placement_of(node)))
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
        if any(_sharded(p) for p in params):
            raise NotImplementedError(
                f"{opath}: 8-bit Adam over a sharded leaf comes with "
                f"{QUANT_OFFLOAD_ITEM}")
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
                pl = placement_of(p) if t.shape == p.shape else None
                out.append(_Leaf(opath + _key(field) + names[id(p)], t,
                                 t.copy_, pl))
        return out
    raise NotImplementedError(
        f"checkpointing a {type(opt).__name__} comes with {LATER_OPTIMIZERS}")


def _sharded(t: torch.Tensor) -> bool:
    pl = placement_of(t)
    return pl is not None and pl.sharded


def state_leaves(state: Any) -> List[_Leaf]:
    """Every leaf of ``state`` with its path, optimizers' state included."""
    leaves: List[_Leaf] = []
    opts: List[Tuple[str, torch.optim.Optimizer]] = []
    _collect(state, "", None, None, leaves, opts)
    names = {id(leaf.tensor): leaf.path for leaf in leaves}
    for opath, opt in opts:
        leaves.extend(_optimizer_leaves(opath, opt, names))
    return leaves


def flatten_to_shards(state: Any, world: int = 1
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, dict]]:
    """``(tensors, info)``: ``tensors["<path>|0"]`` is the live tensor of
    leaf ``path`` (on its device, this rank's box of a sharded leaf),
    ``info["<path>|0"]`` its placement as the reference records it: the
    global shape, the box as index, and ``owners`` (the ranks that hold
    the box: every rank of the ``world`` for a whole card tensor) or
    ``host`` for a whole CPU one."""
    tensors: Dict[str, torch.Tensor] = {}
    info: Dict[str, dict] = {}
    for leaf in state_leaves(state):
        key = f"{leaf.path}|0"
        tensors[key] = leaf.tensor
        pl = leaf.placement
        if pl is not None and pl.sharded:
            info[key] = {"path": leaf.path,
                         "global_shape": list(pl.global_shape),
                         "index": [list(b) for b in pl.box()],
                         "owners": pl.owners()}
            continue
        shape = list(leaf.tensor.shape)
        info[key] = {"path": leaf.path, "global_shape": shape,
                     "index": [[0, d] for d in shape]}
        if leaf.tensor.device.type == "cpu":
            info[key]["host"] = True
        else:
            info[key]["owners"] = list(range(world))
    return tensors, info


class ShardSource:
    """Every piece known of one checkpoint's leaves, from one or several
    processes' shard files.

    A sliced piece (``slices[key]`` is its shard meta: ``slice``,
    ``full_nbytes``, ``dtype``, ``shape``; the tensor is its flat ``uint8``
    payload) accumulates per ``(path, box)`` and becomes a whole piece once
    the slices tile the box's bytes; a box whose slices never complete
    gives nothing, so :meth:`assemble` reports it uncovered and the
    restore ladder falls back."""

    def __init__(self):
        #: path -> [(box, tensor)]
        self.pieces: Dict[str, List[Tuple[Box, torch.Tensor]]] = {}
        #: path -> global shape
        self.shapes: Dict[str, Tuple[int, ...]] = {}
        self._partial: Dict[Tuple[str, Box], dict] = {}

    def add(self, tensors: Dict[str, torch.Tensor], info: Dict[str, dict],
            slices: Optional[Dict[str, dict]] = None) -> None:
        for key, t in tensors.items():
            meta = info.get(key)
            if meta is None:
                continue
            path = meta["path"]
            idx = tuple((int(a), int(b)) for a, b in meta["index"])
            self.shapes[path] = tuple(
                int(d) for d in meta.get("global_shape", [b for _, b in idx]))
            sl = (slices or {}).get(key)
            if sl is None:
                self.pieces.setdefault(path, []).append((idx, t))
                continue
            lo, hi = (int(v) for v in sl["slice"])
            ent = self._partial.setdefault((path, idx), {
                "full": int(sl.get("full_nbytes", 0)),
                "dtype": sl["dtype"],
                "shape": tuple(int(d) for d in sl["shape"]),
                "parts": {},
            })
            ent["parts"][(lo, hi)] = t.reshape(-1).view(torch.uint8)
            self._materialize_if_complete(path, idx, ent)

    def _materialize_if_complete(self, path: str, idx: Box,
                                 ent: dict) -> None:
        if ent.get("done"):
            return
        pos = 0
        parts = sorted(ent["parts"].items())
        for (lo, hi), _ in parts:
            if lo > pos:
                return  # a gap: some rank's slice is still missing
            pos = max(pos, hi)
        if pos < ent["full"]:
            return
        out = torch.empty(ent["shape"], dtype=torch_dtype(ent["dtype"]))
        flat = out.reshape(-1).view(torch.uint8)
        if flat.numel() != ent["full"]:
            return  # the meta lies about the size: leave it uncovered
        for (lo, hi), chunk in parts:
            flat[lo:hi] = chunk[:hi - lo]
        self.pieces.setdefault(path, []).append((idx, out))
        ent["done"] = True

    def paths(self) -> List[str]:
        return list(self.pieces.keys())

    def assemble(self, path: str, index: Box,
                 dtype: Optional[torch.dtype] = None
                 ) -> Optional[torch.Tensor]:
        """The part of leaf ``path`` covering ``index`` from the pieces:
        an exact match, else the overlap copy.  ``None`` when a region is
        not covered."""
        pieces = self.pieces.get(path)
        if not pieces:
            return None
        index = tuple((int(a), int(b)) for a, b in index)
        for idx, t in pieces:
            if idx == index:
                return t
        shape = tuple(e - s for s, e in index)
        out = torch.empty(shape, dtype=dtype or pieces[0][1].dtype)
        covered = torch.zeros(shape, dtype=torch.bool) if out.numel() \
            else None
        for idx, t in pieces:
            dst, src = [], []
            for (ps, pe), (rs, re_) in zip(idx, index):
                lo, hi = max(ps, rs), min(pe, re_)
                if lo >= hi:
                    break
                dst.append(slice(lo - rs, hi - rs))
                src.append(slice(lo - ps, hi - ps))
            else:
                out[tuple(dst)] = t[tuple(src)]
                if covered is not None:
                    covered[tuple(dst)] = True
        if covered is not None and not bool(covered.all()):
            return None
        return out

    def whole(self) -> Dict[str, torch.Tensor]:
        """``{path: tensor}``, each leaf assembled whole; ``KeyError`` when
        a leaf is not covered."""
        out: Dict[str, torch.Tensor] = {}
        for path in self.pieces:
            shape = self.shapes[path]
            t = self.assemble(path, tuple((0, d) for d in shape))
            if t is None:
                raise KeyError(f"checkpoint missing data for {path}")
            out[path] = t
        for path, idx in self._partial:
            if path not in out:
                raise KeyError(f"checkpoint missing slices of {path} "
                               f"{idx}")
        return out


def check_target(source: Dict[str, torch.Tensor], target: Any
                 ) -> List[_Leaf]:
    """The live leaves of ``target``, once ``source`` (``{path: tensor}``)
    is known to fit them: ``KeyError`` when a path is missing or extra,
    ``ValueError`` when a shape or dtype differs."""
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
    return leaves


def restore_to_target(source: Dict[str, torch.Tensor], target: Any) -> Any:
    """Copy ``source`` (``{path: tensor}``) into the live leaves of
    ``target`` and return ``target``; raises as :func:`check_target` does,
    before anything is copied."""
    leaves = check_target(source, target)
    with torch.no_grad():
        for leaf in leaves:
            leaf.assign(source[leaf.path])
    return target
