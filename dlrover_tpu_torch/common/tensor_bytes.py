"""A tensor's bytes and the name of its type in a checkpoint.

The reference writes numpy arrays and names each dtype by
``dtype.name`` (``dlrover_tpu/checkpoint/shard_file.py`` ``_dtype_key``,
``dlrover_tpu/common/shm.py`` ``write_state``), with bfloat16 and the fp8
types from ``ml_dtypes``.  The port holds torch tensors and needs no
``ml_dtypes``: a bf16 tensor's bytes are its ``uint16`` bit pattern, named
``"bfloat16"`` exactly as the reference names it, and a ``"bfloat16"``
blob is read back as ``torch.bfloat16``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

#: The name the reference writes for each type (numpy's / ml_dtypes'
#: ``dtype.name``).
DTYPE_KEYS = {
    torch.float64: "float64",
    torch.float32: "float32",
    torch.float16: "float16",
    torch.bfloat16: "bfloat16",
    torch.float8_e4m3fn: "float8_e4m3fn",
    torch.float8_e5m2: "float8_e5m2",
    torch.int64: "int64",
    torch.int32: "int32",
    torch.int16: "int16",
    torch.int8: "int8",
    torch.uint8: "uint8",
    torch.bool: "bool",
}
_BY_KEY = {v: k for k, v in DTYPE_KEYS.items()}


def dtype_key(dtype: torch.dtype) -> str:
    """The checkpoint's name for ``dtype``; raises ``TypeError`` for a type
    the format has no name for."""
    try:
        return DTYPE_KEYS[dtype]
    except KeyError:
        raise TypeError(f"no checkpoint dtype name for {dtype}") from None


def torch_dtype(key: str) -> torch.dtype:
    """The torch type of a checkpoint's dtype name; a numpy type string
    such as ``"<f4"`` is accepted too.  Raises ``TypeError``."""
    dt = _BY_KEY.get(key)
    if dt is None:
        try:
            dt = _BY_KEY.get(np.dtype(key).name)
        except TypeError:
            dt = None
    if dt is None:
        raise TypeError(f"unknown checkpoint dtype {key!r}")
    return dt


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def byte_view(t: torch.Tensor) -> np.ndarray:
    """The bytes of a CPU tensor as a flat ``uint8`` array: a view when the
    tensor is contiguous, else a contiguous copy."""
    if t.device.type != "cpu":
        raise ValueError(f"byte_view needs a CPU tensor, got {t.device}")
    flat = t.detach().contiguous().reshape(-1)
    if flat.numel() == 0:
        return np.empty(0, dtype=np.uint8)
    return flat.view(torch.uint8).numpy()


def from_bytes(buf, key: str, shape: Sequence[int],
               copy: bool = False) -> torch.Tensor:
    """A tensor of dtype name ``key`` and ``shape`` over ``buf`` (a
    writable buffer: a view unless ``copy``).  Raises ``TypeError`` or
    ``ValueError`` when the type, shape and size disagree."""
    dt = torch_dtype(key)
    shape = tuple(int(d) for d in shape)
    raw = memoryview(buf).cast("B")
    size = int(np.prod(shape, dtype=np.int64)) * torch.empty(
        (), dtype=dt).element_size()
    if len(raw) != size:
        raise ValueError(
            f"{len(raw)} bytes do not hold a {key} tensor of shape {shape}")
    if size == 0:
        return torch.empty(shape, dtype=dt)
    out = torch.frombuffer(raw, dtype=dt).reshape(shape)
    return out.clone() if copy else out
