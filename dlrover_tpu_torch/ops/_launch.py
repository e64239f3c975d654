"""The host side of the port's ctypes kernel launches: RMSNorm,
cross-entropy and the blockwise quantize (the flash wrappers keep their
own).

At the decode shape a launch's host time is larger than its kernel's
device time (8 x 4096 bf16 RMSNorm: about 2 µs on an H100), so the
wrappers do as little on the host as they can while staying correct:

- **Stream.** :func:`stream` reads the caller's current stream for the
  tensor's device at every call, as an int (the ``cudaStream_t``), without
  making a ``torch.cuda.Stream`` object.  Nothing caches it: a call made
  under ``with torch.cuda.stream(s):`` launches on ``s``.
- **Device.** The C entry point takes the tensor's device index and makes
  that device current only when the calling thread's current device is
  another one, restoring it after the launch (``csrc/launch.cuh``
  ``DeviceScope``), in place of a ``torch.cuda.device`` context: a tensor
  on ``cuda:N`` launches on ``cuda:N``.
- **Arguments.** :func:`bind` sets no ``argtypes``, so ctypes passes plain
  Python ints without making a ctypes object for each.  It passes such an
  int as a 32-bit C int, so each 64-bit value (a ``data_ptr()``, the
  stream, a count that may pass 2**31) goes as two halves, ``v & LO`` and
  ``v >> 32``, which the entry point joins (``launch.cuh`` ``join``).  A
  float goes as ``ctypes.c_float``.  Every other int is one that the
  wrapper has checked to be at most :data:`INT_MAX`.

The wrappers allocate their outputs anew at every call and raise when an
entry point returns a CUDA error (``cudaGetLastError()`` after the
launch).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from dlrover_tpu_torch.ops import _build

LO = 0xFFFFFFFF
INT_MAX = 0x7FFFFFFF


def bind(name: str, sources: Sequence[str], symbol: str):
    """The entry point ``symbol`` of kernel library ``name`` (built first
    if needed), to be called with plain ints: no ``argtypes``, an ``int``
    result."""
    fn = getattr(_build.load(name, sources), symbol)
    fn.restype = ctypes.c_int
    return fn


def stream(device: int) -> int:
    """The caller's current stream on CUDA device ``device``, as an int."""
    return torch._C._cuda_getCurrentRawStream(device)
