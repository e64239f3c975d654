"""Build and load the port's hand-written CUDA kernels.

Each kernel source under ``ops/csrc/`` exports a plain C function.  At first
use :func:`load` compiles it with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/kernels/`` at the repository root, named by a
hash of the sources and flags, and loads it with ``ctypes``.  A library
whose hash is already on disk is loaded as it is; a changed source builds
anew.  A failed build raises: there is no fallback.

A kernel's sources are its ``.cu`` files, which ``nvcc`` compiles, and the
headers they include (``.cuh``), which count only in the hash.  No PyTorch
header is compiled, so a build takes seconds, not minutes.  The flash
wrappers pass pointers (``tensor.data_ptr()``) and PyTorch's current stream
as ``ctypes.c_void_p``; the other wrappers call through ``ops/_launch.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

from dlrover_tpu_torch.common.log import logger

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` when ``CUDA_HOME`` is set, else ``nvcc`` on
    ``PATH``, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home:
        cand = os.path.join(home, "bin", "nvcc")
    else:
        cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(cand):
        raise RuntimeError(
            f"nvcc not found at {cand}: the port's CUDA kernels are built "
            "from source at first use and need the CUDA toolkit "
            "(set CUDA_HOME)"
        )
    return cand


def _digest(sources: Sequence[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, sources: Sequence[str]) -> Path:
    """Compile the ``.cu`` files of ``sources`` (file names under
    ``ops/csrc/``, with the headers they include) into
    ``build/kernels/lib<name>-<hash>.so`` unless it exists; returns the
    path.  Safe to call from several threads or processes at once: each
    compiles to a private file and renames it into place."""
    paths = [CSRC / s for s in sources]
    out = BUILD_DIR / f"lib{name}-{_digest(paths)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    units = [str(p) for p in paths if p.suffix == ".cu"]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *units]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    logger.info("built %s in %.1fs\n%s", out.name,
                time.perf_counter() - t0, proc.stderr.strip())
    return out


def load(name: str, sources: Sequence[str]) -> ctypes.CDLL:
    """The library for kernel ``name``, built first if needed.  Each
    kernel module loads it once and keeps the bound function."""
    return ctypes.CDLL(str(build(name, sources)))
