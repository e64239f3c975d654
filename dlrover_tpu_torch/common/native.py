"""Loader for the shm arena's native library — the port's own copy of
``dlrover_tpu/common/native.py`` (``load_library``, ``shm_lib``), trimmed to
``shm_lib()``.

At first use it compiles ``native/shm_arena.cc`` (shm_open/mmap lifecycle,
a multi-threaded memcpy and CRC-32) with ``g++`` into
``build/native/libshm_arena-<hash>.so`` at the repository root, named by a
hash of the source and flags as ``ops/_build.py`` names the kernels, and
loads it with ``ctypes``.  It never writes into ``native/``.  As in the
reference, a failed build is logged and ``shm_lib()`` returns ``None``: the
arena then runs on ``multiprocessing.shared_memory`` and CRCs come from
``zlib``, and the arena says which backend it used
(``SharedMemoryArena.backend``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

from dlrover_tpu_torch.common.log import logger

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "shm_arena.cc"
BUILD_DIR = REPO / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_LOCK = threading.Lock()
_LIB: dict = {}


def _build() -> Optional[Path]:
    """``build/native/libshm_arena-<hash>.so``, compiled unless present;
    ``None`` when there is no compiler or the build fails."""
    if not SOURCE.is_file():
        logger.warning("native source %s missing", SOURCE)
        return None
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out = BUILD_DIR / f"libshm_arena-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        logger.warning("no g++: the shm arena falls back to Python")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lrt"],
                       check=True, capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        logger.warning("native build of %s failed: %s", SOURCE.name, e)
        return None
    os.replace(tmp, out)
    return out


def shm_lib() -> Optional[ctypes.CDLL]:
    """The native shm library with its signatures set, or ``None``."""
    with _LOCK:
        if "shm" in _LIB:
            return _LIB["shm"]
        lib = None
        path = _build()
        if path is not None:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                logger.warning("loading %s failed: %s", path, e)
        if lib is not None:
            u64, vp = ctypes.c_uint64, ctypes.c_void_p
            sigs = {
                "shm_arena_create": (ctypes.c_int, [ctypes.c_char_p, u64]),
                "shm_arena_open": (ctypes.c_int, [ctypes.c_char_p]),
                "shm_arena_size": (ctypes.c_int64, [ctypes.c_int]),
                "shm_arena_map": (vp, [ctypes.c_int, u64]),
                "shm_arena_unmap": (ctypes.c_int, [vp, u64]),
                "shm_arena_unlink": (ctypes.c_int, [ctypes.c_char_p]),
                "shm_arena_close": (ctypes.c_int, [ctypes.c_int]),
                "shm_parallel_memcpy": (None, [vp, vp, u64, ctypes.c_int]),
                "shm_crc32": (ctypes.c_uint32, [vp, u64, ctypes.c_uint32]),
            }
            for name, (res, args) in sigs.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = res, args
        _LIB["shm"] = lib
        return lib
