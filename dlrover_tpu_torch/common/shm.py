"""POSIX shared-memory tensor arena — the flash checkpoint's staging area;
the port's own copy of ``dlrover_tpu/common/shm.py``
(``SharedMemoryArena``, ``_NativeSegment``, ``_PySegment``,
``arena_name``) over torch tensors.

A worker stages a flat ``{key: CPU tensor}`` state into one named shm
segment; it outlives the worker, so a restarted worker on the same host
restores from it (warm) without touching storage.  Segment layout::

    [ header 64 B | meta region (msgpack, fixed capacity) | tensor data ]

Write protocol (one writer): the header's ``dirty`` flag is set first, then
the tensor bytes, the meta, and a final header with ``dirty`` cleared, the
meta's length and CRC-32, and the commit count.  A writer killed mid-copy
leaves ``dirty`` set, and readers then see no state.

Before a segment is mapped, the free space of ``/dev/shm`` is checked
against the bytes it needs: a tmpfs that is too small would otherwise show
up as ``SIGBUS`` in the middle of a copy.

Two backends, as in the reference: the native one (``native/shm_arena.cc``
through ``common/native.py``: shm_open/mmap and a multi-threaded memcpy)
and ``multiprocessing.shared_memory`` when the native library cannot be
built.  :attr:`SharedMemoryArena.backend` says which one ran.
"""

from __future__ import annotations

import ctypes
import errno
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.env import run_scoped
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.native import shm_lib
from dlrover_tpu_torch.common.tensor_bytes import (
    byte_view,
    dtype_key,
    from_bytes,
    nbytes,
)

SHM_DIR = "/dev/shm"
MAGIC = 0x44_4C_52_54_50_55_01_00  # "DLRTPU\x01\x00"
HEADER_SIZE = 64
META_CAPACITY = 8 << 20  # bytes of msgpack meta
# magic u64 | data_capacity u64 | meta_capacity u64 | meta_len u64 |
# commit_count u64 | meta_crc u32 | dirty u32
_HEADER_FMT = "<QQQQQII"
_ALIGN = 128
# Below this, one numpy slice copy beats the threaded native memcpy.
_NATIVE_COPY_MIN = 1 << 22


def _required_size(flat: Dict[str, torch.Tensor], meta_capacity: int) -> int:
    data = sum(nbytes(t) for t in flat.values())
    data += _ALIGN * max(1, len(flat))  # each tensor starts 128 B-aligned
    return HEADER_SIZE + meta_capacity + data


def _segment_file(name: str) -> str:
    return os.path.join(SHM_DIR, name.lstrip("/"))


def check_room(name: str, size: int) -> None:
    """Raise ``OSError(ENOSPC)`` naming both numbers when ``/dev/shm``
    cannot hold a segment of ``size`` bytes (a segment of that name
    already there counts as room it may grow into)."""
    st = os.statvfs(SHM_DIR)
    free = st.f_bavail * st.f_frsize
    try:
        have = os.stat(_segment_file(name)).st_size
    except OSError:
        have = 0
    if size - have > free:
        raise OSError(
            errno.ENOSPC,
            f"shm arena {name} needs {size} bytes ({size / 2**30:.2f} GiB) "
            f"but {SHM_DIR} has {free} bytes ({free / 2**30:.2f} GiB) free; "
            f"enlarge {SHM_DIR} (e.g. docker --shm-size)",
        )


class _NativeSegment:
    """shm_open/mmap through ``native/shm_arena.cc``."""

    backend = "native"

    def __init__(self, name: str, size: int, create: bool):
        self._lib = shm_lib()
        if self._lib is None:
            raise OSError("native shm library unavailable")
        self.name = name
        cname = ("/" + name.lstrip("/")).encode()
        fd = (self._lib.shm_arena_create(cname, size) if create
              else self._lib.shm_arena_open(cname))
        if fd < 0:
            raise OSError(-fd, f"shm open failed for {name}")
        real = self._lib.shm_arena_size(fd)
        if real < 0:
            self._lib.shm_arena_close(fd)
            raise OSError(-real, f"fstat failed for {name}")
        self.size = max(int(real), size) if create else int(real)
        ptr = self._lib.shm_arena_map(fd, self.size)
        if not ptr:
            self._lib.shm_arena_close(fd)
            raise OSError(f"mmap failed for {name}")
        self._fd = fd
        self._ptr = ptr
        self.buf = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_ubyte)),
            shape=(self.size,))

    def memcpy_in(self, offset: int, src: torch.Tensor) -> None:
        n = nbytes(src)
        if n >= _NATIVE_COPY_MIN and src.is_contiguous():
            self._lib.shm_parallel_memcpy(self._ptr + offset,
                                          src.data_ptr(), n, 0)
        elif n:
            self.buf[offset:offset + n] = byte_view(src)

    def crc32(self, offset: int, n: int) -> int:
        return int(self._lib.shm_crc32(self._ptr + offset, n, 0))

    def close(self, unlink: bool = False) -> None:
        self.buf = None
        self._lib.shm_arena_unmap(self._ptr, self.size)
        self._lib.shm_arena_close(self._fd)
        if unlink:
            self._lib.shm_arena_unlink(("/" + self.name.lstrip("/")).encode())


class _PySegment:
    """``multiprocessing.shared_memory`` backend (no native library)."""

    backend = "python"

    def __init__(self, name: str, size: int, create: bool):
        from multiprocessing import resource_tracker, shared_memory

        self.name = name
        if create:
            try:
                self._shm = shared_memory.SharedMemory(
                    name=name, create=True, size=size)
            except FileExistsError:
                # A stale segment may be too small, and this backend
                # cannot grow one: replace it.
                existing = shared_memory.SharedMemory(name=name)
                if existing.size >= size:
                    self._shm = existing
                else:
                    existing.close()
                    existing.unlink()
                    self._shm = shared_memory.SharedMemory(
                        name=name, create=True, size=size)
        else:
            self._shm = shared_memory.SharedMemory(name=name)
        # The segment outlives this process by design: keep the resource
        # tracker from unlinking it at exit.
        try:
            resource_tracker.unregister(f"/{name}", "shared_memory")
        except (KeyError, ValueError, AttributeError):
            pass
        self.size = self._shm.size
        self.buf = np.frombuffer(self._shm.buf, dtype=np.uint8)

    def memcpy_in(self, offset: int, src: torch.Tensor) -> None:
        n = nbytes(src)
        if n:
            self.buf[offset:offset + n] = byte_view(src)

    def crc32(self, offset: int, n: int) -> int:
        return zlib.crc32(self.buf[offset:offset + n]) & 0xFFFFFFFF

    def close(self, unlink: bool = False) -> None:
        self.buf = None
        try:
            self._shm.close()
        except BufferError:
            pass  # a view is still alive: the mapping goes with the last one
        if unlink:
            self._shm.unlink()


def _open_segment(name: str, size: int, create: bool):
    if create:
        check_room(name, size)
    if shm_lib() is not None:
        try:
            return _NativeSegment(name, size, create)
        except OSError as e:
            if not create:
                raise FileNotFoundError(
                    f"shm segment {name} not found: {e}") from e
            logger.warning("native shm open failed (%s); python fallback", e)
    try:
        return _PySegment(name, size, create)
    except FileNotFoundError:
        raise
    except OSError as e:
        if not create:
            raise FileNotFoundError(
                f"shm segment {name} not found: {e}") from e
        raise


def _shm_stat(name: str):
    """(inode, size) of the segment's file, or None: tells a long-attached
    reader that the writer re-created the segment."""
    try:
        st = os.stat(_segment_file(name))
        return (st.st_ino, st.st_size)
    except OSError:
        return None


class SharedMemoryArena:
    """One named arena holding one staged state.  The writer calls
    :meth:`write_state`; a reader (the persist thread, or a restarted
    worker) calls :meth:`read_state` / :meth:`metadata`."""

    def __init__(self, name: str):
        self.name = name
        self._meta_capacity = META_CAPACITY
        self._seg = None
        self._seg_stat = None

    @property
    def backend(self) -> Optional[str]:
        """``"native"`` or ``"python"`` once a segment is open."""
        return None if self._seg is None else self._seg.backend

    @property
    def size(self) -> int:
        """Bytes of the mapped segment (0 when none is open)."""
        return 0 if self._seg is None else self._seg.size

    # -- writer side --------------------------------------------------------
    def write_state(self, flat: Dict[str, torch.Tensor],
                    extra: Optional[dict] = None) -> None:
        """Copy a flat ``{key: CPU tensor}`` state (and the msgpack-able
        ``extra``) into the arena, growing the segment if needed."""
        for key, t in flat.items():
            if t.device.type != "cpu":
                raise ValueError(f"arena takes CPU tensors; {key} is on "
                                 f"{t.device}")
        need = _required_size(flat, self._meta_capacity)
        if self._seg is None or self._seg.size < need:
            if self._seg is not None:
                self._seg.close(unlink=True)
                self._seg = None
            self._seg = _open_segment(self.name, need, create=True)
            self._seg_stat = _shm_stat(self.name)
        seg = self._seg

        prev = self._read_header()
        prev_commit = prev[4] if prev else 0
        self._write_header(struct.pack(
            _HEADER_FMT, MAGIC, seg.size, self._meta_capacity,
            prev[3] if prev else 0, prev_commit, prev[5] if prev else 0, 1))

        offset = HEADER_SIZE + self._meta_capacity
        metas: Dict[str, dict] = {}
        for key, t in flat.items():
            offset = (offset + _ALIGN - 1) & ~(_ALIGN - 1)
            seg.memcpy_in(offset, t)
            n = nbytes(t)
            metas[key] = {"dtype": dtype_key(t.dtype), "shape": list(t.shape),
                          "offset": offset, "nbytes": n}
            offset += n

        meta_blob = msgpack_lite.packb({"tensors": metas,
                                        "extra": extra or {}})
        if len(meta_blob) > self._meta_capacity:
            raise ValueError(
                f"checkpoint metadata ({len(meta_blob)}B) exceeds the meta "
                f"region ({self._meta_capacity}B)")
        seg.buf[HEADER_SIZE:HEADER_SIZE + len(meta_blob)] = np.frombuffer(
            meta_blob, dtype=np.uint8)
        crc = seg.crc32(HEADER_SIZE, len(meta_blob))
        self._write_header(struct.pack(
            _HEADER_FMT, MAGIC, seg.size, self._meta_capacity,
            len(meta_blob), prev_commit + 1, crc, 0))
        # Stores through a mapping do not always bump the file's mtime,
        # which tells a launcher's cleanup that the arena is live.
        try:
            os.utime(_segment_file(self.name))
        except OSError:
            pass

    def _write_header(self, raw: bytes) -> None:
        self._seg.buf[:len(raw)] = np.frombuffer(raw, dtype=np.uint8)

    # -- reader side --------------------------------------------------------
    def _ensure_open(self) -> None:
        if self._seg is None:
            self._seg = _open_segment(self.name, 0, create=False)
            self._seg_stat = _shm_stat(self.name)

    def _read_header(self):
        if self._seg is None or self._seg.size < HEADER_SIZE:
            return None
        vals = struct.unpack(
            _HEADER_FMT,
            bytes(self._seg.buf[:struct.calcsize(_HEADER_FMT)]))
        return vals if vals[0] == MAGIC else None

    def reopen(self) -> None:
        """Map the segment anew (the writer may have re-created it);
        raises ``FileNotFoundError`` when there is none."""
        if self._seg is not None:
            self._seg.close()
            self._seg = None
        self._ensure_open()

    def metadata(self) -> Optional[dict]:
        """``{"tensors": {key: meta}, "extra": ..., "commit_count": n}``,
        or ``None`` when the arena holds no committed state."""
        try:
            self._ensure_open()
        except FileNotFoundError:
            return None
        cur = _shm_stat(self.name)
        if cur is not None and cur != self._seg_stat:
            try:
                self.reopen()
            except FileNotFoundError:
                return None
        hdr = self._read_header()
        if hdr is None:
            return None
        _, _, _, meta_len, commit, crc, dirty = hdr
        if dirty:
            logger.warning("shm arena %s: writer died mid-write (dirty); "
                           "no valid state", self.name)
            return None
        if commit == 0 or meta_len == 0:
            return None
        if HEADER_SIZE + meta_len > self._seg.size or \
                self._seg.crc32(HEADER_SIZE, meta_len) != crc:
            logger.warning("shm arena %s: meta crc mismatch (torn write?)",
                           self.name)
            return None
        meta = msgpack_lite.unpackb(
            self._seg.buf[HEADER_SIZE:HEADER_SIZE + meta_len])
        meta["commit_count"] = commit
        return meta

    def read_state(self, copy: bool = True
                   ) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
        """The staged ``({key: tensor}, extra)``, or ``None``.

        ``copy=False`` gives views into the live mapping: valid only while
        this arena stays mapped (no :meth:`reopen`/:meth:`close`) and no
        :meth:`write_state` runs; callers hold their arena lock for as
        long as they use them."""
        meta = self.metadata()
        if meta is None:
            return None
        out: Dict[str, torch.Tensor] = {}
        for key, tm in meta["tensors"].items():
            off, n = int(tm["offset"]), int(tm["nbytes"])
            if off < 0 or off + n > self._seg.size:
                logger.warning("shm arena %s: tensor %s out of bounds",
                               self.name, key)
                return None
            out[key] = from_bytes(self._seg.buf[off:off + n], tm["dtype"],
                                  tm["shape"], copy=copy)
        return out, meta["extra"]

    def close(self, unlink: bool = False) -> None:
        if self._seg is not None:
            self._seg.close(unlink=unlink)
            self._seg = None


def arena_name(job_name: str, local_rank: int, purpose: str = "ckpt") -> str:
    """Per-rank arena name, scoped by the launcher's run id."""
    safe = run_scoped(job_name).replace("/", "_")
    return f"dlrtpu_{safe}_{purpose}_{local_rank}"


def unlink_arena(name: str) -> bool:
    """Remove a named arena's segment; ``False`` when there was none."""
    try:
        os.unlink(_segment_file(name))
        return True
    except FileNotFoundError:
        return False
