"""Checkpoint storage — the port's own copy of
``dlrover_tpu/common/storage.py``: ``CheckpointStorage`` (``write``,
``read``, ``exists``, ``listdir``, ``safe_makedirs``, ``safe_remove``,
``safe_rmtree``, ``rename_dir``, ``stream_writer``, ``open_read``,
``write_shard_ranges``), ``drain_ranges``, ``PosixDiskStorage`` and its
sink, which the streamed shard writer fills.

The object-store backend (``ObjectStoreStorage``: tensorstore's ``gs://``,
s3, http) and ``ClassMeta`` (how a trainer tells the agent-side saver which
backend to build) wait for later slices: :func:`storage_for` raises
``NotImplementedError`` for a URL.
"""

from __future__ import annotations

import abc
import contextlib
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Tuple

OBJECT_STORE_SLICE = (
    "a later checkpoint slice of the port (object stores; see ROADMAP.md)"
)


class ShardSink:
    """Random-access write target for one streamed file, published
    atomically when its ``stream_writer`` context exits cleanly.
    ``parallel_safe``: concurrent ``write_at`` calls are allowed."""

    parallel_safe = False

    def write_at(self, data, offset: int) -> int:
        raise NotImplementedError

    def truncate(self, size: int) -> None:
        raise NotImplementedError


class _PosixShardSink(ShardSink):
    """Direct-fd sink over a ``.tmp`` file; pwrite/pread are positional,
    so concurrent range writers are safe."""

    parallel_safe = True

    def __init__(self, fd: int) -> None:
        self._fd = fd

    def write_at(self, data, offset: int) -> int:
        view = memoryview(data)
        total = 0
        while total < len(view):
            total += os.pwrite(self._fd, view[total:], offset + total)
        return total

    def truncate(self, size: int) -> None:
        os.ftruncate(self._fd, size)


class CheckpointStorage(abc.ABC):
    """Byte-level storage surface of the flash checkpoint."""

    @abc.abstractmethod
    def write(self, content, path: str) -> None: ...

    @abc.abstractmethod
    def read(self, path: str, mode: str = "rb"): ...

    @abc.abstractmethod
    def safe_rmtree(self, dirpath: str) -> None: ...

    @abc.abstractmethod
    def safe_remove(self, path: str) -> None: ...

    @abc.abstractmethod
    def safe_makedirs(self, dirpath: str) -> None: ...

    @abc.abstractmethod
    def exists(self, path: str) -> bool: ...

    @abc.abstractmethod
    def listdir(self, path: str) -> list: ...

    def rename_dir(self, src: str, dst: str) -> bool:
        """Atomically rename a directory (checkpoint quarantine); a backend
        that cannot returns ``False`` and callers write a marker file."""
        return False

    @abc.abstractmethod
    def stream_writer(self, path: str):
        """A context manager yielding a :class:`ShardSink` for ``path``,
        published all-or-nothing on clean exit."""

    @abc.abstractmethod
    def open_read(self, path: str):
        """A readable, seekable binary file for ``path``, or ``None``."""

    def write_shard_ranges(
        self,
        path: str,
        total_size: int,
        ranges: Iterable[Tuple[int, Iterable]],
        *,
        workers: int = 1,
        finalize=None,
    ) -> None:
        """Atomically write a file assembled from ``[(offset,
        chunk_iterable), ...]``; ranges drain concurrently with ``workers >
        1`` on a ``parallel_safe`` sink.  ``finalize(sink)`` runs after
        every range landed and before the publish (the streamed shard
        writer patches its header and meta there)."""
        with self.stream_writer(path) as sink:
            if total_size:
                sink.truncate(total_size)
            drain_ranges(sink, list(ranges), workers)
            if finalize is not None:
                finalize(sink)


def drain_ranges(sink: ShardSink, ranges: list, workers: int = 1) -> None:
    """Write every ``(offset, chunk_iterable)`` range into ``sink``.  Each
    range is consumed in order by exactly one thread (its chunks may fold
    a CRC as they are yielded)."""

    def _one(rng) -> None:
        offset, chunks = rng
        pos = offset
        for chunk in chunks:
            pos += sink.write_at(chunk, pos)

    if workers <= 1 or not sink.parallel_safe or len(ranges) <= 1:
        for rng in ranges:
            _one(rng)
        return
    with ThreadPoolExecutor(max_workers=min(workers, len(ranges)),
                            thread_name_prefix="shard-range") as pool:
        list(pool.map(_one, ranges))  # re-raises the first worker error


class PosixDiskStorage(CheckpointStorage):
    """Local or NFS POSIX filesystem: temp file + fsync + rename."""

    def write(self, content, path: str) -> None:
        mode = "wb" if isinstance(content, bytes) else "w"
        tmp = path + ".tmp"
        with open(tmp, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def read(self, path: str, mode: str = "rb"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def safe_rmtree(self, dirpath: str) -> None:
        shutil.rmtree(dirpath, ignore_errors=True)

    def safe_remove(self, path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def safe_makedirs(self, dirpath: str) -> None:
        os.makedirs(dirpath, exist_ok=True)

    def rename_dir(self, src: str, dst: str) -> bool:
        try:
            os.replace(src, dst)
            return True
        except OSError:
            # A concurrent writer won the race, or dst is an earlier
            # non-empty quarantine dir: callers write a marker instead.
            return False

    @contextlib.contextmanager
    def stream_writer(self, path: str):
        tmp = path + ".tmp"
        fd = os.open(tmp, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            yield _PosixShardSink(fd)
            os.fsync(fd)
        except BaseException:
            os.close(fd)
            self.safe_remove(tmp)
            raise
        os.close(fd)
        os.replace(tmp, path)

    def open_read(self, path: str):
        try:
            return open(path, "rb")
        except OSError:
            return None

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list:
        try:
            return sorted(os.listdir(path))
        except OSError:
            return []


def storage_for(path: str) -> CheckpointStorage:
    """The backend for a checkpoint directory: POSIX for a local path.  A
    URL (``gs://``, ``s3://``: the reference's ``ObjectStoreStorage``)
    raises ``NotImplementedError``."""
    if "://" in path:
        raise NotImplementedError(
            f"object-store checkpoint storage ({path}) comes with "
            f"{OBJECT_STORE_SLICE}"
        )
    return PosixDiskStorage()
