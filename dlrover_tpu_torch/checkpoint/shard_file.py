"""On-disk shard file format and the commit protocol — the port's own copy
of ``dlrover_tpu/checkpoint/shard_file.py`` on its single-process path,
over torch tensors: ``pack_shard``, ``unpack_shard``, ``verify_shard``,
``verify_shard_file``, ``write_shard``, ``ShardStreamWriter``,
``write_shard_from_views``, ``read_shard_manifest``, ``read_shard_meta``,
``read_shard_pieces``, ``read_shard``, ``commit``, ``resolve_keep_last``,
``referenced_steps``, ``quarantine_step``, ``list_steps``,
``list_quarantined``, ``latest_step``, ``shard_version`` and
``ShardCorruptionError``.

One shard file per process per step::

    <ckpt_dir>/step_<N>/shard_<process_id>.ckpt     (header|meta|tensor data)
    <ckpt_dir>/step_<N>/.done_<process_id>          (done file, commit vote)
    <ckpt_dir>/latest_checkpointed_step.txt         (tracker, written last)

A step is committed when the tracker names it; the tracker is advanced
only after every shard's done file exists, so a crash mid-persist leaves
the previous step intact.

Format v2 (magic ``DLRTPUF2``): a 20-byte header (magic, meta length,
CRC-32 of the meta blob), the msgpack meta blob (``common/msgpack_lite``,
byte-equal to the reference's ``msgpack.packb``), then every tensor's
bytes; each tensor's meta carries the CRC-32 of its bytes.  v1 shards
(``DLRTPUF1``, no CRCs) stay readable.  A bf16 tensor is written as its
``uint16`` bits under the dtype name ``"bfloat16"``, as the reference
writes it, so each package reads the other's shards.  Every way a payload
can be damaged raises :class:`ShardCorruptionError`; a step that fails
verification is quarantined (renamed ``step_N.corrupt``).

The reference's chaos sites (``storage.corrupt_shard`` and the rest) and
its byte audit have no counterpart here yet; the agent-side saver's
cross-node barrier (``wait_sync_barrier``) comes with the multi-process
slice.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import time
import zlib
from typing import Dict, Iterable, Optional, Set, Tuple

import numpy as np
import torch

from dlrover_tpu_torch.common import msgpack_lite
from dlrover_tpu_torch.common.log import logger
from dlrover_tpu_torch.common.native import shm_lib
from dlrover_tpu_torch.common.storage import CheckpointStorage, drain_ranges
from dlrover_tpu_torch.common.tensor_bytes import (
    byte_view,
    dtype_key,
    from_bytes,
)

FORMAT_VERSION = 2
_MAGIC_V1 = b"DLRTPUF1"
_MAGIC = b"DLRTPUF2"
_V1_HEADER = 16  # magic u64 | meta_len u64
_V2_HEADER = 20  # magic u64 | meta_len u64 | meta_crc u32
TRACKER_FILE = "latest_checkpointed_step.txt"

# Below this size the ctypes round trip costs more than zlib's loop.
_NATIVE_CRC_MIN_BYTES = 1 << 20
#: Bytes per write and CRC chunk of the streamed writer.
STREAM_CHUNK_BYTES = 8 << 20
# Meta-read ceiling of the bounded readers: a bit-flipped meta length
# that still lands inside the file must not read gigabytes.
_VERIFY_META_CAP = 256 << 20
# Tensor CRCs are known only after the data pass, yet the meta that holds
# them precedes the data.  msgpack writes ints in their smallest form, so
# the placeholder 0xFFFFFFFF pins each CRC to the 5-byte uint32 form that
# every CRC >= 65536 takes; a smaller CRC (p ~1.5e-5 a tensor) makes the
# writer stream the data again at the corrected offset.
_CRC_PLACEHOLDER = 0xFFFFFFFF

QUARANTINE_SUFFIX = ".corrupt"
QUARANTINE_MARKER = ".quarantined"


class ShardCorruptionError(Exception):
    """A shard payload failed structural or CRC verification."""

    def __init__(self, reason: str, path: str = ""):
        self.reason = reason
        self.path = path
        super().__init__(f"{path}: {reason}" if path else reason)


def shard_version(data: bytes) -> Optional[int]:
    """Format version by magic (1 or 2), or ``None`` for foreign bytes."""
    magic = bytes(data[:8])
    if magic == _MAGIC:
        return 2
    if magic == _MAGIC_V1:
        return 1
    return None


_NATIVE_CRC_FASTER: Optional[bool] = None


def _native_crc_faster() -> bool:
    """Measured once: is the native ``shm_crc32`` faster than
    ``zlib.crc32`` on this host?  Both give CRC-32 of the zlib polynomial,
    so the choice is throughput only (best of 3 on 1 MB each)."""
    global _NATIVE_CRC_FASTER
    if _NATIVE_CRC_FASTER is None:
        lib = shm_lib()
        if lib is None:
            _NATIVE_CRC_FASTER = False
        else:
            probe = np.ones(1 << 20, dtype=np.uint8)
            lib.shm_crc32(probe.ctypes.data, probe.nbytes, 0)
            zlib.crc32(probe)
            t_native = t_zlib = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                lib.shm_crc32(probe.ctypes.data, probe.nbytes, 0)
                t_native = min(t_native, time.perf_counter() - t0)
                t0 = time.perf_counter()
                zlib.crc32(probe)
                t_zlib = min(t_zlib, time.perf_counter() - t0)
            _NATIVE_CRC_FASTER = t_native < t_zlib
    return _NATIVE_CRC_FASTER


def crc32_update(buf, crc: int = 0) -> int:
    """Fold a bytes-like buffer into a running CRC-32:
    ``crc32_update(b, crc32_update(a)) == crc32_bytes(a + b)``."""
    if len(buf) >= _NATIVE_CRC_MIN_BYTES and _native_crc_faster():
        arr = np.frombuffer(buf, dtype=np.uint8)
        return int(shm_lib().shm_crc32(arr.ctypes.data, arr.nbytes, crc))
    return zlib.crc32(buf, crc) & 0xFFFFFFFF


def crc32_bytes(buf) -> int:
    """CRC-32 (zlib polynomial) of a whole bytes-like buffer."""
    return crc32_update(buf, 0)


def step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:010d}")


def shard_path(ckpt_dir: str, step: int, process_id: int) -> str:
    return os.path.join(step_dir(ckpt_dir, step),
                        f"shard_{process_id:05d}.ckpt")


def done_path(ckpt_dir: str, step: int, process_id: int) -> str:
    return os.path.join(step_dir(ckpt_dir, step), f".done_{process_id:05d}")


def tracker_path(ckpt_dir: str) -> str:
    return os.path.join(ckpt_dir, TRACKER_FILE)


def _tensor_meta(t: torch.Tensor, offset: int, crc: int) -> dict:
    """One tensor's meta, fields in the reference's order."""
    return {"dtype": dtype_key(t.dtype), "shape": list(t.shape),
            "offset": offset, "nbytes": t.numel() * t.element_size(),
            "crc32": crc}


def _meta_blob(metas: dict, extra: dict) -> bytes:
    return msgpack_lite.packb(
        {"format": FORMAT_VERSION, "tensors": metas, "extra": extra})


def pack_shard(tensors: Dict[str, torch.Tensor], extra: dict,
               meta_extra: Optional[Dict[str, dict]] = None) -> bytes:
    """The whole v2 shard of CPU ``tensors`` and ``extra`` as bytes.
    ``meta_extra`` overlays per-tensor meta fields (the incremental
    persist's ``ref``, the sliced persist's ``slice``/``full_nbytes``)."""
    metas, blobs, offset = {}, [], 0
    for key, t in tensors.items():
        blob = byte_view(t).tobytes()
        metas[key] = _tensor_meta(t, offset, crc32_bytes(blob))
        if meta_extra and key in meta_extra:
            metas[key].update(meta_extra[key])
        blobs.append(blob)
        offset += len(blob)
    meta_blob = _meta_blob(metas, extra)
    header = _MAGIC + struct.pack("<QI", len(meta_blob),
                                  crc32_bytes(meta_blob))
    return header + meta_blob + b"".join(blobs)


def _parse_header(head: bytes, total_len: int, path: str = ""
                  ) -> Tuple[int, int, Optional[int], int]:
    """(version, meta_len, meta_crc, meta_base) of a file of
    ``total_len`` bytes from its first bytes."""
    if total_len < _V1_HEADER:
        raise ShardCorruptionError(
            f"file shorter than the shard header ({total_len} bytes)", path)
    magic = bytes(head[:8])
    if magic == _MAGIC:
        version = 2
        if total_len < _V2_HEADER:
            raise ShardCorruptionError("v2 header truncated", path)
        meta_len, meta_crc = struct.unpack("<QI", head[8:_V2_HEADER])
        base = _V2_HEADER
    elif magic == _MAGIC_V1:
        version = 1
        (meta_len,) = struct.unpack("<Q", head[8:_V1_HEADER])
        meta_crc = None
        base = _V1_HEADER
    else:
        raise ShardCorruptionError(
            f"bad magic {magic!r} — not a dlrover_tpu shard", path)
    if base + meta_len > total_len:
        raise ShardCorruptionError(
            f"meta region ({meta_len}B) extends past EOF "
            f"({total_len}B file)", path)
    return version, int(meta_len), meta_crc, base


def _decode_meta(meta_raw: bytes, meta_crc: Optional[int],
                 path: str = "") -> dict:
    if meta_crc is not None and crc32_bytes(meta_raw) != meta_crc:
        raise ShardCorruptionError("meta CRC mismatch", path)
    try:
        meta = msgpack_lite.unpackb(meta_raw)
    except (ValueError, TypeError) as e:
        raise ShardCorruptionError(f"meta blob undecodable: {e}", path) \
            from e
    if (not isinstance(meta, dict)
            or not isinstance(meta.get("tensors"), dict)
            or not isinstance(meta.get("extra"), dict)):
        raise ShardCorruptionError("meta structure invalid", path)
    return meta


def _parse_meta(data: bytes, path: str = "") -> Tuple[dict, int, int]:
    """(meta, data_base, version) of a whole in-memory shard."""
    version, meta_len, meta_crc, base = _parse_header(data, len(data), path)
    meta = _decode_meta(bytes(data[base:base + meta_len]), meta_crc, path)
    return meta, base + meta_len, version


def _blob_bounds(key: str, tm, limit: int, path: str = ""
                 ) -> Tuple[int, int]:
    """(offset, nbytes) of one tensor's blob, checked against ``limit``
    bytes of data region."""
    try:
        offset = int(tm["offset"])
        nbytes = int(tm["nbytes"])
    except (KeyError, TypeError, ValueError) as e:
        raise ShardCorruptionError(f"tensor {key!r} meta invalid: {e}",
                                   path) from e
    if offset < 0 or nbytes < 0 or offset + nbytes > limit:
        raise ShardCorruptionError(
            f"tensor {key!r} blob (offset={offset}, nbytes={nbytes}) "
            "truncated or out of bounds", path)
    return offset, nbytes


def _tensor_blob(data: bytes, base: int, key: str, tm, path: str):
    offset, nbytes = _blob_bounds(key, tm, len(data) - base, path)
    return memoryview(data)[base + offset:base + offset + nbytes]


def _check_tensor_crc(buf, key: str, tm, version: int, path: str) -> None:
    if version < 2:
        return  # v1 shards carry no CRCs
    want = tm.get("crc32")
    if not isinstance(want, int):
        raise ShardCorruptionError(f"tensor {key!r} missing crc32 in v2 meta",
                                   path)
    if crc32_bytes(buf) != want:
        raise ShardCorruptionError(
            f"tensor {key!r} CRC mismatch (bit rot or torn write)", path)


def _materialize_tensor(key: str, tm, blob: bytearray,
                        path: str) -> torch.Tensor:
    """One full tensor over ``blob`` (which the caller hands over)."""
    try:
        return from_bytes(blob, tm["dtype"], tm["shape"])
    except (KeyError, TypeError, ValueError) as e:
        raise ShardCorruptionError(f"tensor {key!r} undecodable: {e}",
                                   path) from e


def verify_shard(data: bytes, path: str = "") -> dict:
    """Header, meta CRC, every tensor's bounds and CRC; returns the
    shard's ``extra``.  Raises :class:`ShardCorruptionError`."""
    meta, base, version = _parse_meta(data, path)
    for key, tm in meta["tensors"].items():
        _check_tensor_crc(_tensor_blob(data, base, key, tm, path), key, tm,
                          version, path)
    return meta["extra"]


def _read_file_meta(f, path: str = "") -> Tuple[dict, int, int, int]:
    """(meta, version, file_size, data_base) of a seekable shard file,
    without reading its data region."""
    f.seek(0, os.SEEK_END)
    size = f.tell()
    f.seek(0)
    version, meta_len, meta_crc, base = _parse_header(
        f.read(min(size, _V2_HEADER)), size, path)
    if meta_len > _VERIFY_META_CAP:
        raise ShardCorruptionError(
            f"meta region ({meta_len}B) implausibly large "
            f"(cap {_VERIFY_META_CAP}B) — header corrupt", path)
    f.seek(base)
    meta = _decode_meta(f.read(meta_len), meta_crc, path)
    return meta, version, size, base + meta_len


def verify_shard_file(f, path: str = "",
                      chunk_bytes: int = STREAM_CHUNK_BYTES
                      ) -> Tuple[dict, int]:
    """:func:`verify_shard` over a seekable file in bounded chunks;
    returns ``(extra, format_version)``."""
    meta, version, size, data_base = _read_file_meta(f, path)
    items = sorted(
        meta["tensors"].items(),
        key=lambda kv: kv[1].get("offset", 0)
        if isinstance(kv[1], dict) and isinstance(kv[1].get("offset"), int)
        else 0,
    )
    for key, tm in items:
        offset, nbytes = _blob_bounds(key, tm, size - data_base, path)
        if version < 2:
            continue
        want = tm.get("crc32")
        if not isinstance(want, int):
            raise ShardCorruptionError(
                f"tensor {key!r} missing crc32 in v2 meta", path)
        f.seek(data_base + offset)
        crc, remaining = 0, nbytes
        while remaining > 0:
            chunk = f.read(min(chunk_bytes, remaining))
            if not chunk:
                raise ShardCorruptionError(
                    f"tensor {key!r} blob (offset={offset}, "
                    f"nbytes={nbytes}) truncated or out of bounds", path)
            crc = crc32_update(chunk, crc)
            remaining -= len(chunk)
        if crc != want:
            raise ShardCorruptionError(
                f"tensor {key!r} CRC mismatch (bit rot or torn write)", path)
    return meta["extra"], version


def unpack_shard(data: bytes, path: str = ""
                 ) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Decode and verify a whole shard payload; ``path`` labels errors."""
    meta, base, version = _parse_meta(data, path)
    tensors = {}
    for key, tm in meta["tensors"].items():
        if tm.get("slice") is not None or isinstance(tm.get("ref"), dict):
            raise ShardCorruptionError(
                f"tensor {key!r} is a sliced/incremental entry; decode "
                "via read_shard_pieces", path)
        buf = _tensor_blob(data, base, key, tm, path)
        _check_tensor_crc(buf, key, tm, version, path)
        tensors[key] = _materialize_tensor(key, tm, bytearray(buf), path)
    return tensors, meta["extra"]


def validate_staged_state(tensors, extra, *,
                          expect_process_id: Optional[int] = None,
                          expect_num_processes: Optional[int] = None
                          ) -> Optional[str]:
    """Why a staged state must not be persisted, or ``None``."""
    if not isinstance(tensors, dict) or not tensors:
        return "no tensors staged"
    if not isinstance(extra, dict):
        return "extra metadata missing"
    try:
        step = int(extra.get("step"))
    except (TypeError, ValueError):
        return f"staged step {extra.get('step')!r} is not an int"
    if step < 0:
        return f"staged step {step} is negative"
    if not extra.get("tensors_info"):
        return "tensors_info missing (state could never be reassembled)"
    pid = extra.get("process_id")
    if (expect_process_id is not None and pid is not None
            and int(pid) != int(expect_process_id)):
        return f"staged process_id {pid} != expected {expect_process_id}"
    world = extra.get("num_processes")
    if (expect_num_processes is not None and world is not None
            and int(world) != int(expect_num_processes)):
        return (f"staged num_processes {world} != expected "
                f"{expect_num_processes}")
    return None


def write_shard(storage: CheckpointStorage, ckpt_dir: str, step: int,
                process_id: int, tensors: Dict[str, torch.Tensor],
                extra: dict,
                meta_extra: Optional[Dict[str, dict]] = None) -> None:
    """Pack-then-write persist, and the shard's done vote."""
    storage.safe_makedirs(step_dir(ckpt_dir, step))
    storage.write(pack_shard(tensors, extra, meta_extra),
                  shard_path(ckpt_dir, step, process_id))
    storage.write(str(time.time()), done_path(ckpt_dir, step, process_id))


class ShardStreamWriter:
    """Single-pass v2 shard writer: streams each tensor's bytes straight
    from the caller's CPU tensors (typically views of the shm arena) in
    ``chunk_bytes`` chunks, folds each tensor's CRC-32 in the same pass,
    and patches the header and meta in place afterwards.  The file is
    byte-identical to ``pack_shard(tensors, extra)``.  ``workers > 1``
    drains byte-balanced tensor ranges concurrently (pwrite).

    The caller keeps the tensors' memory mapped and unwritten for the
    duration of :meth:`write`."""

    def __init__(self, storage: CheckpointStorage, path: str,
                 tensors: Dict[str, torch.Tensor], extra: dict, *,
                 workers: int = 1, chunk_bytes: int = STREAM_CHUNK_BYTES,
                 meta_extra: Optional[Dict[str, dict]] = None):
        self._storage = storage
        self._path = path
        self._tensors = tensors
        self._extra = extra
        self._workers = max(1, int(workers))
        self._chunk = max(1 << 16, int(chunk_bytes))
        self._meta_extra = meta_extra or {}
        self._crcs: Dict[str, int] = {}
        self._stats: dict = {}

    def _layout(self):
        """(placeholder metas, [(key, byte view, offset)], data bytes) in
        :func:`pack_shard`'s field order and offsets."""
        metas: Dict[str, dict] = {}
        views = []
        offset = 0
        for key, t in self._tensors.items():
            view = memoryview(byte_view(t))
            # An empty blob's CRC is exactly 0: pin it now.
            metas[key] = _tensor_meta(t, offset,
                                      _CRC_PLACEHOLDER if len(view) else 0)
            if key in self._meta_extra:
                metas[key].update(self._meta_extra[key])
            views.append((key, view, offset))
            offset += len(view)
        return metas, views, offset

    def _partition(self, views, n: int):
        """Contiguous byte-balanced groups, one per range worker."""
        if n <= 1 or len(views) <= 1:
            return [views] if views else []
        total = sum(len(v) for _, v, _ in views)
        target = max(1, total // n)
        groups, cur, cur_bytes = [], [], 0
        for item in views:
            cur.append(item)
            cur_bytes += len(item[1])
            if cur_bytes >= target and len(groups) < n - 1:
                groups.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            groups.append(cur)
        return groups

    def _gen(self, group):
        """One group's bytes in bounded chunks, each tensor's CRC folded as
        a side effect of the traversal."""
        for key, view, _ in group:
            crc = 0
            for lo in range(0, len(view), self._chunk):
                chunk = view[lo:lo + self._chunk]
                crc = crc32_update(chunk, crc)
                yield chunk
            self._crcs[key] = crc

    def _ranges(self, groups, base: int):
        return [(base + g[0][2], self._gen(g)) for g in groups if g]

    def write(self) -> dict:
        """Write the file; returns ``{"data_bytes", "tensors", "workers",
        "passes", "total_bytes", "crcs"}``."""
        metas, views, data_bytes = self._layout()
        meta_ph = _meta_blob(metas, self._extra)
        base = _V2_HEADER + len(meta_ph)
        groups = self._partition(views, self._workers)
        self._stats = {"data_bytes": data_bytes, "tensors": len(views),
                       "workers": min(self._workers, max(1, len(groups))),
                       "passes": 1}

        def _finalize(sink):
            nonlocal base
            # dict(m, ...) keeps the key order: the same bytes as
            # pack_shard's meta.
            real = {k: dict(m, crc32=self._crcs.get(k, 0))
                    for k, m in metas.items()}
            meta_blob = _meta_blob(real, self._extra)
            if len(meta_blob) != len(meta_ph):
                base = _V2_HEADER + len(meta_blob)
                self._stats["passes"] += 1
                drain_ranges(sink, self._ranges(groups, base),
                             self._workers)
                sink.truncate(base + data_bytes)
            sink.write_at(_MAGIC + struct.pack(
                "<QI", len(meta_blob), crc32_bytes(meta_blob)), 0)
            sink.write_at(meta_blob, _V2_HEADER)
            self._stats["total_bytes"] = base + data_bytes

        self._storage.write_shard_ranges(
            self._path, base + data_bytes, self._ranges(groups, base),
            workers=self._workers, finalize=_finalize)
        self._stats["crcs"] = dict(self._crcs)
        return dict(self._stats)


def write_shard_from_views(storage: CheckpointStorage, ckpt_dir: str,
                           step: int, process_id: int,
                           tensors: Dict[str, torch.Tensor], extra: dict, *,
                           workers: int = 1,
                           chunk_bytes: int = STREAM_CHUNK_BYTES,
                           meta_extra: Optional[Dict[str, dict]] = None
                           ) -> dict:
    """Streamed counterpart of :func:`write_shard`: the same file bytes and
    done vote; returns the writer's stats."""
    storage.safe_makedirs(step_dir(ckpt_dir, step))
    stats = ShardStreamWriter(
        storage, shard_path(ckpt_dir, step, process_id), tensors, extra,
        workers=workers, chunk_bytes=chunk_bytes, meta_extra=meta_extra,
    ).write()
    storage.write(str(time.time()), done_path(ckpt_dir, step, process_id))
    return stats


@dataclasses.dataclass
class ShardManifest:
    """One shard's verified header and meta, read without its data."""

    meta: dict
    version: int
    size: int
    data_base: int
    path: str

    @property
    def tensors(self) -> dict:
        return self.meta["tensors"]

    @property
    def extra(self) -> dict:
        return self.meta["extra"]


def read_shard_manifest(storage: CheckpointStorage, ckpt_dir: str,
                        step: int, process_id: int
                        ) -> Optional[ShardManifest]:
    """Meta-only read of one shard; ``None`` when absent."""
    path = shard_path(ckpt_dir, step, process_id)
    f = storage.open_read(path)
    if f is None:
        return None
    try:
        meta, version, size, data_base = _read_file_meta(f, path)
        return ShardManifest(meta, version, size, data_base, path)
    finally:
        f.close()


def read_shard_meta(storage: CheckpointStorage, ckpt_dir: str, step: int,
                    process_id: int) -> Optional[dict]:
    """The ``extra`` of one shard without its data; ``None`` when
    absent."""
    man = read_shard_manifest(storage, ckpt_dir, step, process_id)
    return None if man is None else man.extra


def _read_blob_at(f, man: ShardManifest, key: str, tm) -> bytearray:
    """Read and CRC-verify one tensor's blob from an open shard file."""
    offset, nbytes = _blob_bounds(key, tm, man.size - man.data_base,
                                  man.path)
    f.seek(man.data_base + offset)
    blob = bytearray(nbytes)
    got = f.readinto(blob) if nbytes else 0
    if got != nbytes:
        raise ShardCorruptionError(
            f"tensor {key!r} blob (offset={offset}, nbytes={nbytes}) "
            "truncated or out of bounds", man.path)
    _check_tensor_crc(blob, key, tm, man.version, man.path)
    return blob


def _read_ref_blob(storage: CheckpointStorage, ckpt_dir: str,
                   process_id: int, key: str, tm,
                   man_cache: Dict[int, ShardManifest],
                   depth: int = 0) -> bytearray:
    """Resolve an incremental save's reference: the bytes live in an older
    step's shard of the same process and key.  Any break in the chain is
    corruption of this shard."""
    if depth > 8:
        raise ShardCorruptionError(
            f"tensor {key!r} ref chain exceeds depth 8 (cycle?)")
    ref = tm["ref"]
    try:
        ref_step = int(ref["step"])
        ref_crc = int(ref["crc32"])
        ref_nbytes = int(ref["nbytes"])
    except (KeyError, TypeError, ValueError) as e:
        raise ShardCorruptionError(f"tensor {key!r} ref meta invalid: {e}") \
            from e
    man = man_cache.get(ref_step)
    if man is None:
        man = read_shard_manifest(storage, ckpt_dir, ref_step, process_id)
        if man is None:
            raise ShardCorruptionError(
                f"tensor {key!r} references step {ref_step} whose shard "
                "is missing (GC'd or lost)")
        man_cache[ref_step] = man
    tm2 = man.tensors.get(key)
    if tm2 is None:
        raise ShardCorruptionError(
            f"tensor {key!r} missing from referenced step {ref_step}",
            man.path)
    if tm2.get("slice") != tm.get("slice"):
        raise ShardCorruptionError(
            f"tensor {key!r} slice bounds changed across the ref chain "
            f"({tm.get('slice')} vs {tm2.get('slice')})", man.path)
    if isinstance(tm2.get("ref"), dict):
        return _read_ref_blob(storage, ckpt_dir, process_id, key, tm2,
                              man_cache, depth + 1)
    if (int(tm2.get("nbytes", -1)) != ref_nbytes
            or int(tm2.get("crc32", -1)) != ref_crc):
        raise ShardCorruptionError(
            f"tensor {key!r} referenced bytes in step {ref_step} do not "
            "match the reference (rewritten or damaged)", man.path)
    f = storage.open_read(man.path)
    if f is None:
        raise ShardCorruptionError(
            f"tensor {key!r} referenced shard unreadable", man.path)
    try:
        return _read_blob_at(f, man, key, tm2)
    finally:
        f.close()


def read_shard_pieces(storage: CheckpointStorage, ckpt_dir: str, step: int,
                      process_id: int, *,
                      manifest: Optional[ShardManifest] = None,
                      keys: Optional[Set[str]] = None
                      ) -> Optional[Tuple[Dict[str, torch.Tensor],
                                          Dict[str, dict], dict]]:
    """Read and verify one shard's pieces, resolving incremental refs:
    ``(tensors, slices, extra)``.  Full entries come back as tensors,
    sliced ones as flat ``uint8`` payloads with their meta in ``slices``.
    ``None`` when absent; raises :class:`ShardCorruptionError`."""
    man = manifest or read_shard_manifest(storage, ckpt_dir, step,
                                          process_id)
    if man is None:
        return None
    f = storage.open_read(man.path)
    if f is None:
        return None
    man_cache: Dict[int, ShardManifest] = {}
    tensors: Dict[str, torch.Tensor] = {}
    slices: Dict[str, dict] = {}
    try:
        for key, tm in man.tensors.items():
            if keys is not None and key not in keys:
                continue
            if isinstance(tm.get("ref"), dict):
                blob = _read_ref_blob(storage, ckpt_dir, process_id, key,
                                      tm, man_cache)
            else:
                blob = _read_blob_at(f, man, key, tm)
            if tm.get("slice") is not None:
                tensors[key] = from_bytes(blob, "uint8", [len(blob)])
                slices[key] = tm
            else:
                tensors[key] = _materialize_tensor(key, tm, blob, man.path)
    finally:
        f.close()
    return tensors, slices, man.extra


def read_shard(storage: CheckpointStorage, ckpt_dir: str, step: int,
               process_id: int
               ) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
    """Read and verify one complete shard (refs resolved; a shard of
    cross-replica slices raises ``ValueError``).  ``None`` when absent."""
    got = read_shard_pieces(storage, ckpt_dir, step, process_id)
    if got is None:
        return None
    tensors, slices, extra = got
    if slices:
        raise ValueError(
            f"shard (step {step}, proc {process_id}) holds cross-replica "
            "slices; assemble via read_shard_pieces")
    return tensors, extra


def list_shard_ids(storage: CheckpointStorage, ckpt_dir: str,
                   step: int) -> list:
    out = []
    for name in storage.listdir(step_dir(ckpt_dir, step)):
        if name.startswith("shard_") and name.endswith(".ckpt"):
            out.append(int(name[len("shard_"):-len(".ckpt")]))
    return sorted(out)


def all_shards_done(storage: CheckpointStorage, ckpt_dir: str, step: int,
                    world_size: int) -> bool:
    return all(storage.exists(done_path(ckpt_dir, step, pid))
               for pid in range(world_size))


def resolve_keep_last(max_to_keep) -> int:
    """``None`` -> keep 3, ``0`` -> keep every step, ``N > 0`` -> the
    newest N."""
    return 3 if max_to_keep is None else int(max_to_keep)


def commit(storage: CheckpointStorage, ckpt_dir: str, step: int,
           keep_last: int = 3) -> None:
    """Advance the tracker (the atomic commit point) and rotate old step
    dirs.  Quarantined dirs neither count nor go; a step an incremental
    step still references is kept."""
    storage.write(str(step), tracker_path(ckpt_dir))
    logger.info("checkpoint step %d committed at %s", step, ckpt_dir)
    steps = list_steps(storage, ckpt_dir)
    doomed = sorted(steps)[:-keep_last] if keep_last > 0 else []
    if not doomed:
        return
    retained = [s for s in steps if s not in set(doomed)] + [step]
    try:
        protected = referenced_steps(storage, ckpt_dir, retained)
    except (OSError, ValueError) as e:
        # Keeping a step too long is safe where deleting a holder is not.
        logger.warning("rotation ref scan failed (keeping all): %s", e)
        protected = set(steps)
    for old in doomed:
        if old == step:
            continue
        if old in protected:
            logger.info("rotation: keeping step %d (referenced by a newer "
                        "incremental step)", old)
            continue
        storage.safe_rmtree(step_dir(ckpt_dir, old))


def referenced_steps(storage: CheckpointStorage, ckpt_dir: str,
                     roots: Iterable[int]) -> Set[int]:
    """Steps the shards of ``roots`` reference, transitively."""
    seen: Set[int] = set(int(s) for s in roots)
    frontier = list(seen)
    out: Set[int] = set()
    while frontier:
        s = frontier.pop()
        for pid in list_shard_ids(storage, ckpt_dir, s):
            try:
                extra = read_shard_meta(storage, ckpt_dir, s, pid)
            except ShardCorruptionError:
                continue
            for r in (extra or {}).get("ref_steps") or []:
                r = int(r)
                out.add(r)
                if r not in seen:
                    seen.add(r)
                    frontier.append(r)
    return out


def is_step_quarantined(storage: CheckpointStorage, ckpt_dir: str,
                        step: int) -> bool:
    return storage.exists(os.path.join(step_dir(ckpt_dir, step),
                                       QUARANTINE_MARKER))


def quarantine_step(storage: CheckpointStorage, ckpt_dir: str,
                    step: int) -> Optional[str]:
    """Rename ``step_N`` to ``step_N.corrupt`` (a marker file where the
    backend cannot rename), out of every restore path and rotation but
    kept for fsck.  Returns the path, or ``None`` when the dir is gone."""
    src = step_dir(ckpt_dir, step)
    if not storage.exists(src):
        return None
    dst = src + QUARANTINE_SUFFIX
    if storage.rename_dir(src, dst):
        logger.warning("checkpoint step %d quarantined -> %s", step, dst)
        return dst
    try:
        storage.write(str(time.time()), os.path.join(src, QUARANTINE_MARKER))
    except OSError as e:
        logger.warning("quarantine of step %d failed: %s", step, e)
        return None
    logger.warning("checkpoint step %d quarantined in place (marker file)",
                   step)
    return src


def list_steps(storage: CheckpointStorage, ckpt_dir: str) -> list:
    """Every live step dir's step (committed or not), quarantined ones
    left out."""
    steps = []
    for name in storage.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(QUARANTINE_SUFFIX):
            continue
        try:
            step = int(name[len("step_"):])
        except ValueError:
            continue
        if is_step_quarantined(storage, ckpt_dir, step):
            continue
        steps.append(step)
    return steps


def list_quarantined(storage: CheckpointStorage, ckpt_dir: str) -> list:
    """(step, dirpath) of every quarantined step dir, either form."""
    out = []
    for name in storage.listdir(ckpt_dir):
        if not name.startswith("step_"):
            continue
        if name.endswith(QUARANTINE_SUFFIX):
            try:
                step = int(name[len("step_"):-len(QUARANTINE_SUFFIX)])
            except ValueError:
                continue
            out.append((step, os.path.join(ckpt_dir, name)))
        else:
            try:
                step = int(name[len("step_"):])
            except ValueError:
                continue
            if is_step_quarantined(storage, ckpt_dir, step):
                out.append((step, os.path.join(ckpt_dir, name)))
    return sorted(out)


def latest_step(storage: CheckpointStorage, ckpt_dir: str) -> Optional[int]:
    """The committed step the tracker names, or ``None``."""
    content = storage.read(tracker_path(ckpt_dir), mode="r")
    if not content:
        return None
    try:
        return int(str(content).strip())
    except ValueError:
        return None
