"""A msgpack encoder and decoder for the types the checkpoint metadata
carries — the port's own, so that it needs no ``msgpack`` package.

The shard file's meta blob and the shm arena's header region are msgpack
in the reference (``dlrover_tpu/checkpoint/shard_file.py`` ``pack_shard``,
``_decode_meta``; ``dlrover_tpu/common/shm.py`` ``write_state``,
``metadata``).  The meta blob's bytes are covered by a CRC-32 and set the
data region's offset, so :func:`packb` must give exactly the bytes of
``msgpack.packb(obj, use_bin_type=True)``: msgpack's smallest format for
every value (fixint / fixstr / fixarray / fixmap, then the 8-, 16-, 32- and
64-bit forms), float64 for every float, big-endian widths.
:func:`unpackb` returns what ``msgpack.unpackb(data, raw=False)`` returns:
dicts, lists, str, bytes, int, float, bool and None; map keys must be str
or bytes (msgpack's ``strict_map_key``).  Any malformed input raises
``ValueError``.

Types: ``dict``, ``list``/``tuple``, ``str``, ``bytes``/``bytearray``/
``memoryview``, ``int`` (-2**63 .. 2**64 - 1), ``float``, ``bool`` and
``None``.  Anything else raises ``TypeError``.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

__all__ = ["packb", "unpackb"]


def _pack_int(v: int, out: List[bytes]) -> None:
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"int {v} too small for msgpack")
                out.append(b"\xd3" + struct.pack(">q", v))
            else:
                out.append(b"\xd2" + struct.pack(">i", v))
        elif v < -(1 << 7):
            out.append(b"\xd1" + struct.pack(">h", v))
        else:
            out.append(b"\xd0" + struct.pack(">b", v))
    elif v < (1 << 7):
        out.append(struct.pack(">b", v))  # positive and negative fixint
    elif v < (1 << 16):
        if v < (1 << 8):
            out.append(b"\xcc" + struct.pack(">B", v))
        else:
            out.append(b"\xcd" + struct.pack(">H", v))
    elif v < (1 << 32):
        out.append(b"\xce" + struct.pack(">I", v))
    elif v < (1 << 64):
        out.append(b"\xcf" + struct.pack(">Q", v))
    else:
        raise OverflowError(f"int {v} too big for msgpack")


def _pack_len(n: int, fix: int, fix_max: int, codes: Tuple[int, ...],
              out: List[bytes]) -> None:
    """Header of a str/bin/array/map of ``n`` entries: a fix form when
    ``fix`` is given and ``n <= fix_max``, else the smallest of the
    8/16/32-bit forms whose code ``codes`` lists (``0`` = no such form)."""
    if fix >= 0 and n <= fix_max:
        out.append(bytes([fix | n]))
        return
    c8, c16, c32 = codes
    if c8 and n < (1 << 8):
        out.append(bytes([c8, n]))
    elif n < (1 << 16):
        out.append(bytes([c16]) + struct.pack(">H", n))
    elif n < (1 << 32):
        out.append(bytes([c32]) + struct.pack(">I", n))
    else:
        raise ValueError(f"msgpack object too large ({n})")


def _pack(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _pack_len(len(raw), -1, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (0, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (0, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)``."""
    out: List[bytes] = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("msgpack data truncated")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# code -> struct format of the fixed-width scalars
_SCALARS = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
# code -> (kind, struct format of the length)
_SIZED = {
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def _unpack(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code <= 0x7F:
        return code
    if code >= 0xE0:
        return code - 0x100
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code == 0xC0:
        return None
    elif code == 0xC2:
        return False
    elif code == 0xC3:
        return True
    elif code in _SCALARS:
        return r.unpack(_SCALARS[code])
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"unsupported msgpack code 0x{code:02x}")
    if kind == "str":
        try:
            return str(r.take(n), "utf-8")
        except UnicodeDecodeError as e:
            raise ValueError(f"msgpack str is not utf-8: {e}") from e
    if kind == "bin":
        return bytes(r.take(n))
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        out[k] = _unpack(r)
    return out


def unpackb(data) -> Any:
    """``msgpack.unpackb(data, raw=False)``: exactly one object, no
    trailing bytes."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(
            f"msgpack: {len(r.buf) - r.pos} extra bytes after the object")
    return obj
