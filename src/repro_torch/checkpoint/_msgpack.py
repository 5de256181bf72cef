"""The part of MessagePack that a checkpoint manifest uses.

The JAX package writes ``manifest.msgpack`` with ``msgpack.packb`` and
reads it with ``msgpack.unpackb``; the port reads and writes the same
bytes without that package:

- :func:`packb` is byte for byte ``msgpack.packb`` with its defaults
  (``use_bin_type=True``, float64, the smallest integer form): nil,
  bool, int (positive and negative fixint, uint/int 8–64), float, str
  (fixstr/8/16/32), bytes (bin 8/16/32), list and tuple as an array,
  dict as a map in insertion order.  Anything else raises ``TypeError``;
  an integer outside ``[-2**63, 2**64)`` raises ``OverflowError``, as
  ``msgpack.packb`` does.
- :func:`unpackb` equals ``msgpack.unpackb`` with its defaults (arrays
  as lists, ``raw=False``, map keys ``str`` or ``bytes``) on the same
  types, and reads float32 too.  A type byte outside this subset
  (extension types, timestamps), a truncated buffer or bytes left over
  raise ``ValueError``.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]


def _pack_len(out: bytearray, n: int, fix: int | None, fix_max: int,
              codes: tuple[int, int, int]) -> None:
    """A length header: the fix form below ``fix_max``, else 8/16/32-bit
    (``codes``; a code of ``0`` means the format has no such width)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += struct.pack(">BB", codes[0], n)
    elif n < 1 << 16:
        out += struct.pack(">BH", codes[1], n)
    elif n < 1 << 32:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise ValueError(f"msgpack length {n} exceeds 2**32 - 1")


def _pack_int(out: bytearray, v: int) -> None:
    if v >= 0:
        if v < 0x80:
            out.append(v)
        elif v < 1 << 8:
            out += struct.pack(">BB", 0xCC, v)
        elif v < 1 << 16:
            out += struct.pack(">BH", 0xCD, v)
        elif v < 1 << 32:
            out += struct.pack(">BI", 0xCE, v)
        elif v < 1 << 64:
            out += struct.pack(">BQ", 0xCF, v)
        else:
            raise OverflowError("Integer value out of range")
    elif v >= -32:
        out.append(v & 0xFF)
    elif v >= -(1 << 7):
        out += struct.pack(">Bb", 0xD0, v)
    elif v >= -(1 << 15):
        out += struct.pack(">Bh", 0xD1, v)
    elif v >= -(1 << 31):
        out += struct.pack(">Bi", 0xD2, v)
    elif v >= -(1 << 63):
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int) and not isinstance(obj, bool):
        _pack_int(out, int(obj))
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 16, (0, 0xDC, 0xDD))
        for item in obj:
            _pack(out, item)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 16, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``obj`` → MessagePack bytes, as ``msgpack.packb(obj)`` writes them."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        chunk = self.buf[self.pos:end]
        self.pos = end
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            if not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for "
                                 f"map key")
            out[k] = self.obj()
        return out

    def obj(self):
        b = self.take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        scalar = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                  0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                  0xD2: ">i", 0xD3: ">q"}
        if b in scalar:
            return self.unpack(scalar[b])
        sized = {0xC4: (">B", self.take), 0xC5: (">H", self.take),
                 0xC6: (">I", self.take), 0xD9: (">B", self.str),
                 0xDA: (">H", self.str), 0xDB: (">I", self.str),
                 0xDC: (">H", self.array), 0xDD: (">I", self.array),
                 0xDE: (">H", self.map), 0xDF: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the "
                         f"manifest subset")


def unpackb(data: bytes):
    """MessagePack bytes → Python objects, as ``msgpack.unpackb(data)``
    returns them (arrays as lists, str as ``str``, bin as ``bytes``)."""
    reader = _Reader(bytes(data))
    obj = reader.obj()
    if reader.pos != len(reader.buf):
        raise ValueError("unpackb received extra data")
    return obj
