"""The subset of msgpack that the port's files need, with no msgpack
installed: nil, bool, int, float, str, bin, array and map.

:func:`packb` emits what ``msgpack.packb(obj, use_bin_type=True)`` emits
for the same object: the shortest form of each int and length, a Python
float as a float64 (``0xcb``), tuples as arrays, map keys in insertion
order. :class:`Reader` decodes a stream one value (or one header) at a
time, so that a large document is read without loading it whole; it also
reads float32 (``0xca``). Graph files (``core/graph.py``) and checkpoints
(``train/checkpoint.py``) are written and read with it.
"""
from __future__ import annotations

import struct


def _head(n: int, small_base, small_max, codes) -> bytes:
    """The header of a container or string of length ``n``: a fix type
    below ``small_max``, else the first of ``codes`` ((code, struct
    format, limit), ...) that holds ``n``."""
    if small_base is not None and n < small_max:
        return bytes([small_base | n])
    for code, fmt, limit in codes:
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def array_head(n: int) -> bytes:
    return _head(n, 0x90, 16, ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)))


def map_head(n: int) -> bytes:
    return _head(n, 0x80, 16, ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)))


def pack_str(s: str) -> bytes:
    b = s.encode()
    return _head(len(b), 0xa0, 32, ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16),
                                    (0xdb, ">I", 1 << 32))) + b


def bin_head(n: int) -> bytes:
    return _head(n, None, 0, ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
                              (0xc6, ">I", 1 << 32)))


def pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                 (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                             (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
        if v >= -limit:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: int {v} out of range")


def packb(obj) -> bytes:
    """``obj`` (None, bool, int, float, str, bytes, lists, tuples and
    dicts of them) as ``msgpack.packb(obj, use_bin_type=True)`` packs it."""
    out = []
    _pack(obj, out.append)
    return b"".join(out)


def _pack(obj, put) -> None:
    if obj is None:
        put(b"\xc0")
    elif obj is True or obj is False:
        put(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        put(pack_int(obj))
    elif isinstance(obj, float):
        put(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        put(pack_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        put(bin_head(len(b)))
        put(b)
    elif isinstance(obj, (list, tuple)):
        put(array_head(len(obj)))
        for v in obj:
            _pack(v, put)
    elif isinstance(obj, dict):
        put(map_head(len(obj)))
        for k, v in obj.items():
            _pack(k, put)
            _pack(v, put)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


class Reader:
    """Reads the subset from a binary file, a value or a header at a
    time."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
              0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    _FLOAT = {0xca: ">f", 0xcb: ">d"}
    _LEN = {0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xd9: ">B",
            0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}
    _KIND = {0xdc: "array", 0xdd: "array", 0xde: "map", 0xdf: "map",
             0xd9: "str", 0xda: "str", 0xdb: "str", 0xc4: "bin",
             0xc5: "bin", 0xc6: "bin"}

    def __init__(self, f):
        self.f = f

    def _read(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("msgpack: truncated document")
        return b

    def _unpack(self, fmt):
        return struct.unpack(fmt, self._read(struct.calcsize(fmt)))[0]

    def head(self):
        """(kind, value): ("nil", None), ("bool", b), ("int", v),
        ("float", v), or ("array" | "map" | "str" | "bin", length)."""
        c = self._read(1)[0]
        if c < 0x80:
            return "int", c
        if c >= 0xe0:
            return "int", c - 0x100
        if c & 0xf0 == 0x90:
            return "array", c & 0x0f
        if c & 0xf0 == 0x80:
            return "map", c & 0x0f
        if c & 0xe0 == 0xa0:
            return "str", c & 0x1f
        if c == 0xc0:
            return "nil", None
        if c in (0xc2, 0xc3):
            return "bool", c == 0xc3
        if c in self._FIXED:
            return "int", self._unpack(self._FIXED[c])
        if c in self._FLOAT:
            return "float", self._unpack(self._FLOAT[c])
        if c not in self._KIND:
            raise ValueError(f"msgpack: type byte 0x{c:02x} is outside the "
                             "subset")
        return self._KIND[c], self._unpack(self._LEN[c])

    def value(self):
        """One whole value (a ``bin`` as bytes)."""
        kind, n = self.head()
        if kind in ("nil", "bool", "int", "float"):
            return n
        if kind == "str":
            return self._read(n).decode()
        if kind == "bin":
            return self._read(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        return {self.value(): self.value() for _ in range(n)}

