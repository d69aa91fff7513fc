"""Checkpointing (the port of ``repro.train.checkpoint``): a tree of tensors
as a msgpack array of ``{"key", "dtype", "shape", "data"}`` maps, written
atomically, one file a step in a directory.

The document is the reference's, byte for byte: leaves in the order
``jax.tree_util`` flattens them (dict keys sorted, list entries in order),
keys their paths joined by ``/`` (``params/layers/0/mixer/wq``), dtypes by
numpy's names (``"bfloat16"`` too, its bytes those of ``uint16``), data the
leaf's raw little-endian bytes in C order. So each package reads the
other's files.

msgpack is not a dependency: the module carries an encoder and a decoder
for the subset the document needs (array, map, str, bin, int), written to
emit what ``msgpack.packb(doc, use_bin_type=True)`` emits. Both stream:
:func:`save` writes one leaf at a time and :func:`restore` reads one at a
time, so a state larger than host memory can be saved and restored.
"""
from __future__ import annotations

import os
import struct
import tempfile

import torch

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _DTYPES.items()}


# -- the msgpack subset --------------------------------------------------------

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


def _array(n):
    return _head(n, 0x90, 16, ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)))


def _map(n):
    return _head(n, 0x80, 16, ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)))


def _str(s: str) -> bytes:
    b = s.encode()
    return _head(len(b), 0xa0, 32, ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16),
                                    (0xdb, ">I", 1 << 32))) + b


def _bin_head(n: int) -> bytes:
    return _head(n, None, 0, ((0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16),
                              (0xc6, ">I", 1 << 32)))


def _int(v: int) -> bytes:
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


class _Reader:
    """Reads the subset from a binary file."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
              0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    _LEN = {0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I", 0xd9: ">B",
            0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}

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
        """(kind, value): ("int", v), or ("array" | "map" | "str" | "bin",
        length)."""
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
        if c in self._FIXED:
            return "int", self._unpack(self._FIXED[c])
        kind = {0xdc: "array", 0xdd: "array", 0xde: "map", 0xdf: "map",
                0xd9: "str", 0xda: "str", 0xdb: "str", 0xc4: "bin",
                0xc5: "bin", 0xc6: "bin"}.get(c)
        if kind is None:
            raise ValueError(f"msgpack: type byte 0x{c:02x} is outside the "
                             "checkpoint subset")
        return kind, self._unpack(self._LEN[c])

    def value(self):
        """One whole value (a ``bin`` as bytes)."""
        kind, n = self.head()
        if kind == "int":
            return n
        if kind == "str":
            return self._read(n).decode()
        if kind == "bin":
            return self._read(n)
        if kind == "array":
            return [self.value() for _ in range(n)]
        return {self.value(): self.value() for _ in range(n)}


# -- trees ----------------------------------------------------------------------

def _flatten(tree, prefix=()):
    """(path, leaf) pairs in ``jax.tree_util``'s order: dict keys sorted,
    list entries in order; a ``Model`` is its tree."""
    tree = _as_tree(tree)
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _as_tree(tree):
    return tree.tree() if hasattr(tree, "tree") else tree


def _leaf_bytes(t: torch.Tensor) -> memoryview:
    t = torch.as_tensor(t).detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def save(tree, path: str) -> None:
    """Write ``tree`` (dicts, lists, tensors; a ``Model`` is its tree) to
    ``path`` through a temporary file in the same directory, then
    ``os.replace``. Leaves are copied to the host one at a time."""
    items = list(_flatten(tree))
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(_array(len(items)))
            for key, leaf in items:
                t = torch.as_tensor(leaf)
                if t.dtype not in _DTYPES:
                    raise TypeError(f"{key}: dtype {t.dtype} not supported")
                data = _leaf_bytes(t)
                f.write(_map(4) + _str("key") + _str(key) + _str("dtype")
                        + _str(_DTYPES[t.dtype]) + _str("shape")
                        + _array(t.dim())
                        + b"".join(_int(int(s)) for s in t.shape)
                        + _str("data") + _bin_head(data.nbytes))
                f.write(data)
                del data
        os.replace(tmp, path)  # atomic
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _entries(path):
    """Yield (key, dtype, shape, nbytes, read) for each map of the
    document; ``read(out)`` fills a uint8 numpy buffer with the entry's
    data. An entry not read is skipped without being loaded."""
    with open(path, "rb") as f:
        r = _Reader(f)
        kind, n = r.head()
        if kind != "array":
            raise ValueError(f"{path}: not a checkpoint document")
        for _ in range(n):
            kind, n_fields = r.head()
            if kind != "map":
                raise ValueError(f"{path}: entry is a {kind}, not a map")
            fields = {}
            for _ in range(n_fields):
                name = r.value()
                if name == "data":
                    kind, size = r.head()
                    if kind != "bin":
                        raise ValueError(f"{path}: data is a {kind}")
                    fields["data"] = (f.tell(), size)
                    f.seek(size, os.SEEK_CUR)
                else:
                    fields[name] = r.value()
            end = f.tell()
            start, size = fields["data"]

            def read(out, start=start, size=size):
                f.seek(start)
                if f.readinto(out) != size:
                    raise ValueError(f"{path}: truncated data")
                return out

            yield fields["key"], fields["dtype"], fields["shape"], size, read
            f.seek(end)


def restore(template, path: str, inplace: bool = False):
    """The tree of ``template`` (a tree of tensors or a ``Model``) with the
    leaves stored at ``path``; keys, shapes and dtypes must match. The new
    leaves are on their template leaves' devices; with ``inplace`` they are
    copied into the template's own tensors, which are returned."""
    tree = _as_tree(template)
    want = dict(_flatten(tree))
    got = {}
    for key, dtype, shape, size, read in _entries(path):
        if key not in want:
            continue
        t = want[key]
        if list(t.shape) != shape or _DTYPES.get(t.dtype) != dtype:
            raise ValueError(f"{key}: stored {shape} {dtype}, template "
                             f"{list(t.shape)} {_DTYPES.get(t.dtype)}")
        host = torch.empty(size, dtype=torch.uint8)
        read(host.numpy())
        host = host.view(_TORCH[dtype]).reshape(shape)
        with torch.no_grad():
            got[key] = t.copy_(host) if inplace else host.to(t.device)
    missing = sorted(set(want) - set(got))
    if missing:
        raise KeyError(f"{path}: no entry for {missing[:5]}"
                       f"{' ...' if len(missing) > 5 else ''}")
    if inplace:
        return template
    return _unflatten(tree, got)


def _unflatten(tree, by_key, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, by_key, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, by_key, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return by_key["/".join(prefix)]


def latest_step(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f.split("_")[1].split(".")[0])
             for f in os.listdir(ckpt_dir)
             if f.startswith("step_") and f.endswith(".msgpack")]
    return max(steps) if steps else None


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step}.msgpack")
