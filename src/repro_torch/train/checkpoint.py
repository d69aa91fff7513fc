"""Checkpointing (the port of ``repro.train.checkpoint``): a tree of tensors
as a msgpack array of ``{"key", "dtype", "shape", "data"}`` maps, written
atomically, one file a step in a directory.

The document is the reference's, byte for byte: leaves in the order
``jax.tree_util`` flattens them (dict keys sorted, list entries in order),
keys their paths joined by ``/`` (``params/layers/0/mixer/wq``), dtypes by
numpy's names (``"bfloat16"`` too, its bytes those of ``uint16``), data the
leaf's raw little-endian bytes in C order. So each package reads the
other's files.

msgpack is not a dependency: the document is written and read with the
port's subset of it (:mod:`repro_torch.core.packb`), which emits what
``msgpack.packb(doc, use_bin_type=True)`` emits. Both stream: :func:`save`
writes one leaf at a time and :func:`restore` reads one at a time, so a
state larger than host memory can be saved and restored.
"""
from __future__ import annotations

import os
import tempfile

import torch

from ..core.packb import Reader as _Reader
from ..core.packb import array_head as _array
from ..core.packb import bin_head as _bin_head
from ..core.packb import map_head as _map
from ..core.packb import pack_int as _int
from ..core.packb import pack_str as _str

_DTYPES = {torch.float32: "float32", torch.float64: "float64",
           torch.float16: "float16", torch.bfloat16: "bfloat16",
           torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
           torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH = {v: k for k, v in _DTYPES.items()}


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
