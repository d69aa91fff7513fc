"""Sharding policy: params / batch / cache / optimizer-state specs; the port
of ``repro.launch.sharding``.

Megatron-style tensor parallelism over the 'model' axis with name-aware
rules (column-parallel up-projections, row-parallel down-projections,
expert-parallel MoE weights), optional ZeRO-3-style 'data'-axis sharding
(fsdp=True) for the ≥50B models, batch over ('pod','data').

Every rule degrades gracefully: if a dimension is not divisible by the mesh
axis, the next candidate dimension is tried, and replication is the final
fallback — this is what lets one policy cover all 10 architectures (e.g.
vocab 92553 is not divisible by 16 → the embedding shards d_model instead).

The policy is a pure function of the mesh's axis sizes
(:func:`~repro_torch.launch.mesh.axis_sizes`): a mapping of sizes is a
mesh here. A :class:`Spec` is indexed by tensor dimension, as JAX's
``PartitionSpec``: each entry is None, an axis name, or a tuple of names.
DTensor's placements are indexed by mesh dimension; :func:`to_placements`
turns one into the other and :func:`distribute` places a tree.
"""
from __future__ import annotations

import math

import torch

from ..models.layers import tree_map
from .mesh import axis_sizes, data_axes

# name -> preferred sharded dim (negative = from the end), excluding any
# leading scan (layer-stack) dimension which is never sharded.
_COL = {"wq", "wk", "wv", "w_gate", "w_up", "w_in", "wq_b", "wkv_b",
        "lm_head", "w"}                      # shard output dim (-1)
_ROW = {"wo", "w_down", "w_out"}             # shard contraction dim (-2)
_REPL = {"router", "conv_w", "conv_b", "A_log", "dt_bias", "D",
         "norm_scale", "scale", "bias", "b", "q_norm", "kv_norm",
         "dec_pos", "enc_pos", "step"}


class Spec(tuple):
    """One entry per tensor dimension: None (replicated), an axis name, or
    a tuple of axis names (sharded over their product, major first). A
    tuple of one name is that name, as in ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` on every leaf of a tree of dicts and lists; a path
    is the tuple of keys (str) and list indices (int) down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _leaf_name(path) -> str:
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _stacked(path) -> bool:
    s = _path_str(path)
    return s.startswith("layers") or s.startswith("encoder") or \
        "/layers/" in s or "/encoder/" in s


def param_spec(path, shape, mesh, fsdp=False, expert_parallel=False) -> Spec:
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = sizes.get("data", 1)
    name = _leaf_name(path)
    ndim = len(shape)
    spec = [None] * ndim
    off = 1 if _stacked(path) else 0  # scan dim never sharded
    eff = list(range(off, ndim))      # shardable dims

    def try_assign(dim, axis, size):
        if dim in eff and spec[dim] is None and shape[dim] % size == 0 \
                and size > 1:
            spec[dim] = axis
            return True
        return False

    if name in _REPL or ndim - off < 2:
        return Spec(*spec)

    # Modality projector (VLM): row-parallel, so its OUTPUT — the residual
    # stream entering layer 0 — stays replicated over 'model'.
    if "projector" in _path_str(path):
        try_assign(ndim - 2, "model", model)
        return Spec(*spec)

    # Expert-parallel variant: a 3D (E, din, dout) expert weight shards its
    # EXPERT dim over 'model' instead of tensor-parallel dims.
    if expert_parallel and name in ("w_gate", "w_up", "w_down") \
            and ndim - off == 3:
        try_assign(off, "model", model)
        if fsdp:
            try_assign(ndim - 1, "data", dp) or \
                try_assign(ndim - 2, "data", dp)
        return Spec(*spec)

    if name == "embed":
        try_assign(ndim - 2, "model", model) or \
            try_assign(ndim - 1, "model", model)
    elif name in _ROW:
        try_assign(ndim - 2, "model", model) or \
            try_assign(ndim - 1, "model", model)
    elif name in _COL:
        try_assign(ndim - 1, "model", model) or \
            try_assign(ndim - 2, "model", model)
    elif name in ("w_gate", "w_up", "w_down"):
        pass  # covered above
    else:  # unknown matrix: prefer the last dim
        try_assign(ndim - 1, "model", model) or \
            try_assign(ndim - 2, "model", model)

    # A 3D (E, din, dout) MoE core keeps its expert dim for fsdp or
    # replication: with one 'model' axis it cannot shard that dim too.
    if fsdp:
        for dim in range(off, ndim):
            if try_assign(dim, "data", dp):
                break
    return Spec(*spec)


def _shape(leaf):
    return tuple(leaf[0] if isinstance(leaf, tuple) else leaf.shape)


def param_specs(params_shapes, mesh, fsdp=False, expert_parallel=False):
    """Map a tree of tensors or :class:`~repro_torch.launch.specs.TensorSpec`
    (anything with ``.shape``) to :class:`Spec` leaves."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, _shape(leaf), mesh, fsdp,
                                      expert_parallel),
        params_shapes)


def opt_specs(pspecs):
    """Optimizer state mirrors the param sharding (mu/nu per param)."""
    return {"mu": pspecs, "nu": pspecs, "step": Spec()}


def _dp_size(mesh):
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def batch_spec(shape, mesh) -> Spec:
    dp = data_axes(mesh)
    dp_size = _dp_size(mesh)
    spec = [None] * len(shape)
    if shape and shape[0] % dp_size == 0 and dp_size > 1:
        spec[0] = dp
    return Spec(*spec)


def batch_specs(batch_shapes, mesh):
    return tree_map(lambda l: batch_spec(_shape(l), mesh), batch_shapes)


# Size/shape-aware cache policy:
# * small leaves replicate over 'model' — the per-step resharding
#   collective costs more than the extra reads;
# * large leaves shard a TRAILING dim (head/lora) when its slice stays
#   >= MIN_SLICE lanes;
# * when no trailing dim qualifies the SEQUENCE dim (dim 2) is sharded
#   instead, flash-decode style: writes stay local to one shard.
CACHE_REPL_THRESHOLD_BYTES = 512 << 20
CACHE_MIN_SLICE = 8


def cache_spec(path, shape, mesh, model_shard=True, itemsize=2) -> Spec:
    """Cache leaves are (n_periods, B, ...): batch over data axes, then
    'model' per the policy above. model_shard=False forces replication."""
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    dp = data_axes(mesh)
    dp_size = _dp_size(mesh)
    ndim = len(shape)
    spec = [None] * ndim
    batch_sharded = ndim >= 2 and shape[1] % dp_size == 0 and dp_size > 1
    if batch_sharded:
        spec[1] = dp
    leaf_bytes = itemsize * math.prod(shape)
    per_dev_if_repl = leaf_bytes // (dp_size if batch_sharded else 1)
    if model > 1 and model_shard \
            and per_dev_if_repl > CACHE_REPL_THRESHOLD_BYTES:
        candidates = list(range(ndim - 1, 2, -1)) + [2]  # trailing, then seq
        for dim in candidates:
            if dim < ndim and shape[dim] % model == 0 \
                    and shape[dim] // model >= CACHE_MIN_SLICE:
                spec[dim] = "model"
                break
    return Spec(*spec)


def _itemsize(leaf):
    dtype = leaf[1] if isinstance(leaf, tuple) else leaf.dtype
    return dtype.itemsize if dtype is not None else 2


def cache_specs(cache_shapes, mesh, model_shard=True):
    return tree_map_with_path(
        lambda path, leaf: cache_spec(path, _shape(leaf), mesh, model_shard,
                                      itemsize=_itemsize(leaf)),
        cache_shapes)


# -- DTensor placements ---------------------------------------------------------

def to_placements(spec: Spec, mesh) -> tuple:
    """The DTensor placements (one per MESH dimension) of a :class:`Spec`
    (one entry per TENSOR dimension). A dimension sharded over several
    axes, e.g. ('pod', 'data'), is one ``Shard(d)`` on each of them; the
    axes must be named in mesh order (major first, JAX's order), which is
    DTensor's default order of shards on one dimension."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} of dim {dim} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec}: axis {names[i]!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def local_shape(shape, spec: Spec, mesh) -> tuple:
    """This rank's shard shape of a tensor of ``shape`` under ``spec`` (the
    policy shards only divisible dimensions, so every rank's is equal)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            if out[dim] % sizes[a]:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not "
                                 f"divide over {a!r} ({sizes[a]})")
            out[dim] //= sizes[a]
    return tuple(out)


def _zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip(fn, v, s) for v, s in zip(tree, specs, strict=True)]
    return fn(tree, specs)


def distribute(tree, specs, mesh):
    """A tree of tensors as DTensors on ``mesh`` under a tree of
    :class:`Spec` alike. A meta tensor becomes a meta DTensor of its
    local shard shape (nothing allocated); a real tensor keeps this rank's
    shard of it, taken without communication: every rank holds the full
    tensor (the synthetic pipeline and seeded draws are the same on every
    rank)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(t, spec):
        placements = to_placements(spec, mesh)
        if t.is_meta:
            local = torch.empty(local_shape(t.shape, spec, mesh),
                                dtype=t.dtype, device="meta")
            return DTensor.from_local(local, mesh, placements,
                                      run_check=False, shape=t.shape,
                                      stride=t.stride())
        return distribute_tensor(t, mesh, placements, src_data_rank=None)
    return _zip(place, tree, specs)
