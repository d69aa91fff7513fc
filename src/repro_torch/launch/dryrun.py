"""Multi-pod dry run (the port of ``repro.launch.dryrun``): every
(architecture × input shape) step traced on the production meshes, with
per-device memory, FLOPs and collectives recorded.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
      --mesh single multi --out build/dryrun

The reference compiles each step with GSPMD for 256 / 512 placeholder host
devices. PyTorch has no GSPMD: here the step runs eagerly on meta DTensors
(no storage) on a CPU ``DeviceMesh`` over a fake process group of 256 /
512 ranks, and :class:`StepMeter`, a dispatch mode below DTensor, sees the
local ops of rank 0. Per record:

* ``memory.argument_bytes`` / ``output_bytes``: per device, exact, the
  local shard bytes of the arguments and the outputs (``alias_bytes``:
  outputs that are arguments written in place, as the port's steps write
  params, optimizer state and caches);
* ``memory.temp_bytes``: an ESTIMATE, the peak live bytes of the storages
  the step's local ops allocate (outputs included, arguments excluded),
  freed when Python frees them; named by ``memory.temp_method``. There is
  no buffer assignment to read;
* ``flops_per_device``: the local ops' FLOPs by ``torch.utils.flop_counter``'s
  formulas (FlopCounterMode above DTensor would count global FLOPs);
* ``collectives``: the ``_c10d_functional`` collectives the step dispatches
  (on a CPU mesh DTensor moves a shard from one dimension to another by
  an all-gather and a local slice, where on GPUs it would all-to-all),
  by kind, with their output bytes per device. DTensor redistributes where
  an op has no sharding rule for its inputs' placements, which GSPMD might
  not, so these bytes are what DTensor issues and not XLA's;
* ``trace_s``: the wall time of the traced step (the reference's
  ``lower_s`` + ``compile_s``).

DTensor's rules differ between torch versions and have gaps: where one
fails, :class:`_Gaps` runs the op another way (its inputs gathered, or on
the local shards by hand), and the record names each such op in
``fallback_ops`` with DTensor's error in ``fallback_errors``. The
dispatched collectives include those gathers. A combination that fails is
recorded with ``status="error"`` and its traceback.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import INPUT_SHAPES, get_config, list_configs
from ..models import model as M
from ..models.layers import tree_map
from ..optim import adamw
from ..serve.quantized import QuantizedTensor, dequantize_params
from ..train.step import grads_of
from . import sharding as SH
from . import specs as SP
from .mesh import MULTI_POD, SINGLE_POD, fake_world, make_mesh

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
_FUNCOL = {"all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all"}
TEMP_METHOD = ("live-bytes dispatch mode over rank 0's local shards: peak "
               "bytes of storages the step allocated, outputs included")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepMeter(TorchDispatchMode):
    """Counts rank 0's local work under DTensor: FLOPs, collectives (count
    and output bytes by kind) and live bytes of the storages allocated
    inside the mode (a storage counts while the tensor an op made on it
    lives; views of it are not followed). A DTensor op is handed back to
    DTensor (``NotImplemented``), which dispatches its local ops here."""

    def __init__(self, exclude=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.ops = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
        self.live = 0
        self.peak = 0
        self.paused = 0
        self._seen = {}  # storage -> [bytes, tensors holding it]
        self._holding = set()  # ids of the live tensors counted
        self._views = {}  # op -> whether its outputs alias its inputs
        self._exclude = {t.untyped_storage()._cdata for t in exclude}

    def _track(self, t):
        """Counts ``t``'s storage once, while any tensor the mode saw on
        it lives (a tensor dies when its last reference goes; a storage
        object only at garbage collection)."""
        if id(t) in self._holding:
            return
        key = t.untyped_storage()._cdata
        if key in self._exclude:
            return
        if key not in self._seen:
            n = t.untyped_storage().nbytes()
            self._seen[key] = [n, 0]
            self.live += n
            self.peak = max(self.peak, self.live)
        self._seen[key][1] += 1
        self._holding.add(id(t))
        weakref.finalize(t, self._drop, key, id(t))

    def _drop(self, key, tid):
        self._holding.discard(tid)
        entry = self._seen[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._seen[key]

    @contextlib.contextmanager
    def outside_propagation(self):
        """DTensor's sharding propagation runs the op on global-shape meta
        tensors to learn its output's shape: work no rank does, so the
        meter pauses there (it wraps the propagator's methods that do so,
        those of them this torch has, while active)."""
        from torch.distributed.tensor import DTensor
        prop = DTensor._op_dispatcher.sharding_propagator
        names = [n for n in ("propagate_op_sharding_non_cached",
                             "_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta") if hasattr(prop, n)]

        def paused(fn):
            def run(*a, **k):
                self.paused += 1
                try:
                    return fn(*a, **k)
                finally:
                    self.paused -= 1
            return run
        for n in names:
            setattr(prop, n, paused(getattr(prop, n)))
        try:
            yield
        finally:
            for n in names:
                delattr(prop, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.paused:
            return out
        self.ops += 1
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += self._flops[packet](*args, **kwargs, out_val=out)
        if func.namespace == "_c10d_functional":
            kind = _FUNCOL.get(packet.__name__)
            if kind:
                c = self.collectives[kind]
                c["count"] += 1
                c["bytes"] += sum(_nbytes(t) for t in _tensors(out))
        views = self._views.get(func)
        if views is None:
            views = self._views[func] = any(
                r.alias_info is not None for r in func._schema.returns)
        if not views:  # a view holds its base's storage: counted there
            for t in _tensors(out):
                if t.layout == torch.strided:
                    self._track(t)
        return out


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


# -- DTensor gaps ---------------------------------------------------------------

def _local_einsum(eq, *ops):
    """``torch.einsum`` on the local shards, where every mesh dimension
    shards at most one index letter, one the result keeps, and shards it
    alike in every operand that has it (the batch and head indices of
    attention, the chunk index of the SSM scan): the result is sharded on
    that letter. DTensor would flatten such sharded batch indices into one,
    which it cannot do without moving data (or, on newer torch, only
    through layouts whose cost search is slow). None where the rule does
    not apply."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if "..." in eq or "->" not in eq or not ops \
            or not all(isinstance(t, DTensor) for t in ops):
        return None
    lhs, rhs = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    mesh = ops[0].device_mesh
    if len(terms) != len(ops) or any(t.device_mesh != mesh or len(term)
                                     != t.ndim for t, term in zip(ops, terms)):
        return None
    size = {}
    for t, term in zip(ops, terms):
        size.update(zip(term, t.shape))
    out_pl = []
    for m in range(mesh.ndim):
        letters = set()
        for t, term in zip(ops, terms):
            pl = t.placements[m]
            if type(pl) is Shard:
                letters.add(term[pl.dim])
            elif not isinstance(pl, Replicate):
                return None  # partial or strided: DTensor's own rules
        if not letters:
            out_pl.append(Replicate())
            continue
        if len(letters) > 1:
            return None
        (L,) = letters
        for t, term in zip(ops, terms):
            if L in term and t.placements[m] != Shard(term.index(L)):
                return None
        if L not in rhs:
            return None  # a partial sum: DTensor's own rules
        out_pl.append(Shard(rhs.index(L)))
    for L in size:
        ways = 1
        for m in range(mesh.ndim):
            if any(type(t.placements[m]) is Shard
                   and term[t.placements[m].dim] == L
                   for t, term in zip(ops, terms)):
                ways *= mesh.size(m)
        if size[L] % ways:
            return None
    out = torch.einsum(f"{lhs}->{rhs}", *(t.to_local() for t in ops))
    shape = torch.Size(size[c] for c in rhs)
    return DTensor.from_local(out, mesh, out_pl, run_check=False,
                              shape=shape, stride=_stride_like(out, shape))


def _stride_like(local, shape):
    """Strides of a dense tensor of the global ``shape`` whose dimensions
    are laid out in the order of ``local``'s (einsum returns permuted
    views)."""
    order = sorted(range(local.ndim), key=lambda d: (-local.stride(d), d))
    stride, acc = [0] * len(shape), 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def _raised_in_dtensor(e) -> bool:
    """Whether ``e`` is an error that passed through DTensor's own code,
    and not, say, autograd's or remat's (whose early stop of a recompute
    is an exception too)."""
    if not isinstance(e, (RuntimeError, NotImplementedError, IndexError,
                          ValueError, TypeError, AssertionError)) \
            or type(e).__module__.startswith("torch.utils.checkpoint"):
        return False
    tb = e.__traceback__
    while tb is not None:
        if "distributed/tensor" in tb.tb_frame.f_code.co_filename.replace(
                "\\", "/"):
            return True
        tb = tb.tb_next
    return False


class _Gaps(torch.overrides.TorchFunctionMode):
    """Where DTensor's own rules fail, the op another way; ``used`` names
    each op so run. DTensor's rules differ between torch versions; these
    keep one dry run going on each.

    * A DTensor op that DTensor fails (the error raised in its code) runs
      again with its DTensor arguments (but
      the one an in-place op writes) replicated over the last mesh
      dimension, then the last two, and so on (the all-gathers are
      counted); an op with no sharding strategy at all runs on the full
      local tensors, its outputs replicated. If every try fails, the
      first error is raised. An in-place op after which DTensor has
      re-labelled its target's placements (without moving its data)
      raises.
    * A tensor made from nothing (``torch.full``, ``zeros``, ``arange``,
      ...) on the meta device is made replicated on the mesh, so that an
      in-place write of DTensors into it is one DTensor op.
    * ``torch.einsum`` on local shards where :func:`_local_einsum` applies,
      and ``F.pad`` on the local shard (the padded dimensions gathered).
    * ``torch.gather`` from a tensor sharded (or a partial sum) along the
      gathered dimension: DTensor's masked partial for it fails when
      reduced (its mask is applied as an embedding's), so a partial sum
      is reduce-scattered along that dimension, each shard gathers the
      indices it holds and zeroes the others, and the result is a
      ``Partial`` sum over those mesh dimensions (one all-reduce)."""

    _FACTORIES = (torch.full, torch.zeros, torch.ones, torch.empty,
                  torch.arange)
    _INPLACE = (torch.Tensor.__setitem__,)
    _VIEWS = ("squeeze_", "unsqueeze_", "t_", "transpose_", "swapdims_",
              "swapaxes_", "as_strided_")

    def __init__(self, mesh):
        super().__init__()
        self.mesh = mesh
        self.used = set()
        self.errors = {}  # op -> the DTensor error that sent it elsewhere

    def __torch_function__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate
        kwargs = kwargs or {}
        if func in self._FACTORIES:
            out = func(*args, **kwargs)
            if not out.is_meta:
                return out
            return DTensor.from_local(out, self.mesh,
                                      [Replicate()] * self.mesh.ndim,
                                      run_check=False)
        if func in (torch.gather, torch.Tensor.gather):
            out = self._gather(*args, **kwargs)
            if out is not None:
                self.used.add("gather")
                return out
        if func is torch.nn.functional.pad:
            out = self._pad(*args, **kwargs)
            if out is not None:
                return out
        if func is torch.einsum and not kwargs:
            out = _local_einsum(*args)
            if out is not None:
                return out
        name = getattr(func, "__name__", str(func))
        inplace = func in self._INPLACE or name.endswith("_") \
            or "out" in kwargs
        target = kwargs.get("out", args[0] if args else None) \
            if inplace else None
        before = getattr(target, "placements", None)
        out = func(*args, **kwargs)
        if before is not None and target.placements != before \
                and name not in self._VIEWS:
            raise RuntimeError(
                f"{name} re-labelled its target {before} -> "
                f"{target.placements} without moving its data; write it "
                "out of place")
        return out

    def retry(self, func, args, kwargs, first_error, name, inplace):
        """``func`` (an aten op that DTensor failed) with its DTensor
        arguments, but the one an in-place op writes, replicated over the
        last mesh dimension, then the last two, ... until it runs."""
        from torch.distributed.tensor import DTensor, Replicate
        mesh = self.mesh
        keep = args[:1] if inplace else ()
        rest = (args[1:] if inplace else args, kwargs)
        for first in range(mesh.ndim - 1, -1, -1):
            def rep(t):
                if isinstance(t, DTensor):
                    return t.redistribute(mesh, [
                        Replicate() if m >= first else pl
                        for m, pl in enumerate(t.placements)])
                return t
            rargs, rkw = torch.utils._pytree.tree_map(rep, rest)
            try:
                out = func(*keep, *rargs, **rkw)
                self.used.add(f"{name} (replicated)")
                return out
            except Exception as e:  # noqa: BLE001
                last = e
        if inplace or "sharding strategy" not in str(last):
            raise first_error
        local = torch.utils._pytree.tree_map(
            lambda t: t.to_local() if isinstance(t, DTensor) else t,
            (rargs, rkw))
        out = func(*local[0], **local[1])
        self.used.add(f"{name} (local)")
        return torch.utils._pytree.tree_map(
            lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                         run_check=False)
            if isinstance(t, torch.Tensor) else t, out)

    @staticmethod
    def _pad(x, pad, mode="constant", value=None):
        """``F.pad`` of a DTensor on its local shard, the padded dimensions
        gathered first (some torch versions lose the mesh's placements in
        their own rule for it)."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        if not isinstance(x, DTensor):
            return None
        dims = {x.ndim - 1 - i for i in range(len(pad) // 2)
                if pad[2 * i] or pad[2 * i + 1]}
        pls = [Replicate() if pl.is_partial() or (
            isinstance(pl, Shard) and pl.dim % x.ndim in dims) else pl
            for pl in x.placements]
        x = x.redistribute(x.device_mesh, pls)
        local = torch.nn.functional.pad(x.to_local(), pad, mode, value)
        shape = list(x.shape)
        for i in range(len(pad) // 2):
            shape[x.ndim - 1 - i] += pad[2 * i] + pad[2 * i + 1]
        shape = torch.Size(shape)
        return DTensor.from_local(local, x.device_mesh, pls, run_check=False,
                                  shape=shape, stride=_stride_like(local,
                                                                   shape))

    @staticmethod
    def _gather(x, dim, index, *, sparse_grad=False):
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        if not isinstance(x, DTensor):
            return None
        dim = dim % x.ndim
        pls = [Shard(dim) if pl.is_partial() else pl for pl in x.placements]
        on_dim = [m for m, pl in enumerate(pls) if pl == Shard(dim)]
        if not on_dim:
            return None
        mesh = x.device_mesh
        x = x.redistribute(mesh, pls)  # a partial sum: reduce-scattered
        want = [Replicate() if m in on_dim else pl
                for m, pl in enumerate(x.placements)]
        if not isinstance(index, DTensor):
            index = DTensor.from_local(index, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
        index = index.redistribute(mesh, want)
        lshape, goff = compute_local_shape_and_global_offset(
            x.shape, mesh, x.placements)
        lx, li = x.to_local(), index.to_local() - goff[dim]
        miss = (li < 0) | (li >= lshape[dim])
        got = torch.gather(lx, dim, li.masked_fill(miss, 0))
        got = got.masked_fill(miss, 0)
        return DTensor.from_local(
            got, mesh, [Partial("sum") if m in on_dim else pl
                        for m, pl in enumerate(want)], run_check=False)


class _Retry(TorchDispatchMode):
    """The dispatch-level half of :class:`_Gaps`: every DTensor aten op,
    autograd's too, and where DTensor fails it, :meth:`_Gaps.retry`."""

    def __init__(self, gaps):
        super().__init__()
        self.gaps = gaps

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — DTensor's: retried
            if not _raised_in_dtensor(e):
                raise
            name = func._overloadpacket.__name__
            self.gaps.errors.setdefault(name,
                                        f"{type(e).__name__}: {e}"[:300])
            return self.gaps.retry(func, args, kwargs, e, name,
                                   func._schema.is_mutable)


@contextlib.contextmanager
def recompute_under(mode):
    """While active, the decoder stack's remat recompute (run by autograd,
    where no torch-function mode is active) runs under ``mode`` too, so
    that it takes the layouts the forward took."""
    from ..models import transformer as TR
    orig = TR.checkpoint

    def checkpoint(fn, *args, **kwargs):
        return orig(fn, *args, context_fn=lambda: (contextlib.nullcontext(),
                                                   mode), **kwargs)
    TR.checkpoint = checkpoint
    try:
        yield
    finally:
        TR.checkpoint = orig


STRIDED_PENALTY = 1e6


@contextlib.contextmanager
def plain_shard_costs():
    """While active (the dry run's 3-D meshes: on 2-D ones DTensor's own
    search is fast), DTensor's strategy search costs a candidate layout
    holding strided shards (what a view of a dimension sharded over two
    mesh dimensions gives) as the same layout with plain shards, plus
    ``STRIDED_PENALTY``, so that it is taken only where nothing else
    will do. The exact planner searches every layout of the mesh for each
    such candidate, which on the 3-D multi-pod mesh takes minutes an op;
    the costs only rank the candidates, and the redistribution DTensor
    then runs is planned exactly. Without the hook (another torch),
    nothing changes."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor._dtensor_spec import DTensorSpec
    from torch.distributed.tensor.placement_types import _StridedShard
    try:
        from torch.distributed.tensor._ops import utils as ops_utils
    except ImportError:
        ops_utils = None
    orig = getattr(ops_utils, "redistribute_cost", None)
    if orig is None:
        yield
        return

    def plain(spec):
        return DTensorSpec(spec.mesh, tuple(
            Shard(p.dim) if isinstance(p, _StridedShard) else p
            for p in spec.placements), tensor_meta=spec.tensor_meta)

    def cost(current, target):
        if any(isinstance(p, _StridedShard)
               for p in (*current.placements, *target.placements)):
            return orig(plain(current), plain(target)) + STRIDED_PENALTY
        return orig(current, target)

    ops_utils.redistribute_cost = cost
    try:
        yield
    finally:
        ops_utils.redistribute_cost = orig


# -- steps ----------------------------------------------------------------------

def quantized_specs(p_specs, min_size: int = 1 << 12):
    """``quantize_params``'s tree on specs: a float matrix leaf of at least
    ``min_size`` elements becomes a QuantizedTensor of an int8 spec and a
    float32 per-output-channel scale spec."""
    def q(s):
        if (not s.dtype.is_floating_point or len(s.shape) < 2
                or math.prod(s.shape) < min_size):
            return s
        return QuantizedTensor(SP.TensorSpec(s.shape, torch.int8),
                               SP.TensorSpec((s.shape[-1],), torch.float32),
                               s.dtype)
    return tree_map(q, p_specs)


def sync_grads(grads, params):
    """Each gradient DTensor redistributed to its parameter's placements:
    the all-reduce (replicated parameter) or reduce-scatter (sharded one)
    of a data-parallel step, which GSPMD inserts from the step's
    shardings. Plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    def sync(g, p):
        if isinstance(g, DTensor) and g.placements != p.placements:
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return _zip(sync, grads, M._tree(params))


def train_step(cfg, opt_cfg, chunked_ce: int = 0):
    """``repro_torch.train.step.make_train_step(cfg, opt_cfg, remat=True)``
    with the gradients synchronized (:func:`sync_grads`) before the
    update: the same arithmetic on one device."""
    def step(params, opt_state, batch):
        loss, parts, grads = grads_of(cfg, params, batch, remat=True,
                                      chunked_ce=chunked_ce)
        params, opt_state, opt_m = adamw.update(
            opt_cfg, sync_grads(grads, params), opt_state, params)
        return params, opt_state, {"loss": loss, **parts, **opt_m}
    return step


def build_step(cfg, shape, quantized: bool = False, chunked_ce: int = 0):
    """Returns (fn, arg_specs (tuple of TensorSpec trees), donate_argnums).

    quantized=True (inference kinds only): parameters are int8 weight-only
    QuantizedTensors, dequantized inside the step. A decode ``pos`` is a
    0-d integer tensor read as an int: the step's ops and shapes do not
    depend on its value."""
    specs = SP.input_specs(cfg, shape)
    ecfg = SP.effective_config(cfg, shape)
    if shape.kind == "train":
        step = train_step(ecfg, adamw.AdamWConfig(), chunked_ce=chunked_ce)
        return step, (specs["params"], specs["opt_state"], specs["batch"]), \
            (0, 1)

    p_specs = quantized_specs(specs["params"]) if quantized \
        else specs["params"]

    if shape.kind == "prefill":
        @torch.no_grad()
        def step(params, batch, cache):
            if quantized:
                params = dequantize_params(params)
            return M.prefill(ecfg, params, batch, cache)
        return step, (p_specs, specs["batch"], specs["cache"]), (2,)

    @torch.no_grad()
    def step(params, tokens, cache, pos):
        if quantized:
            params = dequantize_params(params)
        return M.decode_step(ecfg, params, tokens, cache, int(pos))
    return step, (p_specs, specs["tokens"], specs["cache"],
                  specs["pos"]), (2,)


def _param_specs(tree, mesh, fsdp, expert_parallel):
    """``SH.param_specs`` where a QuantizedTensor's int8 values and scales
    each take the rule of the leaf they quantize (the reference's pytree
    path ends at the leaf's key)."""
    def spec(path, leaf):
        if isinstance(leaf, QuantizedTensor):
            return QuantizedTensor(*(SH.param_spec(path, t.shape, mesh, fsdp,
                                                   expert_parallel)
                                     for t in (leaf.q, leaf.scale)),
                                   leaf.orig_dtype)
        return SH.param_spec(path, leaf.shape, mesh, fsdp, expert_parallel)
    return SH.tree_map_with_path(spec, tree)


def arg_shardings(cfg, shape, args, mesh, fsdp, expert_parallel=False,
                  cache_model_shard=True):
    """Spec tree parallel to the abstract args."""
    p_specs = _param_specs(args[0], mesh, fsdp, expert_parallel)
    if shape.kind == "train":
        return (p_specs, SH.opt_specs(p_specs),
                SH.batch_specs(args[2], mesh))
    if shape.kind == "prefill":
        return (p_specs, SH.batch_specs(args[1], mesh),
                SH.cache_specs(args[2], mesh, cache_model_shard))
    return (p_specs, SH.batch_specs(args[1], mesh),
            SH.cache_specs(args[2], mesh, cache_model_shard), SH.Spec())


def _zip(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, SH.Spec):
        return type(tree)(_zip(fn, v, s)
                          for v, s in zip(tree, specs, strict=True))
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q, specs.q),
                               fn(tree.scale, specs.scale), tree.orig_dtype)
    return fn(tree, specs)


def local_arg_bytes(args, specs, mesh) -> int:
    """Per-device argument bytes by shard arithmetic on the specs alone."""
    total = 0

    def add(s, spec):
        nonlocal total
        total += math.prod(SH.local_shape(s.shape, spec, mesh)) \
            * s.dtype.itemsize
    _zip(add, args, specs)
    return total


def place(args, specs, mesh):
    """Meta DTensors of the arg specs (a 0-d ``pos`` stays a host int32
    holding 0). Leaves of float dtype under a train step require grad."""
    def make(s, spec):
        if s.shape == () and not s.dtype.is_floating_point:
            return torch.zeros((), dtype=s.dtype)
        return SH.distribute(SP.meta(s), spec, mesh)
    return _zip(make, args, specs)


def _out_leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, QuantizedTensor):
        return [x.q, x.scale]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _out_leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _out_leaves(v)]
    return []


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def trace_step(step, args, kind, mesh):
    """Runs ``step(*args)`` (meta DTensors) under a :class:`StepMeter`;
    returns (meter, argument bytes, output bytes, alias bytes, the
    :class:`_Gaps` it ran under, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_leaves = [_local(t) for t in _out_leaves(args)]
    if kind == "train":
        M.trainable(args[0])
    gaps = _Gaps(mesh)
    meter = StepMeter(exclude=arg_leaves)
    t0 = time.perf_counter()
    costs = plain_shard_costs() if mesh.ndim >= 3 \
        else contextlib.nullcontext()
    with implicit_replication(), costs, recompute_under(gaps), \
            meter.outside_propagation(), gaps, meter, _Retry(gaps):
        out = step(*args)
    secs = time.perf_counter() - t0
    arg_st = {t.untyped_storage()._cdata for t in arg_leaves}
    outs = [_local(t) for t in _out_leaves(out)]
    out_bytes = sum(_nbytes(t) for t in outs)
    alias = sum(_nbytes(t) for t in outs
                if t.untyped_storage()._cdata in arg_st)
    arg_bytes = sum(_nbytes(t) for t in arg_leaves)
    return meter, arg_bytes, out_bytes, alias, gaps, secs


@contextlib.contextmanager
def _world(n):
    """A fake world of ``n`` ranks unless a group of that size is active."""
    if dist.is_initialized() and dist.get_world_size() == n:
        yield
    else:
        with fake_world(n):
            yield


def _write(rec, out_dir, fname):
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, fname + ".json"), "w") as f:
            json.dump(rec, f, indent=1)


def run_one(arch: str, shape_name: str, multi_pod: bool, fsdp: str = "auto",
            out_dir: str = "build/dryrun", step_override=None,
            tag: str = "", cfg=None, quantized: bool = False,
            expert_parallel: bool = False, cache_model_shard: bool = True,
            chunked_ce: int = 0, mesh_shape=None, input_shape=None) -> dict:
    """One record. ``mesh_shape`` = (shape, axes) replaces the production
    mesh (the mesh stays named ``single`` / ``multi`` in the record), and
    ``input_shape`` (an ``InputShape``) the shape named ``shape_name``."""
    cfg = cfg if cfg is not None else get_config(arch)
    shape = input_shape or INPUT_SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "kind": shape.kind, "quantized": quantized,
           "expert_parallel": expert_parallel}
    fname = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")

    reason = SP.skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", reason=reason)
        _write(rec, out_dir, fname)
        return rec

    use_fsdp = (cfg.param_count() * 2 > 64e9) if fsdp == "auto" \
        else (fsdp == "on")
    rec["fsdp"] = use_fsdp
    mshape, axes = mesh_shape or (MULTI_POD if multi_pod else SINGLE_POD)
    try:
        with _world(math.prod(mshape)):
            mesh = make_mesh(mshape, axes, "cpu")
            if step_override is not None:
                step, args, _ = step_override(cfg, shape)
            else:
                step, args, _ = build_step(cfg, shape, quantized=quantized,
                                           chunked_ce=chunked_ce)
            in_specs = arg_shardings(cfg, shape, args, mesh, use_fsdp,
                                     expert_parallel=expert_parallel,
                                     cache_model_shard=cache_model_shard)
            placed = place(args, in_specs, mesh)
            meter, arg_b, out_b, alias_b, gaps, secs = trace_step(
                step, placed, shape.kind, mesh)
            del placed
        colls = meter.collectives
        rec.update(
            status="ok",
            n_devices=math.prod(mshape),
            mesh_shape=list(mshape),
            trace_s=round(secs, 2),
            memory=dict(argument_bytes=arg_b,
                        argument_bytes_by_specs=local_arg_bytes(
                            args, in_specs, dict(zip(axes, mshape))),
                        output_bytes=out_b, temp_bytes=meter.peak,
                        alias_bytes=alias_b, temp_method=TEMP_METHOD),
            flops_per_device=float(meter.flops),
            local_ops=meter.ops,
            collectives=colls,
            collective_bytes_total=sum(v["bytes"] for v in colls.values()),
            fallback_ops=sorted(gaps.used),
            fallback_errors=gaps.errors,
        )
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}"
              f"{' ×' + tag if tag else ''}: OK (trace {secs:.1f}s, "
              f"{meter.flops:.3g} flops/dev, "
              f"args {arg_b / 2**30:.2f} GiB/dev, "
              f"temp {meter.peak / 2**30:.2f} GiB/dev)", flush=True)
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] {arch} × {shape_name} × {mesh_name}: "
              f"FAILED — {type(e).__name__}: {str(e)[:200]}", flush=True)
    _write(rec, out_dir, fname)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single"],
                    choices=["single", "multi"])
    ap.add_argument("--fsdp", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--skip-done", action="store_true")
    args = ap.parse_args(argv)

    archs = list_configs() if args.arch == ["all"] else args.arch
    shapes = list(INPUT_SHAPES) if args.shape == ["all"] else args.shape

    results = []
    for arch in archs:
        for shape in shapes:
            for mesh in args.mesh:
                fname = os.path.join(args.out,
                                     f"{arch}__{shape}__{mesh}.json")
                if args.skip_done and os.path.exists(fname):
                    with open(fname) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[dryrun] skip (done): {arch} × {shape} × {mesh}")
                        results.append(prev)
                        continue
                results.append(run_one(arch, shape, mesh == "multi",
                                       args.fsdp, args.out))

    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n[dryrun] total={len(results)} ok={ok} skipped={sk} error={err}")
    if err:
        for r in results:
            if r["status"] == "error":
                print("  FAIL:", r["arch"], r["shape"], r["mesh"], "--",
                      r["error"][:160])
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
