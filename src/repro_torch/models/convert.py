"""Parameters, caches and optimizer states of the JAX package, given as
trees of numpy arrays (``jax.tree.map(np.asarray, tree)``), carried into
the port key for key, with every shape checked, and the port's trees
carried back (:func:`to_numpy`). This is how both packages compute the same
thing in the parity tests, and start a step from the same state."""
from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device
from .layers import tree_map
from .model import Model, cache_shapes, param_specs


def _tensor(a) -> torch.Tensor:
    a = np.array(a)  # a copy: the port never writes a JAX buffer
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _carry(want, got, path, shape_of):
    """``got`` (numpy leaves) as tensors, its keys and shapes held to
    ``want``."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"{path or '<root>'}: keys "
                             f"{sorted(got) if isinstance(got, dict) else got}"
                             f" != {sorted(want)}")
        return {k: _carry(want[k], got[k], f"{path}.{k}".lstrip("."),
                          shape_of) for k in want}
    if isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{path}: {len(want)} entries expected")
        return [_carry(w, g, f"{path}.{i}", shape_of)
                for i, (w, g) in enumerate(zip(want, got))]
    t = _tensor(got)
    if tuple(t.shape) != tuple(shape_of(want)):
        raise ValueError(f"{path}: shape {tuple(t.shape)} != "
                         f"{tuple(shape_of(want))}")
    return t


def params_from_reference(cfg, tree, device="cuda") -> Model:
    """A :class:`Model` holding the reference's parameters ``tree``."""
    dev = resolve_device(device)
    max_seq = np.shape(tree["dec_pos"])[0] if "dec_pos" in tree else 4096
    got = _carry(param_specs(cfg, max_seq=max_seq), tree, "",
                 lambda spec: spec.shape)
    return Model(cfg, got).to(dev)


def cache_from_reference(cfg, tree, B, S, device="cuda"):
    """The reference's cache ``tree`` (``init_cache(cfg, B, S)``'s layout)
    as the port's cache."""
    dev = resolve_device(device)
    got = _carry(cache_shapes(cfg, B, S), tree, "", lambda sd: sd[0])
    return tree_map(lambda t: t.to(dev), got)


def opt_state_from_reference(cfg, tree, device="cuda") -> dict:
    """The reference's AdamW state (``repro.optim.adamw.init``'s layout:
    ``mu`` and ``nu`` in the params' tree, float32, and an int32 ``step``)
    as the port's (:func:`repro_torch.optim.adamw.init`)."""
    dev = resolve_device(device)
    max_seq = (np.shape(tree["mu"]["dec_pos"])[0] if "dec_pos" in tree["mu"]
               else 4096)
    specs = param_specs(cfg, max_seq=max_seq)
    out = {k: tree_map(lambda t: t.to(dev),
                       _carry(specs, tree[k], k, lambda spec: spec.shape))
           for k in ("mu", "nu")}
    step = np.asarray(tree["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"step: {step.dtype} {step.shape}, want int32 ()")
    out["step"] = torch.tensor(int(step), dtype=torch.int32, device=dev)
    return out


def to_numpy(tree):
    """A tree of tensors (or a :class:`Model`) as the same tree of numpy
    arrays on the host (copies), the way back into the reference; bfloat16
    as ``ml_dtypes``' bfloat16, which the reference's JAX reads."""
    if isinstance(tree, Model):
        tree = tree.tree()

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # only where the reference runs
            return np.array(t.view(torch.int16).numpy()).view(
                ml_dtypes.bfloat16)
        return np.array(t.numpy())  # a copy: JAX never reads a port buffer
    return tree_map(leaf, tree)
