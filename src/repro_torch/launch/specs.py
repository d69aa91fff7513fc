"""Abstract input specs for every (arch × input shape); the port of
``repro.launch.specs``. A :class:`TensorSpec` is a shape and a dtype and
allocates nothing; the dry run makes meta tensors of them
(:func:`meta`), a real run real ones (:func:`materialize`).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.base import ArchConfig, InputShape
from ..models import model as M
from ..models.layers import tree_map

PARAM_DTYPE = torch.bfloat16
CACHE_DTYPE = torch.bfloat16

SLIDING_WINDOW_500K = 8192


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """The shape and dtype of one tensor (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


def meta(tree):
    """Meta tensors of a tree of :class:`TensorSpec`: no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def materialize(tree, device, seed: int = 0):
    """Real tensors of a tree of :class:`TensorSpec` on ``device``: floats
    N(0, 0.02), integers in [0, 2) (valid token ids and a decode position
    of 0 or 1), drawn in the tree's order."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(s):
        if s.dtype.is_floating_point:
            return (torch.randn(s.shape, generator=gen, device=device)
                    * 0.02).to(s.dtype)
        return torch.randint(0, 2, s.shape, generator=gen, device=device,
                             dtype=s.dtype)
    return tree_map(make, tree)


def effective_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Per-shape architecture policy: long_500k requires sub-quadratic
    attention, so full-attention archs get the sliding-window decode
    variant."""
    if shape.name == "long_500k" and not cfg.sub_quadratic \
            and not cfg.attention_free and cfg.family != "audio":
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_500K)
    return cfg


def skip_reason(cfg: ArchConfig, shape: InputShape):
    if shape.name == "long_500k" and cfg.family == "audio":
        return ("enc-dec decoder context is architecturally bounded by the "
                "encoder (1500 frames); a 524k decoder cache contradicts the "
                "architecture (DESIGN.md)")
    return None


def local_batch(shape: InputShape, n_data_shards: int = 1) -> int:
    return max(shape.global_batch, 1)


def token_specs(cfg: ArchConfig, B: int, T: int) -> dict:
    s = {"tokens": TensorSpec((B, T), torch.int32)}
    if cfg.modality == "vision":
        s["patches"] = TensorSpec((B, cfg.n_patches, cfg.frontend_dim),
                                  PARAM_DTYPE)
    if cfg.encoder_layers:
        s["frames"] = TensorSpec((B, cfg.n_frames, cfg.d_model), PARAM_DTYPE)
    return s


def param_shapes(cfg: ArchConfig, max_seq: int):
    return tree_map(lambda i: TensorSpec(tuple(i.shape), i.dtype),
                    M.param_specs(cfg, PARAM_DTYPE, max_seq=max_seq))


def opt_shapes(params_shapes):
    """``repro_torch.optim.adamw.init``'s tree: float32 moments, int32
    step."""
    f32 = lambda s: TensorSpec(s.shape, torch.float32)  # noqa: E731
    return {"mu": tree_map(f32, params_shapes),
            "nu": tree_map(f32, params_shapes),
            "step": TensorSpec((), torch.int32)}


def cache_shapes(cfg: ArchConfig, B: int, S: int):
    return tree_map(lambda sd: TensorSpec(tuple(sd[0]), sd[1]),
                    M.cache_shapes(cfg, B, S, CACHE_DTYPE))


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Everything the step function for this (arch, shape) consumes."""
    cfg = effective_config(cfg, shape)
    B, T = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        batch = token_specs(cfg, B, T)
        batch["labels"] = TensorSpec((B, T), torch.int32)
        params = param_shapes(cfg, max_seq=T)
        return {"params": params, "opt_state": opt_shapes(params),
                "batch": batch}
    if shape.kind == "prefill":
        batch = token_specs(cfg, B, T)
        params = param_shapes(cfg, max_seq=T)
        return {"params": params, "batch": batch,
                "cache": cache_shapes(cfg, B, T)}
    # decode: ONE new token against a cache of capacity seq_len
    params = param_shapes(cfg, max_seq=T + 1)
    return {"params": params,
            "tokens": TensorSpec((B, 1), torch.int32),
            "cache": cache_shapes(cfg, B, T),
            "pos": TensorSpec((), torch.int32)}
