"""Deterministic synthetic data pipeline (the port of
``repro.data.pipeline``; numpy only, as there).

A seeded, stateless token stream: each batch is derived from its step
index, so any worker or restart reproduces the same data. The synthetic
task is a learnable k-gram language: token t+1 is a fixed random
permutation of token t, mixed with noise.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.perm = rng.permutation(cfg.vocab_size)

    def batch(self, step: int) -> dict:
        """tokens (B, T) and labels (B, T) int32, labels shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, T = cfg.global_batch, cfg.seq_len
        toks = np.empty((B, T + 1), np.int64)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        noise = rng.random((B, T)) < cfg.noise
        rand = rng.integers(0, cfg.vocab_size, (B, T))
        for t in range(T):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def shard(self, batch: dict, mesh) -> dict:
        """Each array of ``batch`` as a DTensor on ``mesh``, under
        ``batch_spec``'s placements (the batch dimension over the data
        axes where it divides). Every rank derives the same batch from
        the step index, so each keeps its own rows without
        communication."""
        import torch

        from ..launch import sharding as SH
        return {k: SH.distribute(torch.as_tensor(v),
                                 SH.batch_spec(np.shape(v), mesh), mesh)
                for k, v in batch.items()}


def frontend_stub(cfg, B, rng=None):
    """STUB modality frontends: precomputed patch / frame embeddings of the
    right shape (float32 numpy)."""
    rng = rng or np.random.default_rng(0)
    extra = {}
    if cfg.modality == "vision":
        extra["patches"] = rng.normal(
            0, 1, (B, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_layers:
        extra["frames"] = rng.normal(
            0, 1, (B, cfg.n_frames, cfg.d_model)).astype(np.float32)
    return extra
