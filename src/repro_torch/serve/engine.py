"""Batched LLM serving: prefill + greedy decode with a KV/SSM cache updated
in place (the port of ``repro.serve.engine``).

The reference donates the cache buffer to each jitted step (the paper's
ownership transfer, Sec. 4.1). Here the cache tensors are allocated once
per :meth:`ServeSession.generate`, and prefill and every decode step write
into them: their ``data_ptr()``s never change, nothing is copied and
nothing else is allocated for the cache.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..core.device import resolve_device
from ..models import model as M
from ..models.layers import tree_map
from .quantized import dequantize_params, quantize_params


class ServeSession:
    """``model_or_params``: a :class:`~repro_torch.models.model.Model` or a
    tree of tensors. With ``quantized`` the session keeps int8 weights
    (:func:`~repro_torch.serve.quantized.quantize_params`) and a
    parameterless skeleton of the module; every step runs through
    ``torch.func.functional_call`` on the dequantized weights, as the
    reference dequantizes inside every step. ``dtype`` is the cache's."""

    def __init__(self, cfg, model_or_params, max_seq: int = 512,
                 quantized: bool = False, dtype=torch.float32,
                 device="cuda"):
        self.cfg = cfg
        self.max_seq = max_seq
        self.dtype = dtype
        self.quantized = quantized
        self.device = resolve_device(device)
        model = model_or_params
        if not isinstance(model, M.Model):
            model = M.Model(cfg, model)
        if quantized:
            self.params = quantize_params(
                {k: v.to(self.device) for k, v in model.named_parameters()})
            self.model = M.Model(cfg, tree_map(lambda t: t.to("meta"),
                                               model.tree()))
        else:
            self.model = model.to(self.device)
            self.params = None

    def run(self, op: str, *args):
        """``op`` ("prefill", "decode_step", ...) on the session's weights."""
        if self.quantized:
            return functional_call(self.model,
                                   dequantize_params(self.params),
                                   (op,) + args)
        return self.model(op, *args)

    def init_cache(self, B: int):
        return M.init_cache(self.cfg, B, self.max_seq, self.dtype,
                            self.device)

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int,
                 extra_inputs=None) -> np.ndarray:
        """prompts (B, Tp) int32 -> (B, max_new) greedy continuation."""
        B, Tp = prompts.shape
        cache = self.init_cache(B)
        batch = {"tokens": torch.as_tensor(np.asarray(prompts, np.int32),
                                           device=self.device)}
        if extra_inputs:
            batch.update({k: torch.as_tensor(v, device=self.device)
                          for k, v in extra_inputs.items()})
        logits, cache = self.run("prefill", batch, cache)
        n_prefix = (self.cfg.n_patches
                    if self.cfg.modality == "vision" and "patches" in batch
                    else 0)
        out = np.zeros((B, max_new), np.int32)
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(max_new):
            out[:, i] = tok[:, 0].cpu().numpy()
            logits, cache = self.run("decode_step", tok, cache,
                                     Tp + n_prefix + i)
            tok = logits[:, -1].argmax(-1)[:, None]
        return out
