"""End-to-end LLM serving driver on the PyTorch/CUDA port, the twin of
``examples/serve_llm.py``.

Trains a small LM briefly on the synthetic permutation task so generation is
meaningfully non-random, then serves BATCHED requests through prefill +
greedy decode, in fp32 and int8 weight-only (the paper's quantization at LLM
scale), comparing outputs and throughput.

  PYTHONPATH=src python examples/torch_serve_llm.py [--steps 60] [--device cpu]

On the card by default; ``--device cpu`` runs on the CPU.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.serve.engine import ServeSession
from repro_torch.train.step import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("stablelm-3b").reduced()
    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model})")

    # -- short training run on the synthetic next-token task --------------
    data = SyntheticLM(DataConfig(cfg.vocab_size, 32, 8, seed=0))
    params = M.trainable(M.init_params(cfg, 0, torch.float32, max_seq=256,
                                       device=args.device))
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5,
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    step = make_train_step(cfg, opt_cfg)
    for s in range(args.steps):
        params, opt_state, m = step(params, opt_state, data.batch(s))
        if s % 20 == 0 or s == args.steps - 1:
            print(f"  train step {s:3d} loss {float(m['loss']):.3f}")
    M.trainable(params, False)  # frozen for serving

    # -- batched serving ---------------------------------------------------
    prompts = data.batch(10_000)["tokens"][:args.batch, :16]

    for quantized in (False, True):
        sess = ServeSession(cfg, params, max_seq=256, quantized=quantized,
                            device=args.device)
        t0 = time.time()
        out = sess.generate(prompts, args.max_new)
        dt = time.time() - t0
        toks = args.batch * args.max_new
        # quality: fraction of generated tokens following the synthetic
        # permutation rule (0.9 is the Bayes ceiling at 10% noise)
        follow = float(np.mean(
            data.perm[out[:, :-1].ravel()] == out[:, 1:].ravel()))
        tag = "int8" if quantized else "fp32"
        print(f"[{tag}] {toks} tokens in {dt:.2f}s ({toks/dt:6.1f} tok/s)  "
              f"rule-following {follow:.2f}")
        if not quantized:
            ref = out
    agree = float(np.mean(ref == out))
    print(f"int8 vs fp32 token agreement: {agree:.2f}")


if __name__ == "__main__":
    main()
