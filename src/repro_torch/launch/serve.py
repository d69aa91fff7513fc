"""Serving launcher: batched requests through prefill + greedy decode (the
port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-3b-smoke \\
      --batch 4 --prompt-len 16 --max-new 16 --quantized [--device cpu]

Without ``--device`` it runs on the card. ``--layers N`` cuts the depth to
N layers, in whole periods of the config's layer pattern, for a config
whose weights do not fit.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import frontend_stub
from ..models import model as M
from ..serve.engine import ServeSession
from ..serve.quantized import param_bytes

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cut_depth(cfg, layers: int):
    """``cfg`` with ``layers`` decoder layers, a whole number of periods."""
    period = len(cfg.pattern())
    if layers <= 0 or layers % period:
        raise ValueError(f"--layers {layers}: {cfg.name} needs a positive "
                         f"multiple of its period, {period}")
    return dataclasses.replace(cfg, n_layers=layers)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (whole periods)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    dtype = DTYPES[args.dtype]
    rng = np.random.default_rng(args.seed)
    model = M.init_params(cfg, args.seed, dtype, max_seq=args.max_seq,
                          device=args.device)
    float_bytes = param_bytes(model.tree())
    sess = ServeSession(cfg, model, max_seq=args.max_seq,
                        quantized=args.quantized, dtype=dtype,
                        device=args.device)
    del model
    resident = param_bytes(sess.params if args.quantized
                           else sess.model.tree())
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.batch, args.prompt_len)).astype(np.int32)
    extra = frontend_stub(cfg, args.batch, rng)

    t0 = time.time()
    out = sess.generate(prompts, args.max_new, extra_inputs=extra or None)
    dt = time.time() - t0
    toks = args.batch * args.max_new
    print(f"[serve] arch={cfg.name} quantized={args.quantized} "
          f"batch={args.batch} new={args.max_new} -> {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    print("[serve] sample:", out[0][:12].tolist())
    print(f"[serve] device={sess.device} dtype={args.dtype} "
          f"layers={cfg.n_layers} param_count={cfg.param_count()} "
          f"weight_bytes={resident} float_weight_bytes={float_bytes}")
    return out


if __name__ == "__main__":
    main()
