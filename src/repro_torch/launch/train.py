"""Training launcher (the port of ``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b-smoke \\
      --steps 50 --batch 8 --seq 64 --ckpt-dir /tmp/ckpt [--device cpu]

Runs real training on one device: on the card unless ``--device`` says
otherwise. Any registered arch id works, ``<id>-smoke`` selects the reduced
variant, and ``--layers N`` cuts the depth to N layers in whole periods.
``--mesh local`` (the default) is the reference's one-device mesh, so
nothing is sharded. ``--mesh single|multi`` builds the production mesh over
the launched world (a process group of 256 / 512 ranks, under ``torchrun``
or a fake one) and computes every parameter's placements on it; as in the
reference, whose ``jax.jit`` gets no ``in_shardings``, they are not
applied, and the run trains as ``--mesh local`` does. With ``--ckpt-dir``
the run resumes from the latest step there and saves every
``--ckpt-every`` steps.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config
from ..core.device import resolve_device
from ..data.pipeline import DataConfig, SyntheticLM, frontend_stub
from ..models import model as M
from ..models.layers import tree_leaves, tree_map
from ..optim import adamw
from ..train import checkpoint as CKPT
from ..train.step import make_train_step
from . import sharding as SH
from .mesh import axis_sizes, make_production_mesh
from .serve import DTYPES, cut_depth


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (whole periods)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.layers:
        cfg = cut_depth(cfg, args.layers)
    params = M.trainable(M.init_params(cfg, args.seed, DTYPES[args.dtype],
                                       max_seq=args.seq, device=args.device))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10,
                                                             1),
                                total_steps=args.steps)
    opt_state = adamw.init(params)

    start = 0
    if args.ckpt_dir:
        last = CKPT.latest_step(args.ckpt_dir)
        if last is not None:
            CKPT.restore({"params": params.tree(), "opt": opt_state},
                         CKPT.step_path(args.ckpt_dir, last), inplace=True)
            start = last
            print(f"[train] resumed from step {start}")

    data = SyntheticLM(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                  seed=args.seed))
    stub_rng = np.random.default_rng(args.seed)

    step_fn = make_train_step(cfg, opt_cfg, remat=args.remat)
    if args.mesh != "local":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device_type=resolve_device(
                                        args.device).type)
        placements = tree_map(lambda s: SH.to_placements(s, mesh),
                              SH.param_specs(params.tree(), mesh))
        print(f"[train] mesh {args.mesh} {axis_sizes(mesh)}: placements of "
              f"{len(tree_leaves(placements))} parameters computed, not "
              "applied (as the reference's)")
    t0 = time.time()
    losses = []
    for step in range(start, args.steps):
        batch = data.batch(step)
        batch.update(frontend_stub(cfg, args.batch, stub_rng))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({time.time()-t0:.1f}s)")
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            CKPT.save({"params": params, "opt": opt_state},
                      CKPT.step_path(args.ckpt_dir, step + 1))
    print(f"[train] done: first loss {losses[0]:.4f} "
          f"last loss {losses[-1]:.4f}")
    return losses


if __name__ == "__main__":
    main()
