"""Paper Table 5 (left) on the PyTorch/CUDA port: the sine predictor, end
to end. The twin of ``examples/train_sine.py``.

Trains the paper's 1-16-16-1 ReLU MLP on sin(x) with the port's AdamW,
quantizes it to int8, deploys it through the interpreter and the compiled
engine, and evaluates MSE / RMSE with the paper's protocol (1000 test
samples, U(-0.1, 0.1) additive noise).

  PYTHONPATH=src python examples/torch_train_sine.py [--device cpu]

On the card by default, where the compiled engine runs every FC on the
hand-written ``qmatmul`` kernel; ``--device cpu`` runs the kernels' plain
versions.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.paper_models import build_sine
from repro_torch.core import CompiledModel
from repro_torch.core.device import resolve_device
from repro_torch.core.interpreter import Interpreter
from repro_torch.core.quantize import quantize_graph
from repro_torch.optim import adamw

LAYERS = ("l0", "l1", "l2")


def init_sine_weights(seed: int = 0):
    """The MLP's initial weights as ``[(w, b), ...]`` numpy arrays, drawn
    from a ``torch.Generator`` seeded by ``seed`` (the reference draws
    them from ``jax.random.PRNGKey(seed)``, which torch cannot reproduce).
    First-layer biases place the ReLU knots across [0, 2π]."""
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((1, 16), generator=gen)
    knots = torch.linspace(0.0, 2 * np.pi, 16)[None]
    w2 = torch.randn((16, 16), generator=gen) * 0.3
    w3 = torch.randn((16, 1), generator=gen) * 0.3
    return [(w1.numpy(), (-w1 * knots)[0].numpy()),
            (w2.numpy(), np.zeros(16, "f")), (w3.numpy(), np.zeros(1, "f"))]


def _fwd(p, x):
    h = torch.relu(x @ p["l0"]["w"] + p["l0"]["b"])
    h = torch.relu(h @ p["l1"]["w"] + p["l1"]["b"])
    return h @ p["l2"]["w"] + p["l2"]["b"]


def train_sine_weights(steps: int = 4000, seed: int = 0, *, init=None,
                       device="cuda"):
    """Train the paper's 1-16-16-1 ReLU MLP on sin(x) (AdamW, seconds):
    ``init`` (``[(w, b), ...]`` numpy, else :func:`init_sine_weights`),
    then ``steps`` steps of 128 samples of U(0, 2π) from
    ``np.random.default_rng(seed)``. Returns ``[(w, b), ...]`` numpy."""
    dev = resolve_device(device)
    init = init_sine_weights(seed) if init is None else init
    params = {k: {"w": torch.tensor(np.asarray(w, "f"), device=dev),
                  "b": torch.tensor(np.asarray(b, "f"), device=dev)}
              for k, (w, b) in zip(LAYERS, init)}
    leaves = [params[k][n] for k in LAYERS for n in ("w", "b")]
    opt_cfg = adamw.AdamWConfig(lr=5e-3, weight_decay=0.0, warmup_steps=50,
                                total_steps=steps, grad_clip=10.0)
    state = adamw.init(params)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        x = rng.uniform(0, 2 * np.pi, (128, 1)).astype("f")
        xt = torch.from_numpy(x).to(dev)
        yt = torch.from_numpy(np.sin(x)).to(dev)
        for t in leaves:
            t.requires_grad_(True)
        loss = torch.mean((_fwd(params, xt) - yt) ** 2)
        got = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        it = iter(got)
        grads = {k: {"w": next(it), "b": next(it)} for k in LAYERS}
        adamw.update(opt_cfg, grads, state, params)
    return [(params[k]["w"].cpu().numpy(), params[k]["b"].cpu().numpy())
            for k in LAYERS]


def sine_metrics(seed: int = 1, *, device="cuda", weights=None):
    """Table 5 left: MSE / RMSE of the float graph on the interpreter and
    of the int8 graph on the interpreter and the compiled engine (its
    kernel route), and whether the two int8 engines agree bit for bit."""
    weights = train_sine_weights(device=device) if weights is None \
        else weights
    g = build_sine(weights, batch=1000)
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 2 * np.pi, (1000, 1)).astype("f")
    target = np.sin(xs) + rng.uniform(-0.1, 0.1, (1000, 1)).astype("f")
    rep = [rng.uniform(0, 2 * np.pi, (1000, 1)).astype("f")
           for _ in range(3)]
    qg = quantize_graph(g, rep, device=device)

    out = {"float": np.asarray(Interpreter(g, device=device).invoke(xs)),
           "int8_interp": np.asarray(Interpreter(qg, device=device)
                                     .invoke(xs)),
           "int8_compiled": np.asarray(CompiledModel(
               qg, use_kernels=True, device=device).predict(xs))}
    res = {}
    for k, y in out.items():
        mse = float(np.mean((y - target) ** 2))
        res[k] = {"mse": mse, "rmse": float(np.sqrt(mse))}
    res["engines_equal"] = bool(
        np.array_equal(out["int8_interp"], out["int8_compiled"]))
    return res


def main(device: str = "cuda"):
    print("training the 1-16-16-1 sine MLP ...")
    res = sine_metrics(device=device)
    print(f"{'engine':16s} {'MSE':>8s} {'RMSE':>8s}   (paper: 0.0154/0.1241)")
    for k in ("float", "int8_interp", "int8_compiled"):
        print(f"{k:16s} {res[k]['mse']:8.4f} {res[k]['rmse']:8.4f}")
    print("int8 engines bit-identical:", res["engines_equal"])

    # deploy a single-sample predictor (the MCU interface)
    weights = train_sine_weights(steps=1000, device=device)
    g = build_sine(weights, batch=1)
    rng = np.random.default_rng(0)
    qg = quantize_graph(
        g, [rng.uniform(0, 2 * np.pi, (1, 1)).astype("f")
            for _ in range(64)], device=device)
    cm = CompiledModel(qg, use_kernels=True, device=device)
    cm.compile()
    for xv in (0.5, 1.57, 3.14, 4.71):
        y = float(np.asarray(cm.predict(np.array([[xv]], "f"))).item())
        print(f"predict sin({xv:4.2f}) = {y:+.3f}   (true {np.sin(xv):+.3f})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    main(ap.parse_args().device)
