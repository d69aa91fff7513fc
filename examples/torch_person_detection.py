"""Paper Table 3 / Figs. 10-11 (right) on the PyTorch/CUDA port: the
MobileNetV1 person detector through the compiled engine — memory plan,
parity with the interpreter, and latency. The twin of
``examples/person_detection.py``.

  PYTHONPATH=src python examples/torch_person_detection.py [--device cpu]

On the card by default (the compiled engine on the hand-written CUDA
kernels, one CUDA-graph replay per inference); ``--device cpu`` runs the
kernels' plain versions.
"""
import argparse
import time

import numpy as np

from repro_torch.configs.paper_models import build_person
from repro_torch.core import CompiledModel
from repro_torch.core.interpreter import Interpreter
from repro_torch.core.memory import memory_report
from repro_torch.core.quantize import quantize_graph

TIMING_REPS = 30  # inferences timed per engine


def main(device: str = "cuda"):
    rng = np.random.default_rng(0)
    gen = lambda: rng.normal(0, 1, (1, 96, 96, 1)).astype("f")

    print("building MobileNetV1 α=0.25 (96×96 gray) ...")
    g = build_person()
    qg = quantize_graph(g, [gen() for _ in range(8)], device=device)
    print(f"  {len(qg.ops)} operator layers, weights "
          f"{qg.weight_bytes/1024:.0f} kB (paper: ~300 kB model file)")

    rep = memory_report(qg)
    print(f"  interpreter arena : {rep.arena_bytes/1024:7.1f} kB")
    print(f"  compiled stack    : {rep.stack_peak_bytes/1024:7.1f} kB peak")
    print(f"  folded constants  : {rep.folded_const_bytes/1024:7.1f} kB")

    interp = Interpreter(qg, device=device)
    cm = CompiledModel(qg, device=device)
    cm.compile()
    x = gen()
    qx = np.asarray(qg.tensor(qg.inputs[0]).qparams.quantize(x))

    yi = np.asarray(interp.invoke_q(qx))
    yc = np.asarray(cm.predict_q(qx))
    assert np.array_equal(yi, yc)
    probs = qg.tensor(qg.outputs[0]).qparams.dequantize(yc)
    print(f"  engines agree ✓  P(person)={float(probs[0,1]):.3f}")

    for name, fn in (("interpreter", lambda: interp.invoke_q(qx)),
                     ("compiled", lambda: np.asarray(cm.predict_q(qx)))):
        ts = []
        for _ in range(TIMING_REPS):
            t0 = time.perf_counter()
            fn()  # numpy out: the device work is done
            ts.append(time.perf_counter() - t0)
        print(f"  {name:12s} median {np.median(ts)*1e3:7.2f} ms/inference")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    main(ap.parse_args().device)
