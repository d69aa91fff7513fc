"""Quickstart on the PyTorch/CUDA port: author a small CNN, quantize it, and
run it through the port's engines — the interpreter baseline (TFLM
architecture), the compiled engine (MicroFlow architecture) and the
compiled engine on the hand-written CUDA kernels — then compare memory
plans. The twin of ``examples/quickstart.py``.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

On the card by default; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import CompiledModel
from repro_torch.core import graph as G
from repro_torch.core.builder import GraphBuilder
from repro_torch.core.interpreter import Interpreter
from repro_torch.core.memory import memory_report
from repro_torch.core.quantize import quantize_graph


def main(device: str = "cuda"):
    rng = np.random.default_rng(0)

    # 1. Author a float model (normally this comes from your training code).
    b = GraphBuilder("quickstart_cnn")
    x = b.input("image", (1, 16, 16, 3))
    h = b.conv2d(x, rng.normal(0, 0.3, (3, 3, 3, 8)).astype("f"),
                 rng.normal(size=8).astype("f"), stride=(2, 2),
                 padding="SAME", fused="RELU6")
    h = b.depthwise_conv2d(h, rng.normal(0, 0.3, (3, 3, 8, 1)).astype("f"),
                           rng.normal(size=8).astype("f"), padding="SAME",
                           fused="RELU")
    h = b.average_pool2d(h, (8, 8))
    h = b.reshape(h, (1, 8))
    h = b.fully_connected(h, rng.normal(0, 0.3, (8, 4)).astype("f"), None)
    h = b.softmax(h)
    b.output(h)
    fg = b.build()

    # 2. Post-training int8 quantization (Eq. 1) with representative data.
    rep = [rng.normal(0, 1, (1, 16, 16, 3)).astype("f") for _ in range(16)]
    qg = quantize_graph(fg, rep, device=device)
    print(f"quantized: {len(qg.ops)} ops, weights {qg.weight_bytes} B")

    # 3. Save / load the model (the JAX package's on-disk format, byte for
    #    byte; no msgpack needed).
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "quickstart.mfg")
        G.save(qg, path)
        loaded = G.load(path)

    # 4. Run through the engines.
    x = rng.normal(0, 1, (1, 16, 16, 3)).astype("f")
    interp = Interpreter(qg, device=device)           # TFLM-style baseline
    compiled = CompiledModel(qg, use_kernels=False, device=device)
    compiled.compile()                                # the "target binary"
    kernels = CompiledModel(qg, use_kernels=True, device=device)  # CUDA kernels

    yi = interp.invoke(x)
    yc = compiled.predict(x)
    yk = kernels.predict(x)
    print("interpreter:", np.round(yi, 4))
    print("compiled:   ", np.round(yc, 4))
    print("kernels:    ", np.round(yk, 4))
    assert np.array_equal(yi, yc) and np.array_equal(yc, yk)
    print("engines agree bit-exactly ✓")
    yl = CompiledModel(loaded, use_kernels=True, device=device).predict(x)
    assert np.array_equal(yl, yk)
    print("saved and reloaded graph runs bit-identically ✓")

    # 5. The paper's memory story (Figs. 9/10): arena vs ownership stack.
    rep_ = memory_report(qg)
    print(f"weights          : {rep_.weight_bytes:7d} B")
    print(f"interpreter arena: {rep_.arena_bytes:7d} B  (held all inference)")
    print(f"compiled peak    : {rep_.stack_peak_bytes:7d} B  (transient)")
    print(f"folded constants : {rep_.folded_const_bytes:7d} B  (compile-time)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    main(ap.parse_args().device)
