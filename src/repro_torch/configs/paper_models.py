"""The paper's three evaluation models (Table 3) — the port's copy of
``repro.configs.paper_models``, with the same seeds and therefore the same
float weights.

* sine predictor  — 3×FullyConnected(16) + ReLU, ~3 kB
* speech command  — TinyConv on a 49×40 spectrogram, ~19 kB
* person detector — MobileNetV1 α=0.25 on 96×96 grayscale, ~300 kB
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import graph as G
from repro_torch.core.builder import GraphBuilder


def build_sine(weights=None, batch: int = 1) -> G.Graph:
    """x (B,1) -> sin(x) (B,1): FC16-ReLU, FC16-ReLU, FC1."""
    rng = np.random.default_rng(0)
    if weights is None:
        weights = [
            (rng.normal(0, 1.0, (1, 16)).astype("f"),
             rng.normal(0, 0.5, 16).astype("f")),
            (rng.normal(0, 0.5, (16, 16)).astype("f"),
             rng.normal(0, 0.5, 16).astype("f")),
            (rng.normal(0, 0.5, (16, 1)).astype("f"),
             rng.normal(0, 0.5, 1).astype("f")),
        ]
    b = GraphBuilder("sine_predictor")
    x = b.input("x", (batch, 1))
    h = b.fully_connected(x, *weights[0], fused="RELU", name="fc1")
    h = b.fully_connected(h, *weights[1], fused="RELU", name="fc2")
    y = b.fully_connected(h, *weights[2], name="fc3")
    b.output(y)
    return b.build()


def build_speech(weights=None, batch: int = 1) -> G.Graph:
    """TinyConv: spectrogram (B,49,40,1) -> 4 classes
    (yes / no / silence / unknown)."""
    rng = np.random.default_rng(1)
    if weights is None:
        conv_w = rng.normal(0, 0.2, (10, 8, 1, 8)).astype("f")
        conv_b = rng.normal(0, 0.1, 8).astype("f")
        fc_w = rng.normal(0, 0.05, (25 * 20 * 8, 4)).astype("f")
        fc_b = rng.normal(0, 0.05, 4).astype("f")
        weights = (conv_w, conv_b, fc_w, fc_b)
    conv_w, conv_b, fc_w, fc_b = weights
    b = GraphBuilder("speech_command")
    x = b.input("x", (batch, 49, 40, 1))
    h = b.conv2d(x, conv_w, conv_b, stride=(2, 2), padding="SAME",
                 fused="RELU", name="conv")
    h = b.reshape(h, (batch, 25 * 20 * 8))
    h = b.fully_connected(h, fc_w, fc_b, name="fc")
    y = b.softmax(h)
    b.output(y)
    return b.build()


# MobileNetV1 α=0.25 plan: (out_channels, stride) per dw/pw block
_MOBILENET_BLOCKS = [
    (16, 1), (32, 2), (32, 1), (64, 2), (64, 1), (128, 2),
    (128, 1), (128, 1), (128, 1), (128, 1), (128, 1), (256, 2), (256, 1),
]


def build_person(batch: int = 1, seed: int = 2) -> G.Graph:
    """MobileNetV1 α=0.25 person detector: (B,96,96,1) -> 2 classes
    (person / not-person). ~30 operator layers, ~300 kB int8."""
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.3):
        return rng.normal(0, s, shape).astype("f")

    b = GraphBuilder("person_detector")
    x = b.input("x", (batch, 96, 96, 1))
    h = b.conv2d(x, w(3, 3, 1, 8), w(8, s=0.1), stride=(2, 2),
                 padding="SAME", fused="RELU6", name="conv0")
    cin = 8
    for i, (cout, stride) in enumerate(_MOBILENET_BLOCKS):
        h = b.depthwise_conv2d(h, w(3, 3, cin, 1), w(cin, s=0.1),
                               stride=(stride, stride), padding="SAME",
                               fused="RELU6", name=f"dw{i}")
        h = b.conv2d(h, w(1, 1, cin, cout, s=0.4), w(cout, s=0.1),
                     padding="SAME", fused="RELU6", name=f"pw{i}")
        cin = cout
    h = b.average_pool2d(h, (3, 3), name="avgpool")   # 3×3×256 -> 1×1×256
    h = b.reshape(h, (batch, 256))
    h = b.fully_connected(h, w(256, 2, s=0.2), w(2, s=0.1), name="fc")
    y = b.softmax(h)
    b.output(y)
    return b.build()


PAPER_MODELS = {
    "sine": build_sine,
    "speech": build_speech,
    "person": build_person,
}
