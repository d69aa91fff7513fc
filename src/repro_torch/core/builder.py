"""Float-graph builder — the port's copy of ``repro.core.builder``: the
front-end used to author models before quantization."""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import graph as G


def _require(cond: bool, msg) -> None:
    if not cond:
        raise ValueError(msg)


class GraphBuilder:
    def __init__(self, name: str = "model"):
        self.g = G.Graph(tensors=[], ops=[], inputs=[], outputs=[], name=name)

    # -- tensors ------------------------------------------------------------
    def input(self, name: str, shape) -> int:
        tid = self.g.add_tensor(G.TensorSpec(name, tuple(shape), "float32"))
        self.g.inputs.append(tid)
        return tid

    def const(self, name: str, data: np.ndarray) -> int:
        data = np.asarray(data, np.float32)
        return self.g.add_tensor(
            G.TensorSpec(name, data.shape, "float32", data=data))

    def _act(self, name: str, shape) -> int:
        return self.g.add_tensor(G.TensorSpec(name, tuple(shape), "float32"))

    def output(self, tid: int) -> None:
        self.g.outputs.append(tid)

    def _weighted(self, x: int, wdata, b, name: str, wname: str):
        ins = [x, self.const(f"{name}/{wname}", wdata)]
        if b is not None:
            ins.append(self.const(f"{name}/b", np.asarray(b, np.float32)))
        return ins

    # -- ops ----------------------------------------------------------------
    def fully_connected(self, x: int, w: np.ndarray, b: Optional[np.ndarray],
                        fused: str = "NONE", name: str = "fc") -> int:
        w = np.asarray(w, np.float32)
        m = self.g.tensor(x).shape[0]
        ins = self._weighted(x, w, b, name, "w")
        y = self._act(f"{name}/out", (m, w.shape[1]))
        self.g.ops.append(G.OpNode(G.FULLY_CONNECTED, ins, [y], {"fused": fused}))
        return y

    def conv2d(self, x: int, f: np.ndarray, b: Optional[np.ndarray],
               stride=(1, 1), padding="SAME", fused: str = "NONE",
               name: str = "conv") -> int:
        f = np.asarray(f, np.float32)
        bsz, h, w, cin = self.g.tensor(x).shape
        kh, kw, fcin, cout = f.shape
        _require(fcin == cin, (fcin, cin))
        oh, ow = G.conv_out_hw(h, w, kh, kw, stride, padding)
        ins = self._weighted(x, f, b, name, "f")
        y = self._act(f"{name}/out", (bsz, oh, ow, cout))
        self.g.ops.append(G.OpNode(
            G.CONV_2D, ins, [y],
            {"stride": tuple(stride), "padding": padding, "fused": fused}))
        return y

    def depthwise_conv2d(self, x: int, wgt: np.ndarray, b: Optional[np.ndarray],
                         stride=(1, 1), padding="SAME", fused: str = "NONE",
                         name: str = "dwconv") -> int:
        wgt = np.asarray(wgt, np.float32)
        bsz, h, w, c = self.g.tensor(x).shape
        kh, kw, wc, mult = wgt.shape
        _require(wc == c and mult == 1, (wgt.shape, c))
        oh, ow = G.conv_out_hw(h, w, kh, kw, stride, padding)
        ins = self._weighted(x, wgt, b, name, "w")
        y = self._act(f"{name}/out", (bsz, oh, ow, c))
        self.g.ops.append(G.OpNode(
            G.DEPTHWISE_CONV_2D, ins, [y],
            {"stride": tuple(stride), "padding": padding, "fused": fused}))
        return y

    def _pool(self, kind: str, x: int, window, stride, padding, name) -> int:
        bsz, h, w, c = self.g.tensor(x).shape
        stride = tuple(stride) if stride is not None else tuple(window)
        oh, ow = G.conv_out_hw(h, w, window[0], window[1], stride, padding)
        y = self._act(f"{name}/out", (bsz, oh, ow, c))
        self.g.ops.append(G.OpNode(
            kind, [x], [y],
            {"window": tuple(window), "stride": stride, "padding": padding,
             "fused": "NONE"}))
        return y

    def average_pool2d(self, x: int, window, stride=None, padding="VALID",
                       name: str = "avgpool") -> int:
        return self._pool(G.AVERAGE_POOL_2D, x, window, stride, padding, name)

    def max_pool2d(self, x: int, window, stride=None, padding="VALID",
                   name: str = "maxpool") -> int:
        return self._pool(G.MAX_POOL_2D, x, window, stride, padding, name)

    def add(self, a: int, b: int, fused: str = "NONE",
            name: str = "add") -> int:
        sa, sb = self.g.tensor(a).shape, self.g.tensor(b).shape
        _require(sa == sb, (sa, sb))
        y = self._act(f"{name}/out", sa)
        self.g.ops.append(G.OpNode(G.ADD, [a, b], [y], {"fused": fused}))
        return y

    def pad(self, x: int, pads, name: str = "pad") -> int:
        old = self.g.tensor(x).shape
        pads = tuple((int(lo), int(hi)) for lo, hi in pads)
        _require(len(pads) == len(old), (pads, old))
        new = tuple(d + lo + hi for d, (lo, hi) in zip(old, pads))
        y = self._act(f"{name}/out", new)
        self.g.ops.append(G.OpNode(G.PAD, [x], [y], {"pads": pads}))
        return y

    def reshape(self, x: int, new_shape, name: str = "reshape") -> int:
        old = self.g.tensor(x).shape
        new_shape = tuple(int(d) for d in new_shape)
        _require(int(np.prod(old)) == int(np.prod(new_shape)), (old, new_shape))
        y = self._act(f"{name}/out", new_shape)
        self.g.ops.append(G.OpNode(G.RESHAPE, [x], [y], {"new_shape": new_shape}))
        return y

    def relu(self, x: int, name: str = "relu") -> int:
        y = self._act(f"{name}/out", self.g.tensor(x).shape)
        self.g.ops.append(G.OpNode(G.RELU, [x], [y], {}))
        return y

    def relu6(self, x: int, name: str = "relu6") -> int:
        y = self._act(f"{name}/out", self.g.tensor(x).shape)
        self.g.ops.append(G.OpNode(G.RELU6, [x], [y], {}))
        return y

    def softmax(self, x: int, axis: int = -1, name: str = "softmax") -> int:
        y = self._act(f"{name}/out", self.g.tensor(x).shape)
        self.g.ops.append(G.OpNode(G.SOFTMAX, [x], [y], {"axis": axis}))
        return y

    def build(self) -> G.Graph:
        _require(bool(self.g.outputs), "no outputs marked")
        self.g.validate()
        return self.g
