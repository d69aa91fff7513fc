"""The one module of the harness that imports the program (``repro_torch``):
it hands a qmodel (:mod:`portbench.model`) to the program as the program's
own int8 graph, with a leading batch dimension of 1 on every activation
(a request is one such sample), and builds the program's engine on it."""
from __future__ import annotations

import numpy as np

_FUSED = {"RELU", "RELU6", "NONE"}


def to_graph(qmodel):
    """The program's ``Graph`` of ``qmodel``: the same int8 weights, int32
    biases, scales and zero points; everything else (folding, layout,
    pads) is the program's to derive."""
    from repro_torch.core import graph as G

    tensors, ops = [], []

    def act(name, shape, q):
        tensors.append(G.TensorSpec(name, (1,) + tuple(shape), "int8",
                                    G.QParams(np.float32(q[0]),
                                              np.int32(q[1]))))
        return len(tensors) - 1

    def const(name, data, dtype, scale, axis):
        tensors.append(G.TensorSpec(
            name, data.shape, dtype,
            G.QParams(scale, np.zeros(scale.shape, np.int32), axis), data))
        return len(tensors) - 1

    x = act("x", qmodel["input"], qmodel["input_q"])
    inputs = [x]
    for lay in qmodel["layers"]:
        op, name = lay["op"], lay["name"]
        y = act(f"{name}/out", lay["out_shape"], lay["out_q"])
        if op in ("conv", "dwconv", "fc"):
            if lay["fused"] not in _FUSED:
                raise ValueError(f"{name}: fused {lay['fused']!r}")
            axis = {"conv": 3, "dwconv": 2, "fc": 1}[op]
            w = const(f"{name}/w", lay["w"], "int8", lay["w_scale"], axis)
            b = const(f"{name}/b", lay["b"], "int32", lay["b_scale"], 0)
            kind = {"conv": G.CONV_2D, "dwconv": G.DEPTHWISE_CONV_2D,
                    "fc": G.FULLY_CONNECTED}[op]
            attrs = {"fused": lay["fused"]}
            if op != "fc":
                attrs.update(stride=tuple(lay["stride"]), padding="SAME")
            ops.append(G.OpNode(kind, [x, w, b], [y], attrs))
        elif op == "avgpool":
            ops.append(G.OpNode(G.AVERAGE_POOL_2D, [x], [y],
                                {"window": tuple(lay["window"]),
                                 "stride": tuple(lay["window"]),
                                 "padding": "VALID", "fused": "NONE"}))
        elif op == "reshape":
            ops.append(G.OpNode(G.RESHAPE, [x], [y],
                                {"new_shape": (1,) + tuple(lay["out_shape"])}))
        elif op == "softmax":
            ops.append(G.OpNode(G.SOFTMAX, [x], [y], {"axis": -1}))
        else:
            raise ValueError(f"unknown op {op!r}")
        x = y
    g = G.Graph(tensors, ops, inputs, [x], qmodel["name"] + "_int8")
    g.validate()
    return g


def compiled_model(qmodel, device):
    """The program's engine on ``qmodel``, on its default route: the CUDA
    kernels with the layout plan on the card, their plain versions on the
    CPU."""
    from repro_torch.core import CompiledModel
    return CompiledModel(to_graph(qmodel), device=device)
