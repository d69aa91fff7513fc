"""The benchmark's own count of a forward's work, frozen here so that a
change to the program cannot move the yardstick. The rules are those of
the program's ``cost_of_plan`` as they stood when the benchmark was
written:

* ``flops``: products only, 2 a multiply-add, for FC, CONV_2D and
  DEPTHWISE_CONV_2D (``2·rows·K·N``, ``2·rows·OH·OW·KH·KW·Cin·Cout``,
  ``2·rows·OH·OW·KH·KW·C``); pools, reshape, softmax and the requant add
  none;
* ``bytes``: every op reads each operand once and writes its output once at
  its stored dtype (int8 activations and weights, int32 biases); RESHAPE is
  a view and moves nothing; lane pads, im2col copies and folded constants
  are how a route implements an op and are left out;
* ``transcendentals``: one ``exp`` per softmax input element.

A call of ``rows`` rows counts each activation ``rows`` times and each
weight once, so ``calls`` calls that answer ``rows`` rows in all count
``calls`` times the weights.
"""
from __future__ import annotations

import numpy as np

_BYTES = {"int8": 1, "int32": 4}


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64))


def op_cost(lay) -> dict:
    """One layer's work: ``flops`` and ``transcendentals`` a row, ``act``
    bytes a row (its activation input and output) and ``weight`` bytes a
    call (weights and bias)."""
    op, x, y = lay["op"], lay["in_shape"], lay["out_shape"]
    flops, weight, transc = 0, 0, 0
    act = _numel(x) + _numel(y)
    if op == "fc":
        flops = 2 * _numel(x) * y[-1]
    elif op == "conv":
        kh, kw, cin, _ = lay["w_shape"]
        flops = 2 * _numel(y) * kh * kw * cin
    elif op == "dwconv":
        kh, kw = lay["w_shape"][:2]
        flops = 2 * _numel(y) * kh * kw
    elif op == "reshape":
        act = 0
    elif op == "softmax":
        transc = _numel(x)
    elif op != "avgpool":
        raise ValueError(f"no cost rule for op {op!r}")
    if lay.get("w_shape") is not None:
        weight = (_numel(lay["w_shape"]) * _BYTES["int8"]
                  + _numel(lay["b_shape"]) * _BYTES["int32"])
    return {"flops": flops, "act": act * _BYTES["int8"], "weight": weight,
            "transcendentals": transc}


def count(layers, rows: int, calls: int = 1, ops=None) -> dict:
    """``flops``, ``bytes`` and ``transcendentals`` of ``calls`` calls
    that answer ``rows`` rows in all, over the layers whose op is in
    ``ops`` (all when None)."""
    total = {"flops": 0, "bytes": 0, "transcendentals": 0}
    for lay in layers:
        if ops is not None and lay["op"] not in ops:
            continue
        c = op_cost(lay)
        total["flops"] += rows * c["flops"]
        total["bytes"] += rows * c["act"] + calls * c["weight"]
        total["transcendentals"] += rows * c["transcendentals"]
    return total


def bound_s(work: dict, peak: dict) -> float:
    """The least time the card could take: the larger of the products over
    the int8 peak and the bytes over the memory bandwidth."""
    return max(work["flops"] / peak["int8_ops_per_s"],
               work["bytes"] / peak["hbm_bytes_per_s"])
