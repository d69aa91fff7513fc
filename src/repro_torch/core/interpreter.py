"""Interpreter-based engine — the TFLM-architecture baseline (Sec. 3.3, 4.2);
the port of ``repro.core.interpreter``.

As the paper describes interpreter-based inference:

* the model graph is walked at run time, op by op, with dynamic dispatch
  through the single-source op registry (``core.registry``) — the registry
  the compiled engine lowers from, so the two engines cannot drift;
* every constant term of the quantized formulas (Eqs. 3/6/9/12) is computed
  at run time, nothing is folded (the registry's ``eval_reference`` path);
* activations live in a pre-sized tensor arena that persists for the whole
  inference (``core.memory.plan_arena``): one byte tensor on the device,
  carved into typed views at the planned offsets.

The compiled engine (``core.engine``) is the MicroFlow counterpart.
"""
from __future__ import annotations

import numpy as np
import torch

from . import graph as G
from . import registry as R
from .device import resolve_device
from .memory import plan_arena


class Interpreter:
    """Runs on ``device`` (``"cuda"`` by default, like every entry point of
    the port; raises without a card unless the caller asks for the CPU)."""

    def __init__(self, g: G.Graph, use_arena: bool = True, device="cuda"):
        g.validate()
        self.g = g
        self.device = resolve_device(device)
        self.plan = plan_arena(g) if use_arena else None
        self.arena = (torch.zeros(self.plan.arena_bytes, dtype=torch.uint8,
                                  device=self.device)
                      if self.plan is not None else None)
        self._consts = {tid: torch.as_tensor(t.data, device=self.device)
                        for tid, t in enumerate(g.tensors) if t.is_const}

    # -- buffer management ----------------------------------------------
    def _buffer(self, tid: int) -> torch.Tensor:
        t = self.g.tensor(tid)
        dtype = getattr(torch, t.dtype)
        if self.plan is None:
            return torch.zeros(t.shape, dtype=dtype, device=self.device)
        off = self.plan.offsets[tid]
        return self.arena[off:off + t.nbytes].view(dtype).reshape(t.shape)

    # -- execution --------------------------------------------------------
    def _value(self, tid: int, env: dict) -> torch.Tensor:
        if tid in self._consts:
            return self._consts[tid]
        return env[tid]

    def _dispatch(self, op: G.OpNode, env: dict, index: int = 0):
        ctx = R.OpContext(self.g, op, index)
        return R.run_reference(ctx, [self._value(t, env) for t in op.inputs])

    def invoke_env(self, *inputs) -> dict:
        """Run with raw (graph-dtype) inputs; return the activation
        environment: tensor id -> view of the arena on the device."""
        env = {}
        for tid, arr in zip(self.g.inputs, inputs):
            t = self.g.tensor(tid)
            buf = self._buffer(tid)
            buf.copy_(torch.as_tensor(np.asarray(arr, t.dtype).reshape(t.shape)))
            env[tid] = buf
        for i, op in enumerate(self.g.ops):
            out = self._dispatch(op, env, i)
            buf = self._buffer(op.outputs[0])
            buf.copy_(out)
            env[op.outputs[0]] = buf
        return env

    def invoke_q(self, *inputs):
        """Raw-dtype in, raw-dtype out (numpy arrays, copied off the arena)."""
        env = self.invoke_env(*inputs)
        outs = tuple(env[t].cpu().numpy().copy() for t in self.g.outputs)
        return outs if len(outs) > 1 else outs[0]

    def invoke(self, *inputs):
        """Float in, float out: quantize at entry / dequantize at exit when
        the graph is int8 (the TFLite interface the paper's models use)."""
        qin = []
        for tid, arr in zip(self.g.inputs, inputs):
            t = self.g.tensor(tid)
            arr = np.asarray(arr, np.float32)
            qin.append(t.qparams.quantize(arr) if t.dtype == "int8" else arr)
        outs = self.invoke_q(*qin)
        if not isinstance(outs, tuple):
            outs = (outs,)
        res = []
        for tid, val in zip(self.g.outputs, outs):
            t = self.g.tensor(tid)
            res.append(t.qparams.dequantize(val) if t.dtype == "int8"
                       else val.astype(np.float32))
        return tuple(res) if len(res) > 1 else res[0]
