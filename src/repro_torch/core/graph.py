"""Neural-network graph IR — the port's copy of ``repro.core.graph``.

Numpy only: tensors (with the quantization parameters of Eq. 1) and a
sequential list of operators. The port keeps its own copy so that it never
imports the JAX package. :func:`save` / :func:`load` write and read the
msgpack file of the JAX package's ``save`` (byte for byte, with the port's
own msgpack subset, :mod:`repro_torch.core.packb`), which is how a
quantized graph (int8 weights, int32 biases, per-tensor / per-channel
``QParams``) is carried from one package to the other.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .packb import Reader, packb

# Operator vocabulary (paper Table 2) + the Sec. 7 extensions.
FULLY_CONNECTED = "FULLY_CONNECTED"
CONV_2D = "CONV_2D"
DEPTHWISE_CONV_2D = "DEPTHWISE_CONV_2D"
AVERAGE_POOL_2D = "AVERAGE_POOL_2D"
MAX_POOL_2D = "MAX_POOL_2D"
ADD = "ADD"
PAD = "PAD"
RESHAPE = "RESHAPE"
RELU = "RELU"
RELU6 = "RELU6"
SOFTMAX = "SOFTMAX"

ALL_OPS = (
    FULLY_CONNECTED,
    CONV_2D,
    DEPTHWISE_CONV_2D,
    AVERAGE_POOL_2D,
    MAX_POOL_2D,
    ADD,
    PAD,
    RESHAPE,
    RELU,
    RELU6,
    SOFTMAX,
)

# Fused activations supported by the weighted ops (paper Sec. 5.5).
FUSED_NONE = "NONE"
FUSED_RELU = "RELU"
FUSED_RELU6 = "RELU6"

_DTYPES = {"int8", "int32", "float32"}


@dataclass
class QParams:
    """Quantization parameters of Eq. (1): r = S (q - Z).

    ``scale``/``zero_point`` are scalars for per-tensor quantization or
    1-D arrays (length = size of ``axis``) for per-channel quantization.
    """

    scale: np.ndarray
    zero_point: np.ndarray
    axis: Optional[int] = None  # channel axis for per-channel quantization

    def __post_init__(self):
        self.scale = np.asarray(self.scale, dtype=np.float32)
        self.zero_point = np.asarray(self.zero_point, dtype=np.int32)

    @property
    def per_channel(self) -> bool:
        return self.axis is not None

    def _broadcast(self, ndim: int):
        s, z = self.scale, self.zero_point
        if self.per_channel:
            shape = [1] * ndim
            shape[self.axis] = -1
            s, z = s.reshape(shape), z.reshape(shape)
        return s, z

    def quantize(self, r: np.ndarray, dtype=np.int8) -> np.ndarray:
        info = np.iinfo(dtype)
        s, z = self._broadcast(r.ndim)
        q = np.round(r / s) + z
        return np.clip(q, info.min, info.max).astype(dtype)

    def dequantize(self, q: np.ndarray) -> np.ndarray:
        s, z = self._broadcast(q.ndim)
        return (q.astype(np.float32) - z) * s


@dataclass
class TensorSpec:
    """A tensor in the graph: activation (data=None) or constant (weights)."""

    name: str
    shape: tuple
    dtype: str
    qparams: Optional[QParams] = None
    data: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.dtype not in _DTYPES:
            raise ValueError(f"unsupported dtype {self.dtype!r}")
        self.shape = tuple(int(d) for d in self.shape)
        if self.data is not None:
            self.data = np.asarray(self.data)
            if tuple(self.data.shape) != self.shape:
                raise ValueError(
                    f"{self.name}: data shape {self.data.shape} != {self.shape}")

    @property
    def is_const(self) -> bool:
        return self.data is not None

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64)) * np.dtype(self.dtype).itemsize


@dataclass
class OpNode:
    """One operator: named op, tensor ids for inputs/outputs, attributes
    (see ``repro.core.graph.OpNode`` for the per-op attribute table)."""

    op: str
    inputs: list
    outputs: list
    attrs: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.op not in ALL_OPS:
            raise ValueError(f"unknown op {self.op!r}")


@dataclass
class Graph:
    """Sequential NN graph. ``tensors`` indexed by integer id."""

    tensors: list  # list[TensorSpec]
    ops: list  # list[OpNode]
    inputs: list  # tensor ids
    outputs: list  # tensor ids
    name: str = "model"

    def tensor(self, tid: int) -> TensorSpec:
        return self.tensors[tid]

    def add_tensor(self, t: TensorSpec) -> int:
        self.tensors.append(t)
        return len(self.tensors) - 1

    @property
    def weight_bytes(self) -> int:
        return sum(t.nbytes for t in self.tensors if t.is_const)

    @property
    def activation_ids(self) -> list:
        return [i for i, t in enumerate(self.tensors) if not t.is_const]

    def validate(self) -> None:
        """Raise ``ValueError`` unless every op reads tensors produced before
        it, writes exactly one activation, and every output is produced."""
        n = len(self.tensors)

        def check(cond, msg):
            if not cond:
                raise ValueError(f"{self.name}: {msg}")

        produced = set(self.inputs)
        for t in self.inputs + self.outputs:
            check(0 <= t < n, f"tensor id {t} out of range")
        for op in self.ops:
            check(len(op.outputs) == 1,
                  f"{op.op}: multi-output ops are unsupported (got "
                  f"{len(op.outputs)} outputs)")
            for t in op.inputs:
                check(0 <= t < n, f"{op.op} reads tensor id {t} out of range")
                if not self.tensors[t].is_const:
                    check(t in produced, f"{op.op} reads unproduced tensor {t}")
            for t in op.outputs:
                check(0 <= t < n and not self.tensors[t].is_const,
                      f"{op.op} writes invalid tensor {t}")
                produced.add(t)
        for t in self.outputs:
            check(t in produced, f"graph output {t} never produced")


# ---------------------------------------------------------------------------
# Deserialization of the JAX package's on-disk format (msgpack).
# ---------------------------------------------------------------------------

def _qp_from_dict(d) -> Optional[QParams]:
    if d is None:
        return None
    return QParams(np.asarray(d["scale"], np.float32),
                   np.asarray(d["zero_point"], np.int32), d["axis"])


def _fix_attrs(attrs: dict) -> dict:
    # msgpack turns tuples into lists; attrs are tuples in the builder
    def fix(v):
        return tuple(fix(e) for e in v) if isinstance(v, list) else v
    return {k: fix(v) for k, v in attrs.items()}


def graph_from_doc(doc: dict) -> Graph:
    """Build a :class:`Graph` from the decoded document that
    ``repro.core.graph.save`` writes: ``name``, ``inputs``, ``outputs``,
    ``tensors`` (name/shape/dtype/qparams/data bytes) and ``ops``."""
    tensors = []
    for td in doc["tensors"]:
        data = td["data"]
        if data is not None:
            data = np.frombuffer(data, dtype=td["dtype"]).reshape(td["shape"]).copy()
        tensors.append(
            TensorSpec(td["name"], tuple(td["shape"]), td["dtype"],
                       _qp_from_dict(td["qparams"]), data))
    ops = [OpNode(o["op"], list(o["inputs"]), list(o["outputs"]),
                  _fix_attrs(o["attrs"]))
           for o in doc["ops"]]
    g = Graph(tensors, ops, list(doc["inputs"]), list(doc["outputs"]),
              doc["name"])
    g.validate()
    return g


def graph_to_doc(g: Graph) -> dict:
    """The document ``repro.core.graph.save`` packs for ``g``: the inverse
    of :func:`graph_from_doc`, with no msgpack needed to make it."""
    def qp(q):
        return None if q is None else {"scale": q.scale.tolist(),
                                       "zero_point": q.zero_point.tolist(),
                                       "axis": q.axis}
    return {"name": g.name, "inputs": list(g.inputs),
            "outputs": list(g.outputs),
            "tensors": [{"name": t.name, "shape": list(t.shape),
                         "dtype": t.dtype, "qparams": qp(t.qparams),
                         "data": None if t.data is None else t.data.tobytes()}
                        for t in g.tensors],
            "ops": [{"op": o.op, "inputs": list(o.inputs),
                     "outputs": list(o.outputs), "attrs": dict(o.attrs)}
                    for o in g.ops]}


def save(graph: Graph, path: str) -> None:
    """Write ``graph`` as ``repro.core.graph.save`` does, byte for byte:
    :func:`graph_to_doc` packed by :mod:`repro_torch.core.packb`."""
    with open(path, "wb") as f:
        f.write(packb(graph_to_doc(graph)))


def load(path: str) -> Graph:
    """Read a graph written by :func:`save` or ``repro.core.graph.save``
    (no msgpack needed)."""
    with open(path, "rb") as f:
        doc = Reader(f).value()
    return graph_from_doc(doc)


# ---------------------------------------------------------------------------
# Shape inference helpers shared by builder / planner / engines.
# ---------------------------------------------------------------------------

def conv_out_hw(h, w, kh, kw, stride, padding):
    sh, sw = stride
    if padding == "SAME":
        return -(-h // sh), -(-w // sw)
    if padding == "VALID":
        return (h - kh) // sh + 1, (w - kw) // sw + 1
    raise ValueError(padding)
