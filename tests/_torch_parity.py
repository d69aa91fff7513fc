"""Shared helpers of the ``test_torch_*`` parity tests: the same numpy inputs
go through the JAX package and the PyTorch port, and the outputs are
compared as numpy arrays."""
import numpy as np
import torch

from repro.core import graph as JG
from repro_torch.core import graph as TG


def carry(jg, tmp_path, name="g.msgpack"):
    """A JAX-package graph carried into the port through the on-disk format
    (``repro.core.graph.save`` -> ``repro_torch.core.graph.load``)."""
    path = str(tmp_path / name)
    JG.save(jg, path)
    return TG.load(path)


def t(a):
    """numpy -> CPU tensor (copy, so torch never writes a JAX buffer)."""
    return torch.from_numpy(np.array(a))


def n(x):
    """tensor / jax array / numpy -> numpy."""
    if torch.is_tensor(x):
        return x.numpy()
    return np.asarray(x)


def assert_i8_equal(port, ref):
    """Weighted ops, pools, activations: bit-exact int8."""
    port, ref = n(port), n(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape, (
        port.dtype, port.shape, ref.dtype, ref.shape)
    np.testing.assert_array_equal(port, ref)


def assert_softmax_close(port, ref):
    """Softmax only: ``exp`` differs between torch and XLA in the last ulp,
    which can move an int8 output by one LSB; anything more is a fault."""
    port, ref = n(port), n(ref)
    assert port.dtype == ref.dtype and port.shape == ref.shape
    d = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert d.max(initial=0) <= 1, d.max()


def person_like(rng, hw=24):
    """A small person-shaped graph in the JAX package's builder: conv0 3×3/s2
    + three depthwise/pointwise blocks (one with stride 2), avgpool, FC and
    softmax. Both the FC logits and the softmax are graph outputs, so the
    weighted path is compared exactly and softmax within its ±1 LSB."""
    from repro.core.builder import GraphBuilder

    def w(*shape, s=0.3):
        return rng.normal(0, s, shape).astype("f")

    b = GraphBuilder("person_like")
    x = b.input("x", (1, hw, hw, 1))
    h = b.conv2d(x, w(3, 3, 1, 8), w(8, s=0.1), stride=(2, 2),
                 padding="SAME", fused="RELU6", name="conv0")
    cin = 8
    for i, (cout, stride) in enumerate([(16, 1), (32, 2), (32, 1)]):
        h = b.depthwise_conv2d(h, w(3, 3, cin, 1), w(cin, s=0.1),
                               stride=(stride, stride), padding="SAME",
                               fused="RELU6", name=f"dw{i}")
        h = b.conv2d(h, w(1, 1, cin, cout, s=0.4), w(cout, s=0.1),
                     padding="SAME", fused="RELU6", name=f"pw{i}")
        cin = cout
    side = hw // 4
    h = b.average_pool2d(h, (side, side), name="avgpool")
    h = b.reshape(h, (1, cin))
    logits = b.fully_connected(h, w(cin, 2, s=0.2), w(2, s=0.1), name="fc")
    b.output(logits)
    b.output(b.softmax(logits))
    return b.build()
