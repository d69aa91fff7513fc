"""The frozen count gives the hand counts the program's own count gave
(sine, speech and person int8, per call and at batch 8)."""
import pytest

from portbench import count as C
from portbench import model as M
from portbench.harness import HERE, load_json

SINE = {"input": [1], "layers": [
    {"name": "fc1", "op": "fc", "out": 16, "fused": "RELU"},
    {"name": "fc2", "op": "fc", "out": 16, "fused": "RELU"},
    {"name": "fc3", "op": "fc", "out": 1, "fused": "NONE"}]}


def layers(name):
    if name == "sine":
        return M.shapes(SINE)
    return M.shapes(load_json(HERE / "configs" / f"{name}.json"))


@pytest.mark.parametrize("name,rows,flops,nbytes,transc", [
    ("sine", 1, 576, 486, 0),
    ("speech", 1, 672_000, 26_660, 4),
    ("person", 1, 14_315_776, 691_758, 2),
    ("person", 8, 8 * 14_315_776, 4_001_624, 16),
])
def test_hand_counts(name, rows, flops, nbytes, transc):
    got = C.count(layers(name), rows)
    assert got == {"flops": flops, "bytes": nbytes, "transcendentals": transc}


def test_weights_count_once_a_call():
    lay = layers("person")
    one, many = C.count(lay, 32, calls=1), C.count(lay, 32, calls=4)
    weights = sum(C.op_cost(x)["weight"] for x in lay)
    assert weights == 218_920
    assert many["bytes"] - one["bytes"] == 3 * weights
    assert many["flops"] == one["flops"]


def test_bound_is_the_larger_side():
    peak = {"int8_ops_per_s": 1.979e15, "hbm_bytes_per_s": 3.35e12}
    work = C.count(layers("person"), 32)
    assert C.bound_s(work, peak) == pytest.approx(
        (218_920 + 32 * 472_838) / 3.35e12)


def test_by_op_kind_partitions_the_count():
    lay = layers("person")
    parts = [C.count(lay, 8, ops=k) for k in
             (("conv", "fc"), ("dwconv",), ("avgpool", "reshape", "softmax"))]
    total = C.count(lay, 8)
    for key in total:
        assert sum(p[key] for p in parts) == total[key]
