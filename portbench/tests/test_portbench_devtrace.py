"""The reduction of a device trace: busy time is the union of the device
intervals, and each long idle gap is named by the innermost host op over
its middle."""
import pytest

from portbench.devtrace import _kind, reduce


def test_union_gaps_and_host_ops():
    device = [("k1", 0, 100, "kernel"), ("k2", 50, 150, "kernel"),
              ("Memcpy HtoD", 400, 450, "memcpy"), ("k1", 1000, 1100,
                                                     "kernel")]
    host = [("outer", 100, 2000), ("aten::copy_", 200, 380)]
    got = reduce(device, host, window_s=2e-6)
    assert got["busy_s"] == pytest.approx(300e-9)
    assert got["ops"]["k1"] == [pytest.approx(200e-9), 2, "kernel"]
    # gaps 150..400 (middle 275: inside copy_) and 450..1000 (outer only)
    assert got["gaps"] == [["outer", pytest.approx(550e-9)],
                           ["aten::copy_", pytest.approx(250e-9)]]


def test_no_host_op_over_a_gap():
    got = reduce([("a", 0, 10, "kernel"), ("b", 20, 30, "kernel")], [],
                 window_s=1e-7)
    assert got["gaps"] == [["no_traced_host_op", pytest.approx(1e-8)]]


def test_kinds_by_name():
    assert _kind("Memcpy DtoH (Device -> Pinned)") == "memcpy"
    assert _kind("Memset (Device)") == "memset"
    assert _kind("void qmatmul_kernel<128, 32, 128>") == "kernel"
