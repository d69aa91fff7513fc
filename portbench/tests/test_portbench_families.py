"""The int8 CNN family reads as the harness read before families: its work
is the frozen count of ``count.py``, the shared readers give the numbers of
the formulas they had to the last bit, and each cell's small run keeps its
compared numbers and metric names."""
import pytest

from portbench import count as C, drive, families, metrics as MX
from portbench import model as M
from portbench.families import int8_cnn
from portbench.harness import HERE, Run, load_json
from _small import SMALL, bench, run_small

CONFIGS = sorted({c["config"] for c in bench()["workloads"]})
OPS = [None, ("fc", "conv"), ("dwconv",), ("avgpool", "reshape", "softmax")]
CARD = load_json(HERE / "peaks.json")["NVIDIA H100 80GB HBM3"]


def config_of(name):
    return load_json(HERE / "configs" / f"{name}.json")


def test_peaks_per_dtype():
    assert CARD["int8_ops_per_s"] == 1.979e15
    assert CARD["hbm_bytes_per_s"] == 3.35e12
    assert (CARD["bf16_flops_per_s"], CARD["tf32_flops_per_s"],
            CARD["f32_flops_per_s"]) == (989.4e12, 494.7e12, 66.9e12)


@pytest.mark.parametrize("name", CONFIGS)
def test_int8_work_is_the_frozen_count(name):
    config = config_of(name)
    assert families.of(config) is int8_cnn and "family" not in config
    work = int8_cnn.work(config)
    assert work.peak == "int8_ops_per_s"
    layers = M.shapes(config)
    for rows, calls in ((1, 1), (8, 1), (32, 4), (4096, 16), (98_765, 3087)):
        for ops in OPS:
            assert work(rows, calls, ops) == C.count(layers, rows, calls, ops)
    assert work(7) == C.count(layers, 7)


def _run(config, peak):
    """A traced run of ``config`` with a synthetic trace and counted
    phase."""
    rec = drive.Record()
    ops = {"void qmatmul_kernel<64, 64, 128>": [0.123456789, 7, "kernel"],
           "void qmatmul_kernel_conv<128>": [0.0421, 3, "kernel"],
           "void qdwconv_kernel<3, 3, 1, 1>": [0.2718281828, 5, "kernel"],
           "void at::native::elementwise_kernel": [0.031, 9, "kernel"],
           "Memcpy HtoD (Pinned -> Device)": [0.05, 4, "memcpy"]}
    rec.trace = {"rows": 98_765, "calls": 3087, "busy_s": 0.61,
                 "window_s": 2.0, "gaps": [], "ops": ops}
    rec.phase_a = {"s": 48.987654321, "rows": 3_141_593, "calls": 98_175,
                   "requests": 1, "counters": {}}
    rec.t_start, rec.t_close = 10.0, 61.0
    return Run(int8_cnn.work(config), rec, 9.5, peak, 1)


def _roofline_then(layers, run, ops=None, match=None):
    """``metrics.roofline`` as it read before families."""
    tr, peak = run.rec.trace, run.peak
    secs = MX.kernel_s(run, match)
    work = C.count(layers, tr["rows"], tr["calls"], ops)
    return 100.0 * C.bound_s(work, peak) / secs


def _mfu_then(layers, run):
    a, peak = run.rec.phase_a, run.peak
    flops = C.count(layers, a["rows"])["flops"]
    return 100.0 * flops / (a["s"] * peak["int8_ops_per_s"])


READERS = sorted(m["name"] for m in bench()["per_layer"]
                 if "roofline" in m["name"] or "mfu" in m["name"])


@pytest.mark.parametrize("name", CONFIGS)
def test_shared_readers_to_the_last_bit(name):
    config = config_of(name)
    layers = M.shapes(config)
    run = _run(config, CARD)
    assert run.layers == layers
    then = {
        "kernels_roofline": _roofline_then(layers, run),
        "qmatmul_roofline": _roofline_then(layers, run, ("fc", "conv"),
                                           MX.is_qmatmul),
        "qdwconv_roofline": _roofline_then(layers, run, ("dwconv",),
                                           MX.is_qdwconv),
        "step.mfu": _mfu_then(layers, run)}
    assert MX.roofline(run) == then["kernels_roofline"]
    assert MX.mfu(run) == then["step.mfu"]
    for reader in READERS:
        got = MX.load(reader).read(run)
        assert got == then[reader.rsplit(".", 1)[0]], reader
    assert MX.roofline(_run(config, None)) is None
    assert MX.mfu(_run(config, None)) is None


# each small run's compared numbers and metric names, as the harness gave
# them before families (no peak and no device trace on the CPU)
COMPARED = ["answered", "max_gap_lsb", "raised", "rows_wrong"]
METRICS = {
    ("person.bulk", False): ["rows_per_s", "setup_s"],
    ("person.bulk", True): ["engine.call_us.rows",
                            "engine.h2d_bytes_per_row.rows"],
    ("person.direct", False): ["latency_p50_ms", "latency_p95_ms",
                               "setup_s"],
    ("person.direct", True): [],
    ("person.flood", False): ["served_rows_per_s", "setup_s"],
    ("person.flood", True): ["engine.call_us.served",
                             "engine.h2d_bytes_per_row.served",
                             "sched.latency_p95_ms.served",
                             "sched.queue_wait_us.served",
                             "sched.rows_per_flush.served"],
    ("speech.bulk", False): ["rows_per_s", "setup_s"],
    ("speech.bulk", True): ["engine.call_us.rows",
                            "engine.h2d_bytes_per_row.rows"],
}


@pytest.mark.parametrize("name,trace", sorted(METRICS))
def test_small_cells_keep_their_names(name, trace):
    assert name in SMALL
    res = run_small(name, trace=trace)
    assert res["correct"] is True
    assert sorted(res["compared"]) == COMPARED
    assert sorted(res["metrics"]) == METRICS[name, trace]
