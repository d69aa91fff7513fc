"""The int8 CNN family: a layer list of conv, depthwise conv, FC, average
pool, reshape and softmax (``configs/person.json``, ``configs/speech.json``),
run by the program's ``CompiledModel``. Each function names the code that
does the work, through its module's attribute at call time, so that a tool
that replaces one of them (``tools/engine_spans.py`` replaces
``drive.driver``) still takes effect."""
from __future__ import annotations

from portbench import count, drive, harness, model as M, port


def model(config, seed, device):
    return M.make_model(config, seed, device)


def pool(config, qmodel, traffic, seed, device):
    return drive.Pool(config, qmodel, traffic, seed, device)


def engine(qmodel, device):
    return port.compiled_model(qmodel, device)


def driver(traffic, cm, pool, trace):
    tracer = None
    if trace and traffic["entry"] in ("registry", "registry_open"):
        from repro_torch.obs.trace import Tracer
        tracer = Tracer()
    return drive.driver(traffic, cm, pool, tracer)


def check(qmodel, config, rec, pool, device):
    return harness.check(qmodel, config, rec, pool.rows, device)


def work(config):
    """The frozen count (``count.py``) of the configuration's layers,
    against the card's int8 peak; its ``layers`` are ``model.shapes``'."""
    layers = M.shapes(config)

    def counted(rows, calls=1, ops=None):
        return count.count(layers, rows, calls, ops)

    counted.peak, counted.layers = "int8_ops_per_s", layers
    return counted
