"""Model families of the benchmark. A configuration names its family in its
``"family"`` key (a configuration without it is ``int8_cnn``); :func:`load`
finds ``portbench/families/<family>.py`` by that name, so a new family is a
new file, and a configuration, its cells and its metrics are added with
it from new files alone.

A family module provides, for one run of a cell:

``model(config, seed, device)``
    The seeded model, made from ``config`` and ``--seed`` alone. It is
    handed to the program and to the check, and to the ``inspect``
    callback of :func:`portbench.harness.run_cell`.
``pool(config, model, traffic, seed, device)``
    The pool of inputs that the traffic draws its requests from.
``engine(model, device)``
    The program's engine on the model. ``harness.py`` and the metric
    readers import no part of the program (``repro_torch``): a family
    imports what it drives, itself or through ``port.py`` and
    ``drive.py``.
``driver(traffic, engine, pool, trace)``
    The window's driver, with the interface of
    :class:`portbench.drive.Direct`: ``warm(seconds)``, ``window(rec,
    seconds, phases)``, ``counters()`` and ``close()``. It records into
    the shared :class:`portbench.drive.Record` (``attempted``, ``calls``,
    ``idx``, ``lat``, ``fail``, ``t_close``) and drives
    :class:`portbench.drive.Phases`. ``trace`` says whether the run is a
    traced one. Answers that are not int8 are kept where the family's own
    ``check`` reads them; ``Record``'s int8 buffers are the int8 family's.
``check(model, config, rec, pool, device)``
    Every answer of the window against the family's plain reference:
    ``{"answered": rows, "wrong": rows, "compared": {name: {"value": v,
    "limit": l} or {"value": v, "min": m}}}``, as
    :func:`portbench.harness.check` returns it. A number with a ``limit``
    is right at or under it; ``correct`` also needs no row wrong, none
    failed and at least one answered.
``work(config)``
    The frozen count of the family's work: a callable ``(rows, calls=1,
    ops=None) -> {"flops", "bytes", "transcendentals"}`` for ``calls``
    calls that answer ``rows`` rows in all (``ops``: a family's own
    selection of its parts, all when None), whose ``peak`` is the
    ``peaks.json`` key of the dtype its ``flops`` run in. The shared
    readers (``metrics.roofline``, ``metrics.mfu``) hold it against that
    peak and the memory bandwidth.
"""
from __future__ import annotations

import importlib

DEFAULT = "int8_cnn"


def load(name: str):
    return importlib.import_module(f"portbench.families.{name}")


def of(config):
    """The family module of ``config``."""
    return load(config.get("family", DEFAULT))
