"""Seconds from the process start to the first timed request: imports,
the seeded model and rows, the engine build (and nvcc in the first run of a
checkout), the captures and the warm traffic."""


def read(run):
    return run.setup_s
