"""Rows that the served path (the registry and its batcher) answered right
in the window, over the window's seconds (from the first request sent to
the last answer in)."""


def read(run):
    return run.rows_ok / run.window_s if run.window_s > 0 else None
