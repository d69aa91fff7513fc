"""Plain references of the benchmark's configurations. A configuration
names its reference module in its ``"reference"`` key; :func:`load` finds
it here by that name, so a new reference is a new file."""
from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"portbench.reference.{name}")
