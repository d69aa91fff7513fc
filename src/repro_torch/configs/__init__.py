"""repro_torch.configs — the paper's evaluation models
(:mod:`~repro_torch.configs.paper_models`) and the ten LLM architecture
configs (:mod:`~repro_torch.configs.base`), copied from ``repro.configs``."""
from .base import (ArchConfig, InputShape, INPUT_SHAPES, get_config,
                   list_configs, load_all)  # noqa: F401
