"""repro_torch.optim — AdamW with a cosine schedule
(:mod:`~repro_torch.optim.adamw`), the port of ``repro.optim``."""
