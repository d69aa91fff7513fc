"""repro_torch.data — the deterministic synthetic data pipeline
(:mod:`~repro_torch.data.pipeline`), the port of ``repro.data``."""
