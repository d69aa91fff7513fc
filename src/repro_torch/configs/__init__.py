"""repro_torch.configs — the paper's evaluation models."""
