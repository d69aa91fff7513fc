"""repro_torch.train — the loss and the train step
(:mod:`~repro_torch.train.step`) and checkpoints
(:mod:`~repro_torch.train.checkpoint`), the port of ``repro.train``."""
