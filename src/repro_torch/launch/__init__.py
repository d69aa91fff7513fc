"""repro_torch.launch — launchers (:mod:`~repro_torch.launch.serve`), the
port of ``repro.launch``."""
