"""repro_torch.launch — launchers (:mod:`~repro_torch.launch.serve`,
:mod:`~repro_torch.launch.train`), the port of ``repro.launch``."""
