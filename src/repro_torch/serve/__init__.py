"""repro_torch.serve — the serving stack over the port's engine, the port of
``repro.serve``: :mod:`~repro_torch.serve.scheduler` (``MicroBatcher``),
:mod:`~repro_torch.serve.executor`, :mod:`~repro_torch.serve.resilience`,
:mod:`~repro_torch.serve.faults`, :mod:`~repro_torch.serve.metrics` and
:mod:`~repro_torch.serve.registry` (``ServingRegistry``,
``build_paper_registry``)."""
