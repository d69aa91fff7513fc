"""repro_torch.launch — launchers (:mod:`~repro_torch.launch.serve`,
:mod:`~repro_torch.launch.train`), the production meshes
(:mod:`~repro_torch.launch.mesh`), the abstract input specs
(:mod:`~repro_torch.launch.specs`), the sharding policy
(:mod:`~repro_torch.launch.sharding`) and the dry run
(:mod:`~repro_torch.launch.dryrun`); the port of ``repro.launch``."""
