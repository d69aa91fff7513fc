"""repro_torch.models — the LLM model library, the port of
``repro.models``: :mod:`~repro_torch.models.layers`,
:mod:`~repro_torch.models.attention` (GQA, MLA, cross-attention),
:mod:`~repro_torch.models.moe` (and the expert-parallel all-to-all
:mod:`~repro_torch.models.moe_a2a`), :mod:`~repro_torch.models.ssm` (Mamba2
SSD), :mod:`~repro_torch.models.transformer` (stacks over periods),
:mod:`~repro_torch.models.model` and :mod:`~repro_torch.models.convert`
(the reference's parameters and caches carried in)."""
