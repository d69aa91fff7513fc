"""InternVL2-26B [arXiv:2404.16821] — VLM: InternViT (STUB: precomputed
patch embeddings, dim 3200) + projector + InternLM2 backbone."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b", family="vlm", source="arXiv:2404.16821",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92553, modality="vision", n_patches=256, frontend_dim=3200,
    mlp_kind="swiglu", norm="rmsnorm", rope="standard",
))
