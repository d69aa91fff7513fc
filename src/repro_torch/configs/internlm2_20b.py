"""InternLM2-20B [arXiv:2403.17297] — dense, GQA kv=8."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b", family="dense", source="arXiv:2403.17297",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=92544, mlp_kind="swiglu", norm="rmsnorm", rope="standard",
))
