"""StarCoder2-3B [arXiv:2402.19173] — dense, GQA (kv=2), RoPE."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-3b", family="dense", source="arXiv:2402.19173",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, d_ff=12288,
    vocab_size=49152, mlp_kind="gelu", norm="layernorm", rope="standard",
))
