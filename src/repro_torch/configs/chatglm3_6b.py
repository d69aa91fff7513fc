"""ChatGLM3-6B [arXiv:2406.12793] — dense, 2D (half-rotary) RoPE, GQA kv=2."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="chatglm3-6b", family="dense", source="arXiv:2406.12793",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, d_ff=13696,
    vocab_size=65024, mlp_kind="swiglu", norm="rmsnorm", rope="2d",
))
