"""StableLM-2 [hf:stabilityai/stablelm-2-1_6b family] — dense, full MHA
(kv=32)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-3b", family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab_size=50304, mlp_kind="swiglu", norm="layernorm", rope="standard",
))
