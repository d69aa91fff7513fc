"""Jamba v0.1 52B [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave, MoE 16e top-2 on every second layer. Our SSM mixer is the
Mamba2/SSD formulation (see DESIGN.md hardware-adaptation notes)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid", source="arXiv:2403.19887",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536, n_experts=16, top_k=2,
    pattern_period=8, attn_index=4, moe_every=2,
    ssm_state=16, ssm_head_dim=64, ssm_expand=2,
    mlp_kind="swiglu", norm="rmsnorm", rope="standard",
))
