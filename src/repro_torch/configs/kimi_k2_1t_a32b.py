"""Kimi K2 1T-A32B [arXiv:2501.kimi2] — trillion-parameter MoE, 384 experts
top-8 (+1 shared per the K2 report), GQA kv=8 per the assignment table.
d_head pinned to 128 (d_model/n_heads = 112 is not MXU-friendly; the real
model also uses 128-dim heads)."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", source="arXiv:2501.kimi2",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, moe_d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, n_shared_experts=1,
    mlp_kind="swiglu", norm="rmsnorm", rope="standard",
    notes="assignment table: 384e top-8, d_ff=2048 per expert",
))
