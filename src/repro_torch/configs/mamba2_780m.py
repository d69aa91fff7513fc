"""Mamba2-780M [arXiv:2405.21060] — attention-free SSM with SSD
(state-space duality), state=128."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-780m", family="ssm", source="arXiv:2405.21060",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab_size=50280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    mlp_kind="swiglu", norm="rmsnorm", rope="none",
))
