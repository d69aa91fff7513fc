"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA (kv_lora=512, q_lora=1536),
MoE 160 routed top-6 + 2 shared experts, expert d_ff=1536."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b", family="moe", source="arXiv:2405.04434",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    d_ff=1536, moe_d_ff=1536, vocab_size=102400,
    n_experts=160, top_k=6, n_shared_experts=2,
    use_mla=True, kv_lora_rank=512, q_lora_rank=1536,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    mlp_kind="swiglu", norm="rmsnorm", rope="standard",
))
