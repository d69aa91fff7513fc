"""Whisper-small [arXiv:2212.04356] — encoder-decoder, conv/mel frontend
STUBBED (precomputed 1500-frame embeddings), learned positions."""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-small", family="audio", source="arXiv:2212.04356",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, d_ff=3072,
    vocab_size=51865, modality="audio", n_frames=1500, encoder_layers=12,
    mlp_kind="gelu", norm="layernorm", rope="learned",
))
