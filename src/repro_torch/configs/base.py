"""Architecture configuration system.

Every assigned architecture is a frozen ``ArchConfig`` registered under its
public id (``--arch <id>`` in the launchers). ``reduced()`` derives the
smoke-test variant (≤2 layers, d_model ≤ 512, ≤4 experts) of the same family.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional

_REGISTRY: dict = {}


@dataclass(frozen=True)
class LayerDef:
    """One layer in a (possibly heterogeneous) stack pattern."""
    mixer: str = "gqa"       # gqa | mla | ssm | none
    mlp: str = "dense"       # dense | moe | none
    cross_attn: bool = False  # whisper decoder layers


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str              # dense | moe | hybrid | vlm | audio | ssm
    source: str              # citation (paper/model card)
    n_layers: int
    d_model: int
    n_heads: int             # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0          # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0        # per-expert hidden dim (falls back to d_ff)
    capacity_factor: float = 1.25
    moe_groups: int = 0      # >1: group-local routing (dispatch within each
                             # token group, aligned with the data shards —
                             # DeepSeek-style device-limited routing; §Perf)

    # MLA (DeepSeek-V2)
    use_mla: bool = False
    mla_absorb: bool = True  # decode-time weight absorption (§Perf)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128

    # SSM (Mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_conv_kernel: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 64

    # hybrid interleave (Jamba): within each period of `pattern_period`
    # layers, attention sits at `attn_index`, MoE on every `moe_every`-th.
    pattern_period: int = 0
    attn_index: int = 0
    moe_every: int = 0

    # modality frontends (STUBS per assignment: embeddings provided)
    modality: str = "text"   # text | vision | audio
    n_patches: int = 0       # vision: patch embeddings prepended
    frontend_dim: int = 0    # stub embedding dim before the projector
    n_frames: int = 0        # audio: encoder frames
    encoder_layers: int = 0  # enc-dec (whisper)

    # flavor
    mlp_kind: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"     # rmsnorm | layernorm
    rope: str = "standard"    # standard | 2d | learned | none
    rope_theta: float = 10000.0
    sliding_window: int = 0   # 0 = full attention (long_500k uses 8192)
    notes: str = ""

    # ----- derived -------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        return self.d_model // max(self.n_heads, 1)

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k context?  SSM/hybrid natively; dense
        only through the sliding-window variant."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def pattern(self) -> list:
        """The heterogeneous layer pattern for one scan period."""
        if self.family == "ssm":
            return [LayerDef(mixer="ssm", mlp="none")]
        if self.pattern_period:  # hybrid (Jamba)
            out = []
            for i in range(self.pattern_period):
                mixer = "gqa" if i == self.attn_index else "ssm"
                mlp = ("moe" if self.moe_every and i % self.moe_every == 1
                       else "dense")
                out.append(LayerDef(mixer=mixer, mlp=mlp))
            return out
        mixer = "mla" if self.use_mla else "gqa"
        mlp = "moe" if self.n_experts else "dense"
        return [LayerDef(mixer=mixer, mlp=mlp)]

    @property
    def n_periods(self) -> int:
        period = len(self.pattern())
        assert self.n_layers % period == 0, (self.n_layers, period)
        return self.n_layers // period

    # ----- parameter counts (for roofline MODEL_FLOPS) --------------------
    def param_count(self, active_only: bool = False) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        n = 0
        per_pattern = []
        for ld in self.pattern():
            p = 0
            if ld.mixer == "gqa":
                hd = self.head_dim
                p += d * self.n_heads * hd            # wq
                p += 2 * d * self.n_kv_heads * hd     # wk, wv
                p += self.n_heads * hd * d            # wo
            elif ld.mixer == "mla":
                r, qr = self.kv_lora_rank, self.q_lora_rank
                qk, rp, vh = (self.qk_nope_head_dim, self.qk_rope_head_dim,
                              self.v_head_dim)
                H = self.n_heads
                p += d * qr + qr * H * (qk + rp)      # q down/up
                p += d * (r + rp)                     # kv down + shared rope
                p += r * H * (qk + vh)                # kv up
                p += H * vh * d                       # wo
            elif ld.mixer == "ssm":
                di, N, Hs = self.d_inner, self.ssm_state, self.ssm_heads
                G = 1
                p += d * (2 * di + 2 * G * N + Hs)    # in_proj
                p += self.ssm_conv_kernel * (di + 2 * G * N)
                p += di * d                           # out_proj
            if ld.mlp == "dense":
                mult = 3 if self.mlp_kind == "swiglu" else 2
                p += mult * d * ff
            elif ld.mlp == "moe":
                mult = 3 if self.mlp_kind == "swiglu" else 2
                e_ff = self.expert_d_ff
                experts = ((self.top_k if active_only else self.n_experts)
                           + self.n_shared_experts)
                p += experts * mult * d * e_ff
                p += d * self.n_experts               # router
            per_pattern.append(p)
        n += self.n_periods * sum(per_pattern)
        n += V * d                                    # embedding
        n += V * d                                    # lm head (untied)
        if self.encoder_layers:
            hd = self.head_dim
            enc = (2 * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d) + 2 * d * ff)
            n += self.encoder_layers * enc // 2  # self-attn + mlp per layer
            # decoder cross-attention
            n += self.n_layers * (2 * d * self.n_kv_heads * hd
                                  + d * self.n_heads * hd
                                  + self.n_heads * hd * d)
        return int(n)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology, tiny dims."""
        period = len(self.pattern())
        layers = period if period > 1 else 2
        kw = dict(
            n_layers=layers,
            d_model=256,
            d_ff=512 if self.d_ff else 0,
            vocab_size=512,
            name=self.name + "-smoke",
        )
        if self.n_heads:
            kw.update(n_heads=4, n_kv_heads=min(self.n_kv_heads, 2), d_head=64)
        if self.n_experts:
            kw.update(n_experts=4, top_k=min(self.top_k, 2),
                      n_shared_experts=min(self.n_shared_experts, 1),
                      moe_d_ff=128 if self.moe_d_ff else 0)
        if self.use_mla:
            kw.update(kv_lora_rank=64, q_lora_rank=64, qk_nope_head_dim=32,
                      qk_rope_head_dim=16, v_head_dim=32)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=8)
        if self.n_patches:
            kw.update(n_patches=8, frontend_dim=64)
        if self.n_frames:
            kw.update(n_frames=16)
        if self.encoder_layers:
            kw.update(encoder_layers=2)
        return replace(self, **kw)


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, cfg.name
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        load_all()
    if name.endswith("-smoke"):
        return get_config(name[:-6]).reduced()
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        load_all()
    return sorted(_REGISTRY)


def load_all() -> None:
    """Import every config module (each registers itself)."""
    from . import (starcoder2_3b, kimi_k2_1t_a32b, stablelm_3b,  # noqa: F401
                   chatglm3_6b, jamba_v01_52b, internvl2_26b,
                   whisper_small, deepseek_v2_236b, mamba2_780m,
                   internlm2_20b)


# ----- input shapes (assignment) -------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
