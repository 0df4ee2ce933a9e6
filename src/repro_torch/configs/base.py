# Copy of repro/configs/base.py: ModelConfig, its parameter counts, the shape cells.
"""Model/config schema shared by all assigned architectures.

One frozen dataclass describes any member of the five families (dense / MoE / VLM /
hybrid / SSM / encoder-audio). Heterogeneous layer stacks (gemma3 local:global,
recurrentgemma RG-LRU:attention, llama-vision cross-attention interleave) are
expressed as a repeating ``block_pattern`` so the model can scan over pattern
*periods* (HLO size ∝ period length, compile time independent of depth).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | vlm | hybrid | ssm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 → d_model // num_heads

    # --- attention ---------------------------------------------------------
    # per-layer block types, cycled: "attn" | "sliding" | "cross" | "rglru" | "ssd"
    block_pattern: tuple[str, ...] = ("attn",)
    sliding_window: int = 4096
    rope_style: str = "standard"     # standard | partial2d | none
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0       # chatglm: rotary on half the head dim
    qk_norm: bool = False
    causal: bool = True              # False for encoder-only (hubert)

    # --- mlp / moe ----------------------------------------------------------
    mlp_kind: str = "swiglu"         # swiglu | geglu | gelu
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_capacity_factor: float = 1.25

    # --- ssm (mamba2 SSD) ----------------------------------------------------
    ssm_state_dim: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 128             # SSD chunk length

    # --- rglru (griffin) ------------------------------------------------------
    lru_width: int = 0               # 0 → d_model
    lru_heads: int = 0               # block-diagonal gate blocks; 0 → num_heads

    # --- vlm -----------------------------------------------------------------
    img_tokens: int = 0              # stubbed frontend sequence length

    # --- misc ----------------------------------------------------------------
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    remat: str = "nothing_saveable"  # none | nothing_saveable | dots_saveable
    logit_softcap: float = 0.0
    embed_scale: float = 1.0         # gemma: sqrt(d_model)
    scan_layers: bool = True         # lax.scan over periods (False: unrolled)

    # ------------------------------------------------------------------ derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def pattern_layers(self) -> tuple[str, ...]:
        """Full per-layer block-type list (pattern cycled to num_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    @property
    def remainder_layers(self) -> tuple[str, ...]:
        return self.pattern_layers[self.num_periods * self.period:]

    # sub-quadratic? (decides long_500k applicability)
    @property
    def subquadratic(self) -> bool:
        return all(b in ("sliding", "rglru", "ssd") or b == "attn" and False
                   for b in self.block_pattern) or not any(
            b in ("attn", "cross") for b in self.block_pattern)

    @property
    def has_global_attention(self) -> bool:
        return any(b in ("attn", "cross") for b in self.block_pattern)

    def params_count(self) -> int:
        """Analytic parameter count (for 6·N·D roofline maths)."""
        d, hd = self.d_model, self.resolved_head_dim
        nh, nkv = self.num_heads, self.num_kv_heads
        counts = {"embed": self.vocab_size * d}
        if not self.tie_embeddings:
            counts["unembed"] = self.vocab_size * d
        per = {
            "attn": d * nh * hd + 2 * d * nkv * hd + nh * hd * d,
            "sliding": d * nh * hd + 2 * d * nkv * hd + nh * hd * d,
            "cross": d * nh * hd + 2 * d * nkv * hd + nh * hd * d,
            "ssd": (2 * d * self.d_inner                      # x, z proj
                    + 2 * d * self.ssm_ngroups * self.ssm_state_dim  # B, C
                    + d * self.ssm_nheads                    # dt
                    + self.d_inner * d),                     # out
            "rglru": (2 * d * self.resolved_lru_width
                      + 2 * self.resolved_lru_width ** 2 // max(self.lru_heads or self.num_heads, 1)
                      + self.resolved_lru_width * d),
        }
        total = sum(counts.values())
        for b in self.pattern_layers:
            total += per[b]
            if b in ("attn", "sliding", "cross") or b == "rglru":
                if self.is_moe:
                    gate = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    total += (d * self.num_experts  # router
                              + self.num_experts * gate * d * self.d_ff)
                elif self.d_ff:
                    gate = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
                    total += gate * d * self.d_ff
        return total

    def active_params_count(self) -> int:
        """MoE: params touched per token (6·N_active·D)."""
        if not self.is_moe:
            return self.params_count()
        d = self.d_model
        gate = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        dense_total = self.params_count() - sum(
            self.num_experts * gate * d * self.d_ff
            for b in self.pattern_layers if b in ("attn", "sliding", "cross"))
        active_ff = sum(
            self.num_experts_per_tok * gate * d * self.d_ff
            for b in self.pattern_layers if b in ("attn", "sliding", "cross"))
        return dense_total + active_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
