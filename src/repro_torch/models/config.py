"""Model configuration schema for the architecture zoo (port of
`repro.models.config`; `compute_dtype` is a `torch.dtype`).

One `ModelConfig` describes any of the 10 assigned architectures (plus the
reduced smoke variants).  Heterogeneous layer stacks (gemma3's 5:1
local:global, recurrentgemma's 2:1 RG-LRU:local-attn) are expressed as a
`block_pattern` cycled over the depth; the transformer assembly scans over
whole pattern periods and unrolls the remainder (MaxText-style stacked-param
scan, see transformer.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# block types
ATTN_GLOBAL = "global"        # full (causal or bidir) attention + MLP
ATTN_LOCAL = "local"          # sliding-window attention + MLP
RWKV6 = "rwkv6"               # RWKV-6 time-mix + channel-mix
RGLRU = "rglru"               # RecurrentGemma recurrent block + MLP
MLA = "mla"                   # latent attention + MLP or MoE (`DeepSeekV3Config`)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default d_model // n_heads
    block_pattern: tuple[str, ...] = (ATTN_GLOBAL,)
    window: int = 1024                      # local-attention window
    rope_theta: float = 10_000.0
    qkv_bias: bool = False                  # qwen2
    mlp_type: str = "glu"                   # "glu" | "mlp"
    act: str = "silu"                       # "silu" | "gelu"
    norm: str = "rmsnorm"                   # "rmsnorm" | "layernorm"
    tie_embeddings: bool = False
    causal: bool = True                     # False => encoder (hubert)
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # --- recurrent (rwkv6 / rglru) ---
    rnn_state_dim: Optional[int] = None     # rglru recurrent width
    rwkv_head_dim: int = 64
    conv1d_width: int = 4                   # rglru temporal conv
    # --- frontend stubs (vlm/audio): embeddings arrive precomputed ---
    frontend: str = "none"                  # none | vision_stub | audio_stub
    frontend_dim: int = 0                   # incoming embedding width
    frontend_len: int = 0                   # number of frontend positions
    # --- numerics / training ---
    dtype: str = "bfloat16"
    # "dots" (checkpoint_dots) measured strictly better than "full" on the
    # roofline: full remat re-executes the psum-bearing ops in the backward
    # pass (gemma3 train: collective 3.76 -> 1.80 s, compute -21%, §Perf-6)
    remat: str = "dots"                     # none | dots | full
    # QAT (FIXAR technique as a first-class feature)
    qat: bool = False
    qat_delay: int = 0
    qat_bits: int = 16

    @property
    def is_mla(self) -> bool:
        """The DeepSeek-V3 block (`DeepSeekV3Config`): latent attention, its
        MoE routed by sigmoid scores and a bias held in the train state."""
        return MLA in self.block_pattern

    @property
    def n_lead(self) -> int:
        """Layers walked before the block pattern's periods (params and
        ranges "lead"); `DeepSeekV3Config`'s dense layers."""
        return 0

    @property
    def norm_eps(self) -> float:
        return 1e-6

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def n_tail(self) -> int:
        return self.n_layers % len(self.block_pattern)

    def layer_types(self) -> list[str]:
        p = self.block_pattern
        return [p[i % len(p)] for i in range(self.n_layers)]

    def params_per_token(self) -> int:
        """Active parameter count per token (for 6·N·D MODEL_FLOPS)."""
        d, f, hd = self.d_model, self.d_ff, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        total = 0
        for t in self.layer_types():
            if t in (ATTN_GLOBAL, ATTN_LOCAL):
                attn = d * hd * (n_q + 2 * n_kv) + n_q * hd * d
                total += attn + self._mlp_params(d, f, active=True)
            elif t == RWKV6:
                # time-mix: r,k,v,g,o projections + decay lora; channel-mix
                total += 5 * d * d + self._mlp_params(d, f, active=True)
            elif t == RGLRU:
                rnn = self.rnn_state_dim or d
                total += 2 * d * rnn + rnn * d + self._mlp_params(d, f, active=True)
        total += 2 * d * self.vocab_size if not self.tie_embeddings \
            else d * self.vocab_size
        return total

    def _mlp_params(self, d, f, active=False):
        per_expert = (3 if self.mlp_type == "glu" else 2) * d * f
        if not self.is_moe:
            return per_expert
        k = self.experts_per_token if active else self.n_experts
        return per_expert * k + d * self.n_experts  # + router

    def total_params(self) -> int:
        d, f = self.d_model, self.d_ff
        hd, n_q, n_kv = self.hd, self.n_heads, self.n_kv_heads
        total = 0
        for t in self.layer_types():
            if t in (ATTN_GLOBAL, ATTN_LOCAL):
                total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
                total += self._mlp_params(d, f, active=False)
            elif t == RWKV6:
                total += 5 * d * d + self._mlp_params(d, f, active=False)
            elif t == RGLRU:
                rnn = self.rnn_state_dim or d
                total += 2 * d * rnn + rnn * d + self._mlp_params(d, f, active=False)
        total += 2 * d * self.vocab_size if not self.tie_embeddings \
            else d * self.vocab_size
        return total


@dataclasses.dataclass(frozen=True)
class DeepSeekV3Config(ModelConfig):
    """The DeepSeek-V3 block (HF `model_type` deepseek_v3): `first_k_dense`
    leading layers of latent attention (MLA) with a dense SwiGLU of width
    `dense_d_ff`, then `block_pattern` (`(MLA,)`) layers of MLA with a MoE of
    `n_experts` routed experts of width `d_ff` and `n_shared_experts` shared
    ones.  `n_layers` counts every layer.

    MLA: q = x·W_q, (heads, `qk_nope_head_dim` + `qk_rope_head_dim`); the
    latent c = RMSNorm(x·W_kv_a[:kv_lora_rank]) expanded by W_kv_b into
    per-head k_nope (`qk_nope_head_dim`) and v (`v_head_dim`); one roped
    key part of `qk_rope_head_dim` shared by the heads.

    Routing (`models.moe.route_sigmoid`): sigmoid scores
    over all `n_experts`, the top `experts_per_token` chosen by score +
    a bias held in the train state (not a parameter; moved by
    `bias_update_rate`·sign(mean load − load) after each step), gates the
    chosen scores normalised (`norm_topk_prob`) and scaled by
    `routed_scaling`, a sequence-wise balance loss weighted
    `seq_aux_coef`.  The layer holds experts `first_expert_held` ..
    + `n_experts_held` − 1 (0: all) and computes their part of the result,
    dropless, with no exchange."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_k_dense: int = 1
    dense_d_ff: int = 0
    n_shared_experts: int = 0
    norm_topk_prob: bool = True
    routed_scaling: float = 1.0
    n_experts_held: int = 0
    first_expert_held: int = 0
    bias_update_rate: float = 0.0
    seq_aux_coef: float = 0.0
    rms_norm_eps: float = 1e-6

    @property
    def n_lead(self) -> int:
        return self.first_k_dense

    @property
    def norm_eps(self) -> float:
        return self.rms_norm_eps

    @property
    def n_periods(self) -> int:
        return (self.n_layers - self.first_k_dense) // len(self.block_pattern)

    @property
    def n_tail(self) -> int:
        return (self.n_layers - self.first_k_dense) % len(self.block_pattern)

    def layer_types(self) -> list[str]:
        return [MLA] * (self.n_layers - self.first_k_dense)

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def experts_held(self) -> range:
        n = self.n_experts_held or self.n_experts
        return range(self.first_expert_held, self.first_expert_held + n)

    def params_per_token(self) -> int:
        return self._count(active=True)

    def total_params(self) -> int:
        """Parameters held: the held experts only."""
        return self._count(active=False)

    def _count(self, active: bool) -> int:
        d, h = self.d_model, self.n_heads
        attn = (d * h * self.qk_head_dim + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * h * (self.qk_nope_head_dim + self.v_head_dim) + h * self.v_head_dim * d
                + self.kv_lora_rank + 2 * d)  # + the latent's and the block's norm scales
        experts = self.experts_per_token if active else len(self.experts_held)
        moe = 3 * d * self.d_ff * (experts + self.n_shared_experts) + d * self.n_experts
        total = self.first_k_dense * (attn + 3 * d * self.dense_d_ff) + self.n_periods * (attn + moe)
        return total + 2 * d * self.vocab_size + d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch × shape) grid."""

    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
