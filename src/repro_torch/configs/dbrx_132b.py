"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).
[hf:databricks/dbrx-base; unverified]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100_352,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=500_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    n_experts=16,
    experts_per_token=4,
)

SMOKE = dataclasses.replace(
    CONFIG, name="dbrx-smoke", n_layers=4, d_model=64, n_heads=8,
    n_kv_heads=2, d_ff=96, vocab_size=512, n_experts=4, experts_per_token=2)
