"""internlm2-1.8b [dense] — 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544. [arXiv:2403.17297; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92_544,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=1_000_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512)
