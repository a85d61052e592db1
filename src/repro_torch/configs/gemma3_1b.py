"""gemma3-1b [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global sliding-window pattern, 128k-capable RoPE.
[hf:google/gemma-3-1b-pt; unverified]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,             # gemma3 uses wide heads (4*256 != d_model is fine)
    d_ff=6912,
    vocab_size=262_144,
    block_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),   # 5:1 local:global
    window=512,               # gemma3 sliding window
    rope_theta=1_000_000.0,   # long-context rope base for global layers
    mlp_type="glu",
    act="gelu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="gemma3-smoke", n_layers=8, d_model=64, n_heads=4,
    n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512, window=32)
