"""qwen2-0.5b [dense] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151936, QKV bias, tied embeddings. [arXiv:2407.10671; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=1_000_000.0,
    qkv_bias=True,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="qwen2-smoke", n_layers=4, d_model=56, n_heads=14,
    n_kv_heads=2, head_dim=4, d_ff=128, vocab_size=512)
