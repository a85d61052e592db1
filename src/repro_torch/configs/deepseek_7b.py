"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32, MHA) d_ff=11008
vocab=102400, llama-arch. [arXiv:2401.02954; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab_size=102_400,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=10_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
)

SMOKE = dataclasses.replace(
    CONFIG, name="deepseek-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=160, vocab_size=512)
