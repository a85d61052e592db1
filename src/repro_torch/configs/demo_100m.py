"""demo-100m — ~110M-param llama-style model for the end-to-end CPU train
driver (deliverable (b): train a ~100M model for a few hundred steps)."""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="demo-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=3072,
    vocab_size=32_768,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=10_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="demo-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab_size=512)
