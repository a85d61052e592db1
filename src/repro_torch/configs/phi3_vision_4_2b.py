"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend stub:
32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
Frontend per task spec: input_specs() provides precomputed patch embeddings
(B, 144, 1024) which a learned projection maps into the first 144 positions.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=10_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    frontend="vision_stub",
    frontend_dim=1024,        # CLIP-L/14 hidden
    frontend_len=144,         # 336px / 14 / 2 pooled -> 12x12 patches
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3v-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, frontend_dim=32, frontend_len=8)
