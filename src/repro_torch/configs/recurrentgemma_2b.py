"""recurrentgemma-2b [hybrid] — Griffin: 26L d_model=2560 10H (GQA kv=1)
d_ff=7680 vocab=256000, RG-LRU + local attention at 1:2 (attn:recurrent).
[arXiv:2402.19427; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_LOCAL, RGLRU, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    block_pattern=(RGLRU, RGLRU, ATTN_LOCAL),  # 2 recurrent : 1 local attn
    window=2048,
    rope_theta=10_000.0,
    mlp_type="glu",
    act="gelu",
    norm="rmsnorm",
    rnn_state_dim=2560,
    conv1d_width=4,
    tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="rg-smoke", n_layers=6, d_model=64, n_heads=2,
    n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512, window=32,
    rnn_state_dim=64)
