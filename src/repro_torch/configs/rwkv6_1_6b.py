"""rwkv6-1.6b [ssm] — Finch: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, data-dependent decay. [arXiv:2404.05892; unverified]
"""
import dataclasses

from repro_torch.models.config import RWKV6, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / rwkv_head_dim
    n_kv_heads=32,
    d_ff=7168,
    vocab_size=65_536,
    block_pattern=(RWKV6,),
    rwkv_head_dim=64,
    mlp_type="mlp",        # rwkv channel-mix (squared-relu), see rwkv6.py
    norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, name="rwkv6-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=512, rwkv_head_dim=16)
