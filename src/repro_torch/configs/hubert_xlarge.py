"""hubert-xlarge [audio] — encoder-only (w2v2 arch): 48L d_model=1280 16H
(kv=16) d_ff=5120 vocab=504 (masked-frame codebook targets).
Frontend per task spec: input_specs() provides precomputed conv-stem frame
embeddings (B, S, 512).  Encoder-only => no decode shapes (DESIGN.md §4).
[arXiv:2106.07447; unverified]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    block_pattern=(ATTN_GLOBAL,),
    causal=False,              # bidirectional encoder
    mlp_type="mlp",            # plain GELU FFN (w2v2)
    act="gelu",
    norm="layernorm",
    frontend="audio_stub",
    frontend_dim=512,          # conv stem output width
)

SMOKE = dataclasses.replace(
    CONFIG, name="hubert-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab_size=64, frontend_dim=32)
