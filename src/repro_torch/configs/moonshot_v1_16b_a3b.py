"""moonshot-v1-16b-a3b [moe] — the JAX reference's stand-in under
Moonlight's name: 48 layers of plain MHA, d_model=2048 16H (kv=16),
per-expert d_ff=1408, vocab=163840, a GShard capacity MoE with softmax
top-6 over 64 experts (tokens past capacity dropped), no shared experts
and no dense first layer.  It mirrors the reference's config, which the
tests hold it to; it is not Moonlight's published block.  That block
(latent attention, 2 shared + 64 sigmoid-routed experts behind one dense
layer, 27 layers) is `moonlight_16b_a3b`.
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""
import dataclasses

from repro_torch.models.config import ATTN_GLOBAL, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    block_pattern=(ATTN_GLOBAL,),
    rope_theta=50_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    n_experts=64,
    experts_per_token=6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="moonshot-smoke", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=48, vocab_size=512, n_experts=8, experts_per_token=2)
