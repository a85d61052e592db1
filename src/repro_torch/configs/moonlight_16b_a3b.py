"""moonlight-16b-a3b [moe] — Moonlight-16B-A3B as published (HF
`model_type` deepseek_v3): 27 layers at d_model 2048, layer 0 dense
(SwiGLU 11,264), then 26 MoE layers; latent attention (16 heads,
kv_lora_rank 512, qk_nope 128 + qk_rope 64, v 128, no q_lora_rank);
64 routed experts of width 1,408, 6 a token, sigmoid scores with the
aux-loss-free bias (noaux_tc, n_group 1), normalised gates scaled by
2.446, 2 shared experts; RoPE θ 50,000, RMSNorm ε 1e-5, vocabulary
163,840 untied, context 8,192.
[https://huggingface.co/moonshotai/Moonlight-16B-A3B/blob/main/config.json]

The bias rate γ = 0.001 and the sequence-wise balance weight α = 0.0001
are not in Moonlight's config: they are DeepSeek-V3's (arXiv:2412.19437
§2.1.2).  `CONFIG` holds all 64 experts of every layer; a chip's share of
an expert-parallel layout is `dataclasses.replace(CONFIG,
n_experts_held=..., first_expert_held=...)` (the router keeps its 64
outputs).  `moonshot_v1_16b_a3b` is the JAX reference's stand-in under
the same name (48 MHA layers, GShard softmax routing), not this block.
"""
import dataclasses

from repro_torch.models.config import MLA, DeepSeekV3Config

CONFIG = DeepSeekV3Config(
    name="moonlight-16b-a3b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163_840,
    block_pattern=(MLA,),
    rope_theta=50_000.0,
    mlp_type="glu",
    act="silu",
    norm="rmsnorm",
    n_experts=64,
    experts_per_token=6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    first_k_dense=1,
    dense_d_ff=11_264,
    n_shared_experts=2,
    norm_topk_prob=True,
    routed_scaling=2.446,
    bias_update_rate=0.001,
    seq_aux_coef=0.0001,
    rms_norm_eps=1e-5,
    # each layer recomputed whole in the backward: the "dots" policy's
    # dispatch mode doubles the host's work a step and left the card idle
    # a fifth of it at the benchmark's 2 × 8,192 tokens (PERF.md)
    remat="full",
)

SMOKE = dataclasses.replace(
    CONFIG, name="moonlight-smoke", n_layers=3, d_model=64, n_heads=4, d_ff=32, vocab_size=512,
    n_experts=8, experts_per_token=2, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, dense_d_ff=96)
