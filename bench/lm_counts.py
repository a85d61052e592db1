"""Operations and bytes of one LM training step of a DeepSeek-V3-block
configuration (latent attention, a dense lead, MoE layers with shared and
routed experts), as functions of the configuration file's shapes, the
traffic's batch and the rows the held experts computed.

Counting rules (fixed, so that a later datapath cannot move them):

* every matrix product of the model counts once, at 2 operations a
  multiply-accumulate; the backward is twice the forward (a weight
  product's dX and dW, attention's dQ, dK, dV and dP); recomputation
  (remat) is not counted;
* causal attention counts half its S² products: QKᵀ over the qk width
  (nope + rope) and PV over the v width;
* the routed experts count the rows their held experts computed (the
  program's `moe_rows_held`), not the rows a full layer would run;
* bytes are each input read once and each output written once, in
  bfloat16 (the compute dtype), plus the attention's float32 log-sum-exp.

The least time of a piece of work is the larger of its operations over the
H100 SXM's dense bf16 tensor-core peak and its bytes over its memory
bandwidth (NVIDIA's data sheet, at 700 W).
"""

from __future__ import annotations

PEAKS = {"card": "NVIDIA H100 SXM", "power_limit_w": 700.0, "bf16_flops": 989.4e12, "hbm_bytes_per_s": 3.35e12}
BF16, F32 = 2, 4


def shapes(config: dict, traffic: dict) -> dict:
    c = config
    return {"b": traffic["batch_size"], "s": traffic["seq_len"], "d": c["hidden_size"], "h": c["num_attention_heads"],
            "r": c["kv_lora_rank"], "dn": c["qk_nope_head_dim"], "dr": c["qk_rope_head_dim"], "dv": c["v_head_dim"],
            "dense_ff": c["intermediate_size"], "ff": c["moe_intermediate_size"], "e": c["n_routed_experts"],
            "held": c["n_experts_held"], "shared": c["n_shared_experts"], "v": c["vocab_size"],
            "layers": c["num_hidden_layers"], "dense": c["first_k_dense_replace"]}


def mla_projection_macs(x: dict) -> int:
    """Multiply-accumulates of one token through one layer's W_q, W_kv_a,
    W_kv_b and W_o."""
    return (x["d"] * x["h"] * (x["dn"] + x["dr"]) + x["d"] * (x["r"] + x["dr"])
            + x["r"] * x["h"] * (x["dn"] + x["dv"]) + x["h"] * x["dv"] * x["d"])


def attention_macs(x: dict) -> int:
    """Multiply-accumulates of one layer's causal attention (half of S²)."""
    return x["b"] * x["h"] * x["s"] * x["s"] // 2 * (x["dn"] + x["dr"] + x["dv"])


def attention_bytes(x: dict) -> int:
    """One layer's fused attention, forward and backward: q, k, v read and
    o and the log-sum-exp written; then q, k, v, o, dO and the log-sum-exp
    read and dq, dk, dv written."""
    t, h = x["b"] * x["s"], x["h"]
    qk, dv = x["dn"] + x["dr"], x["dv"]
    lse = F32 * x["b"] * h * x["s"]
    fwd = BF16 * t * h * (2 * qk + 2 * dv) + lse
    bwd = BF16 * t * h * (2 * qk + dv + 2 * dv) + lse + BF16 * t * h * (2 * qk + dv)
    return fwd + bwd


def expert_macs(x: dict, rows: float) -> float:
    """Forward multiply-accumulates of the held experts' SwiGLU over
    `rows` rows (gate, up, down)."""
    return 3 * rows * x["d"] * x["ff"]


def expert_bytes(x: dict, rows: float) -> float:
    """The held experts' weights read in the forward and the backward and
    their gradients written, in every MoE layer; each row's input read and
    output written in the forward, and in the backward its output's
    gradient and its input read and its input's gradient written."""
    moe_layers = x["layers"] - x["dense"]
    weights = 3 * x["held"] * x["d"] * x["ff"]
    return BF16 * (3 * weights * moe_layers + 5 * rows * x["d"])


def step_counts(config: dict, traffic: dict, rows_held: float) -> dict:
    """The step's operations (`step_ops`), and those and the bytes of the
    fused attention (`attn_*`) and of the held experts (`experts_*`) over
    the step, with their least times; `rows_held` the rows the held
    experts computed in the step, over every MoE layer."""
    x = shapes(config, traffic)
    t = x["b"] * x["s"]
    moe_layers = x["layers"] - x["dense"]
    per_token = (x["layers"] * mla_projection_macs(x) + x["dense"] * 3 * x["d"] * x["dense_ff"]
                 + moe_layers * (x["d"] * x["e"] + 3 * x["d"] * x["shared"] * x["ff"]) + x["d"] * x["v"])
    fwd = t * per_token + x["layers"] * attention_macs(x) + expert_macs(x, rows_held)
    attn_ops = 3 * 2 * x["layers"] * attention_macs(x)
    attn_bytes = x["layers"] * attention_bytes(x)
    experts_ops = 3 * 2 * expert_macs(x, rows_held)
    experts_bytes = expert_bytes(x, rows_held)
    return {"step_ops": 3 * 2 * fwd, "tokens": t, "rows_held": rows_held,
            "attn_ops": attn_ops, "attn_bytes": attn_bytes, "attn_bound_s": bound_s(attn_ops, attn_bytes),
            "experts_ops": experts_ops, "experts_bytes": experts_bytes,
            "experts_bound_s": bound_s(experts_ops, experts_bytes), "peaks": PEAKS}


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
