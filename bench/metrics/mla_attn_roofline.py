"""mla_attn_roofline — the fused latent attention's share of its roofline
(%), layer: LM attention (`models/layers.mla_forward` ->
`causal_attention`, PyTorch's cuDNN SDPA).

The least time of the step's fused attention, forward and backward over
every layer (`lm_counts`: the larger of its operations at 989.4 TFLOP/s
and its bytes at 3.35 TB/s, the H100 SXM's peaks at 700 W), over the
device time a step inside the span `lm.mla.attend`.  Moves train_ips."""

SPAN = "lm.mla.attend"


def read(ctx):
    counts, spans = ctx.get("lm_counts"), ctx.get("lm_span_s")
    if not counts or not spans or spans.get(SPAN, 0.0) <= 0.0:
        return None
    return counts["attn_bound_s"] / spans[SPAN] * 100.0
