"""moe_experts_roofline — the held experts' share of their roofline (%),
layer: LM MoE experts (`models/moe.ds_moe_forward` -> `_held_experts`, one
product a weight an expert over its contiguous rows).

The least time of the held experts' products, forward and backward, at
the rows they computed (`lm_counts`: the larger of the operations at
989.4 TFLOP/s and the bytes at 3.35 TB/s, the H100 SXM's peaks at 700 W),
over the device time a step inside the span `lm.moe.experts` (the QAT
site nested in it is its own span).  Moves train_ips."""

SPAN = "lm.moe.experts"


def read(ctx):
    counts, spans = ctx.get("lm_counts"), ctx.get("lm_span_s")
    if not counts or not spans or spans.get(SPAN, 0.0) <= 0.0:
        return None
    return counts["experts_bound_s"] / spans[SPAN] * 100.0
