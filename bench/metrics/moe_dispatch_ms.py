"""moe_dispatch_ms — device ms a step of the MoE's routing and dispatch,
layer: LM MoE routing and dispatch (`models/moe.route_sigmoid`, the
balance loss, the sort of the held pairs by expert, the gather of their
rows and the gated combine).

The device time a step inside the spans `lm.moe.route` and
`lm.moe.dispatch`, forward and backward.  Moves train_ips."""

SPANS = ("lm.moe.route", "lm.moe.dispatch")


def read(ctx):
    spans = ctx.get("lm_span_s")
    if not spans or not any(spans.get(s, 0.0) > 0.0 for s in SPANS):
        return None
    return sum(spans.get(s, 0.0) for s in SPANS) * 1e3
