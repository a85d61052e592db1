"""lm_qat_sites_ms — device ms a step of the LM's QAT sites, layer: LM QAT
sites (`models/layers.LayerQAT.site`: the range monitor and the
phase-selected fake quantizer, `core/fixedpoint`, `core/ranges`).

The device time a step inside the span `lm.qat.site`, forward and
backward.  Moves train_ips."""

SPAN = "lm.qat.site"


def read(ctx):
    spans = ctx.get("lm_span_s")
    if not spans or spans.get(SPAN, 0.0) <= 0.0:
        return None
    return spans[SPAN] * 1e3
