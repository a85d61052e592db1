"""lm_train_mfu — the LM training step's share of the card's peak (%),
layer: the device, over the whole step.

The step's model operations (`lm_counts`, from `bench/lm_counts.py`: every
product once, 2 operations a multiply-accumulate, causal attention at half
its S² products, the routed experts at the rows `moe_rows_held` gives)
times the steps a second of the run's measured (untraced) windows on the
host's clock, over 989.4 TFLOP/s, the H100 SXM's dense bf16 peak at 700 W.
Moves train_ips."""


def read(ctx):
    counts, rate = ctx.get("lm_counts"), ctx.get("lm_steps_per_s") or 0.0
    if not counts or rate <= 0.0:
        return None
    return counts["step_ops"] * rate / counts["peaks"]["bf16_flops"] * 100.0
