"""act_roofline — the act forward's share of its roofline (%), layer: act
(`rl/ddpg.act` -> `kernels/fxp_mlp` -> kernel B, `csrc/fxp_mlp_fwd.cu`).

The least time the actor forward over the fleet's rows can take
(`counts`, from `bench/yardstick.py`; 67 TFLOP/s float32 or 3.35 TB/s,
the H100 SXM's peaks at 700 W) over kernel B's device time a timestep.
Moves train_ips."""

KERNEL = "fxp_mlp_fwd_kernel"


def read(ctx):
    t, bound = ctx.get("trace"), (ctx.get("counts") or {}).get("act_bound_s")
    if not t or not bound:
        return None
    spent = t["kernel_s"].get(KERNEL, 0.0) / t["timesteps"]
    if spent <= 0.0:
        return None
    return bound / spent * 100.0
