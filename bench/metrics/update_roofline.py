"""update_roofline — the update's share of its roofline (%), layer: the
update (`rl/ddpg.update` -> `kernels/fxp_mlp` `fxp_mlp_train_step` ->
kernels 4 + 5, `csrc/fxp_ddpg_step.cu`).

The least time one update can take on the card (`counts`, from
`bench/yardstick.py`: every product once, 2 operations a
multiply-accumulate, whatever the limbs; bound by 67 TFLOP/s float32 or
3.35 TB/s, the H100 SXM's peaks at 700 W) over the device time a timestep
of the update's four kernels.  Moves train_ips."""

KERNELS = ("ddpg_target_kernel", "ddpg_critic_kernel", "ddpg_actor_kernel", "reduce_update_kernel")


def read(ctx):
    t, bound = ctx.get("trace"), (ctx.get("counts") or {}).get("update_bound_s")
    if not t or not bound:
        return None
    spent = sum(t["kernel_s"].get(k, 0.0) for k in KERNELS) / t["timesteps"]
    if spent <= 0.0:
        return None
    return bound / spent * 100.0
