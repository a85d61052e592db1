"""plain_ops_ms — device ms a timestep of the timestep's plain PyTorch
operations (layer: the env fleet `rl/envs` `step_fleet`, `rl/noise`,
`rl/replay` and the window's state copies).

Every device operation of the traced window that is not one of the
port's hand-written kernels (the list below: each `__global__` of
`src/repro_torch/csrc/`), over the window's timesteps.  Moves train_ips."""

PORT_KERNELS = frozenset({
    "fxp_mlp_fwd_kernel",  # kernel B, csrc/fxp_mlp_fwd.cu
    "dense_tiled", "dense_small",  # kernel A, csrc/fxp_dense.cu
    "bwd_chain_kernel", "bwd_dw_kernel",  # kernel 3, csrc/fxp_mlp_bwd.cu
    "ddpg_target_kernel", "ddpg_critic_kernel", "ddpg_actor_kernel", "reduce_update_kernel",  # 4, 5
    "mq_kernel",  # kernel 6, csrc/fxp_monitor_quant.cu
})


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["ops"]:
        return None
    plain = sum(end - start for name, start, end in t["ops"] if name not in PORT_KERNELS)
    return plain / t["timesteps"] * 1e3
