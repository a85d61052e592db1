"""train_mfu — the whole timestep's share of the card's peak (%), layer:
the device, over the whole timestep.

The algorithm's operations a timestep (`counts`, from `bench/yardstick.py`:
one update and the act forward over the fleet, every product once) times
the timesteps a second of the run's measured (untraced) windows on the
host's clock, over 67 TFLOP/s, the H100 SXM's float32 peak outside the
tensor cores at 700 W — the rate the port's fixed-point datapath (float32
FMA limbs) runs at.  Moves train_ips."""


def read(ctx):
    ops = (ctx.get("counts") or {}).get("timestep_ops")
    rate = ctx.get("timesteps_per_s") or 0.0
    if not ops or rate <= 0.0:
        return None
    return ops * rate / ctx["peaks"]["f32_flops"] * 100.0
