"""timestep_kernels — device kernels a timestep (count), layer: the driver
(`rl/loop.py`: `train_device`'s window, one CUDA graph a timestep).

Every kernel in the profiler's trace of one traced window (memory copies
and sets left out), over the timesteps of that window.  The traced
timesteps are graph replays: the reader refuses a window whose replay
count (`train_device.graph_replays`) is not its timestep count.  Moves
train_ips."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t["ops"]:
        return None
    if t["replays"] != t["timesteps"]:
        raise RuntimeError(f"{t['replays']} graph replays in a traced window of {t['timesteps']} timesteps")
    kernels = sum(1 for name, _, _ in t["ops"] if not name.startswith(("Memcpy", "Memset")))
    return kernels / t["timesteps"]
