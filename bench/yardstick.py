"""The benchmark's frozen yardstick: the card's peaks and the operations and
bytes of FIXAR's timestep, as functions of the shapes alone.

Counting rules (kept fixed so that a later datapath cannot move them):

* every product of the algorithm counts once, at 2 operations a
  multiply-accumulate, whatever number of limbs or passes an
  implementation spends on it (the monitor phase and the quant phase
  count the same);
* an update counts the target actor and target critic on next_obs, the
  critic forward, its dW and its hidden dx, the actor forward, the
  critic forward through the updated critic and its dx down to the
  action columns, and the actor's dW and hidden dx; plus 23 elementwise
  operations a parameter for the projections, Adam and the soft update;
* the act forward is 2 × rows × the actor's multiply-accumulates;
* bytes are each input read once and each output written once: for an
  update the parameters, Adam moments and targets of both nets (read and
  written) and the batch (read); for the act forward the actor's
  parameters and the observations (read) and the actions (written).

The least time a piece of work can take on the card is the larger of its
operations over the float32 peak outside the tensor cores (the rate the
port's fixed-point datapath, float32 FMA limbs, runs at) and its bytes
over the memory bandwidth.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.
PEAKS = {
    "card": "NVIDIA H100 SXM",
    "power_limit_w": 700.0,
    "f32_flops": 67e12,  # float32 outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}

ELEMENTWISE_PER_PARAM = 23  # two projections, Adam, the soft update
F32 = 4
BOOL = 1


def macs(dims) -> int:
    """Multiply-accumulates of one row through a dense net of widths `dims`."""
    return sum(k * n for k, n in zip(dims[:-1], dims[1:]))


def n_params(dims) -> int:
    return macs(dims) + sum(dims[1:])


def nets(obs_dim: int, act_dim: int, hidden) -> tuple[list[int], list[int]]:
    """(actor widths, critic widths) of the paper's DDPG nets."""
    return [obs_dim, *hidden, act_dim], [obs_dim + act_dim, *hidden, 1]


def update_ops(obs_dim: int, act_dim: int, hidden, batch: int) -> int:
    a, c = nets(obs_dim, act_dim, hidden)
    ma, mc = macs(a), macs(c)
    per_row = (
        ma + mc  # target actor, target critic on next_obs
        + mc + mc + (mc - c[0] * c[1])  # critic forward, dW, hidden dx
        + ma  # actor forward
        + mc + (mc - c[0] * c[1] + act_dim * c[1])  # updated critic forward, dx to the action
        + ma + (ma - a[0] * a[1])  # actor dW, hidden dx
    )
    return 2 * batch * per_row + ELEMENTWISE_PER_PARAM * (n_params(a) + n_params(c))


def update_bytes(obs_dim: int, act_dim: int, hidden, batch: int) -> int:
    a, c = nets(obs_dim, act_dim, hidden)
    state = 4 * (n_params(a) + n_params(c))  # parameters, two moments, targets
    batch_bytes = batch * (F32 * (2 * obs_dim + act_dim + 1) + BOOL)  # obs, action, reward, next_obs; done
    return F32 * 2 * state + batch_bytes


def act_ops(obs_dim: int, act_dim: int, hidden, rows: int) -> int:
    return 2 * rows * macs(nets(obs_dim, act_dim, hidden)[0])


def act_bytes(obs_dim: int, act_dim: int, hidden, rows: int) -> int:
    a = nets(obs_dim, act_dim, hidden)[0]
    return F32 * (n_params(a) + rows * (obs_dim + act_dim))


def bound_s(ops: float, nbytes: float) -> tuple[float, str]:
    """(least seconds on the card, "operations" or "bytes": which sets it)."""
    t_ops = ops / PEAKS["f32_flops"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def timestep(config: dict, traffic: dict) -> dict:
    """The counts of one training timestep of a cell (an act forward over
    the fleet and one update), with their bounds."""
    obs, act, hidden = config["obs_dim"], config["act_dim"], config["hidden"]
    u_ops = update_ops(obs, act, hidden, traffic["batch_size"])
    u_bytes = update_bytes(obs, act, hidden, traffic["batch_size"])
    a_ops = act_ops(obs, act, hidden, traffic["n_envs"])
    a_bytes = act_bytes(obs, act, hidden, traffic["n_envs"])
    u_bound, u_by = bound_s(u_ops, u_bytes)
    a_bound, a_by = bound_s(a_ops, a_bytes)
    return {
        "update_ops": u_ops, "update_bytes": u_bytes, "update_bound_s": u_bound, "update_bound_by": u_by,
        "act_ops": a_ops, "act_bytes": a_bytes, "act_bound_s": a_bound, "act_bound_by": a_by,
        "timestep_ops": u_ops + a_ops,
    }
