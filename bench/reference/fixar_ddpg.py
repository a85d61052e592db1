"""Plain PyTorch reference of FIXAR's DDPG timestep, and the comparison
that decides a training cell's `correct`.

It imports nothing of the program.  It follows the algorithm as the
configuration states it, written out step by step:

1. act: the actor forward on the fleet's observations, plus Gaussian
   exploration noise, clipped to [-1, 1];
2. the surrogate locomotion chain steps every env of the fleet; done envs
   are reset to fresh draws (drawn every step, kept where done), and the
   observation stored as next_obs is the post-reset one;
3. the fleet's transitions go into a ring buffer, and a batch is drawn
   uniformly from what it holds;
4. one DDPG update: the critic's TD step, then the actor's through the
   updated critic, each with Adam on the Q15.16 lattice (gradient and
   stored weight projected), then the targets' soft update and one QAT
   tick.

Precision as the configuration states it (FIXAR Algorithm 1):

* monitor phase (QAT step < delay): each layer's input is projected onto
  Q15.16 and the products are float32;
* quant phase: each layer's input is fake-quantized onto the 16-bit
  affine grid of its captured range, and the products take its bfloat16
  image (16-bit activations);
* the range of each site is the running min/max of its layer input,
  folded only in the monitor phase; the backward is straight-through,
  passing where the site did not clip.

`lower=True` computes every product one step below that (bfloat16
images in the monitor phase, float8 e4m3 images in the quant phase): the
control, which has to come out as not correct.  `fault=` plants one of
the faults a training cell can have, in this reference put in the
program's place.

`start` works out a run's first state from the seed, `transitions` the
ring's contents at the start of a run (the benchmark's input, handed to the
program and, through the ring, to the follows), and `follow` runs timesteps
from a state, drawing from generators restored from that state's generator
states (`torch.Generator.set_state`) in the order and shapes the algorithm
draws them.  The check compares the program's start with `start`, follows
the first (eager) update from the program's state before it, and follows
three timesteps, each from the program's own state before it (the QAT
history before them is the program's), so it sees the same noise, resets
and sampled slots.
"""

from __future__ import annotations

import math
import statistics
from typing import Optional

import torch

Tensor = torch.Tensor

Q16 = 65536.0  # Q15.16: 16 fractional bits
RAW_MIN, RAW_MAX = -(2.0**31), 2.0**31 - 1
ACTOR_SITES = ("actor/l0", "actor/l1", "actor/l2")
CRITIC_SITES = ("critic/l0", "critic/l1", "critic/l2")
FAULTS = ("unchanged", "half_batch", "altered_reward")


# ---------------------------------------------------------------- numerics
def q32(x: Tensor) -> Tensor:
    """Onto the Q15.16 lattice: round half to even, saturating."""
    return torch.round(torch.clamp(x * Q16, RAW_MIN, RAW_MAX)) / Q16


def finalized(a_min: Tensor, a_max: Tensor, count: Tensor) -> tuple[Tensor, Tensor]:
    """A site's range as Algorithm 1 uses it: [-1, 1] before any update, and
    widened by 0.5 each way when it spans 1e-6 or less."""
    fresh = count == 0
    lo = torch.where(fresh, torch.full_like(a_min, -1.0), a_min)
    hi = torch.where(fresh, torch.full_like(a_max, 1.0), a_max)
    ok = (hi - lo) > 1e-6
    return torch.where(ok, lo, lo - 0.5), torch.where(ok, hi, hi + 0.5)


def affine(a_min: Tensor, a_max: Tensor, n_bits: int) -> tuple[Tensor, Tensor]:
    """Q_n's step and zero point: the range widened to hold 0,
    delta = span / (2^n - 1), z = round(-a_min / delta)."""
    lo = torch.clamp(a_min, max=0.0)
    hi = torch.clamp(a_max, min=0.0)
    span = lo.abs() + hi.abs()
    levels = torch.full((), 2.0**n_bits - 1.0, dtype=torch.float32, device=span.device)
    delta = torch.where(span > 0, span / levels, torch.ones_like(span))
    return delta, torch.round(-lo / delta)


def image(x: Tensor, quant: bool, lower: bool) -> Tensor:
    """What a layer's products take of its (projected) input."""
    if quant:
        dtype = torch.float8_e4m3fn if lower else torch.bfloat16
        return x.to(dtype).to(torch.float32)
    return x.to(torch.bfloat16).to(torch.float32) if lower else x


# ---------------------------------------------------------------- nets
def forward(params: dict, x: Tensor, sites: list, quant: bool, n_bits: int, acts, lower: bool):
    """One net on rows x: (y, mins, maxs, qs, hs) — each layer input's
    extrema, the products' inputs and the activations' outputs."""
    mins, maxs, qs, hs, ins = [], [], [], [], []
    for i, act in enumerate(acts):
        mins.append(x.min())
        maxs.append(x.max())
        ins.append(x)
        delta, z = sites[i]
        if quant:
            code = torch.clamp(torch.round(x / delta) + z, 0.0, 2.0**n_bits - 1.0)
            xs = (code - z) * delta
        else:
            xs = q32(x)
        q = image(xs, quant, lower)
        y = q @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        x = torch.relu(y) if act == "relu" else torch.tanh(y) if act == "tanh" else y
        qs.append(q)
        hs.append(x)
    return x, torch.stack(mins), torch.stack(maxs), qs, hs, ins


def backward(g: Tensor, params: dict, sites: list, quant: bool, n_bits: int, acts, qs, hs, ins):
    """The straight-through backward of `forward`: (dx, grads tree)."""
    grads = {}
    for i in reversed(range(len(acts))):
        if acts[i] == "relu":
            g = torch.where(hs[i] > 0.0, g, torch.zeros_like(g))
        elif acts[i] == "tanh":
            g = g * (1.0 - hs[i] * hs[i])
        grads[f"l{i}"] = {"w": qs[i].t() @ g, "b": g.sum(dim=0)}
        g = g @ params[f"l{i}"]["w"].t()
        if quant:
            delta, z = sites[i]
            inside = (ins[i] >= -z * delta) & (ins[i] <= (2.0**n_bits - 1.0 - z) * delta)
        else:
            scaled = ins[i] * Q16
            inside = (scaled >= RAW_MIN) & (scaled <= RAW_MAX)
        g = torch.where(inside, g, torch.zeros_like(g))
    return g, grads


def tree_map(fn, *trees):
    return {k: {n: fn(*(t[k][n] for t in trees)) for n in trees[0][k]} for k in trees[0]}


def adam_step(cfg: dict, p: dict, g: dict, mu: dict, nu: dict, t_target: dict, step: Tensor):
    """Adam on the Q15.16 lattice and the soft update, leaf by leaf:
    (params, mu, nu, targets, the gradient as the optimizer got it)."""
    dev = step.device
    f32 = lambda v: torch.full((), v, dtype=torch.float32, device=dev)  # noqa: E731
    t = (step + 1).to(torch.float32)
    b1, b2 = f32(cfg["adam_b1"]), f32(cfg["adam_b2"])
    bc1, bc2 = 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)
    lr, eps = f32(cfg["lr"]), f32(cfg["adam_eps"])
    tau, keep = f32(cfg["tau"]), f32(1.0 - cfg["tau"])
    omb1, omb2 = f32(1.0 - cfg["adam_b1"]), f32(1.0 - cfg["adam_b2"])
    gq = tree_map(q32, g)
    m2 = tree_map(lambda m, x: b1 * m + omb1 * x, mu, gq)
    v2 = tree_map(lambda v, x: b2 * v + omb2 * x * x, nu, gq)
    root = lambda v: torch.sqrt((v / bc2).to(torch.float64)).to(torch.float32)  # noqa: E731  correctly rounded
    p2 = tree_map(lambda w, m, v: q32(w - lr * ((m / bc1) / (root(v) + eps))), p, m2, v2)
    t2 = tree_map(lambda tt, w: keep * tt + tau * w, t_target, p2)
    return p2, m2, v2, t2, gq


# ---------------------------------------------------------------- the timestep
def _sites(state: dict, names, n_bits: int):
    out = []
    for name in names:
        a_min, a_max, count = state["ranges"][name]
        out.append(affine(*finalized(a_min, a_max, count), n_bits))
    return out


def _observe(ranges: dict, names, mins: Tensor, maxs: Tensor) -> dict:
    ranges = dict(ranges)
    for j, name in enumerate(names):
        a_min, a_max, count = ranges[name]
        ranges[name] = (torch.minimum(a_min, mins[j]), torch.maximum(a_max, maxs[j]), count + 1)
    return ranges


def update(state: dict, batch: dict, cfg: dict, lower: bool = False, half: bool = False) -> tuple[dict, dict]:
    """One DDPG update on `batch`: (new agent state, the gradients as Adam
    got them)."""
    n_bits = cfg["qat_bits"]
    quant = bool(state["qat_step"] >= cfg["qat_delay"])
    a_acts, c_acts = cfg["actor_activations"], cfg["critic_activations"]
    sa, sc = _sites(state, ACTOR_SITES, n_bits), _sites(state, CRITIC_SITES, n_bits)
    if half:
        batch = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
    obs, action, reward, next_obs = batch["obs"], batch["action"], batch["reward"], batch["next_obs"]
    done = batch["done"].to(torch.float32)
    inv_b = 1.0 / torch.clamp(torch.full((), float(obs.shape[0]), device=obs.device), min=1.0)
    run = lambda p, x, s, acts: forward(p, x, s, quant, n_bits, acts, lower)  # noqa: E731

    # the critic's TD step
    next_a = run(state["actor_target"], next_obs, sa, a_acts)[0]
    q_next = run(state["critic_target"], torch.cat([next_obs, next_a], dim=-1), sc, c_acts)[0][:, 0]
    gamma = torch.full((), cfg["gamma"], dtype=torch.float32, device=obs.device)
    y = reward + (gamma * (1.0 - done)) * q_next
    q, c_mins, c_maxs, qs, hs, ins = run(state["critic"], torch.cat([obs, action], dim=-1), sc, c_acts)
    g = ((inv_b * 2.0) * (q[:, 0] - y))[:, None]
    _, c_grad = backward(g, state["critic"], sc, quant, n_bits, c_acts, qs, hs, ins)
    c_cfg = dict(cfg, lr=cfg["critic_lr"])
    critic, c_mu, c_nu, critic_t, c_g = adam_step(
        c_cfg, state["critic"], c_grad, state["critic_mu"], state["critic_nu"], state["critic_target"],
        state["critic_opt_step"])

    # the actor's step through the updated critic
    a, a_mins, a_maxs, a_qs, a_hs, a_ins = run(state["actor"], obs, sa, a_acts)
    qa, k_mins, k_maxs, k_qs, k_hs, k_ins = run(critic, torch.cat([obs, a], dim=-1), sc, c_acts)
    g = torch.full_like(qa, -1.0) * inv_b
    dx, _ = backward(g, critic, sc, quant, n_bits, c_acts, k_qs, k_hs, k_ins)
    _, a_grad = backward(dx[:, obs.shape[1]:], state["actor"], sa, quant, n_bits, a_acts, a_qs, a_hs, a_ins)
    a_cfg = dict(cfg, lr=cfg["actor_lr"])
    actor, a_mu, a_nu, actor_t, a_g = adam_step(
        a_cfg, state["actor"], a_grad, state["actor_mu"], state["actor_nu"], state["actor_target"],
        state["actor_opt_step"])

    ranges = state["ranges"]
    if not quant:
        ranges = _observe(ranges, CRITIC_SITES, c_mins, c_maxs)
        ranges = _observe(ranges, ACTOR_SITES + CRITIC_SITES, torch.cat([a_mins, k_mins]),
                          torch.cat([a_maxs, k_maxs]))
    new = dict(state, actor=actor, critic=critic, actor_target=actor_t, critic_target=critic_t,
               actor_mu=a_mu, actor_nu=a_nu, critic_mu=c_mu, critic_nu=c_nu,
               actor_opt_step=state["actor_opt_step"] + 1, critic_opt_step=state["critic_opt_step"] + 1,
               qat_step=state["qat_step"] + 1, step=state["step"] + 1, ranges=ranges)
    return new, {"actor": a_g, "critic": c_g}


def env_obs(q: Tensor, qd: Tensor, n_aux: int) -> Tensor:
    """The chain's observation: aux positions without the root's, joint
    angles, aux velocities, joint velocities."""
    return torch.cat([q[:, 1:n_aux], q[:, n_aux:], qd[:, :n_aux], qd[:, n_aux:]], dim=-1)


def env_step(cfg: dict, q: Tensor, qd: Tensor, t: Tensor, u: Tensor):
    """The surrogate chain's dynamics (semi-implicit Euler, dt 0.05):
    (q, qd, t, obs, reward, done) before any reset."""
    dt, a = cfg["dt"], cfg["n_aux"]
    u = torch.clamp(u, -1.0, 1.0)
    aux, theta, auxd, thetad = q[:, :a], q[:, a:], qd[:, :a], qd[:, a:]
    thetad_n = thetad + dt * (cfg["torque_gain"] * u - 2.0 * thetad - 4.0 * theta)
    theta_n = theta + dt * thetad_n
    signs = torch.tensor([1.0 if j % 2 == 0 else -1.0 for j in range(cfg["n_joints"])], device=u.device)
    thrust = torch.sum(signs * torch.sin(theta) * thetad, dim=-1)
    v = aux[:, 0]
    vd = thrust - 0.5 * v
    v_n = v + dt * vd
    h, hd = aux[:, 1], auxd[:, 1]
    hd_n = hd + dt * (-4.0 * h - 1.0 * hd + 0.1 * torch.sum(torch.abs(thetad), dim=-1) - 0.2)
    h_n = h + dt * hd_n
    p, pd = aux[:, 2], auxd[:, 2]
    pd_n = pd + dt * (-2.0 * p - 1.0 * pd + 0.05 * torch.sum(u * signs, dim=-1))
    p_n = p + dt * pd_n
    q_n = torch.cat([torch.stack([v_n, h_n, p_n], dim=-1), theta_n], dim=-1)
    qd_n = torch.cat([torch.stack([vd, hd_n, pd_n], dim=-1), thetad_n], dim=-1)
    t_n = t + 1
    reward = v_n - cfg["ctrl_cost"] * torch.sum(u * u, dim=-1)
    done = t_n >= cfg["episode_length"]
    if cfg["terminate_on_fall"]:
        done = done | (h_n < cfg["fall_height"])
    return q_n, qd_n, t_n, env_obs(q_n, qd_n, a), reward, done


def timestep(s: dict, cfg: dict, gens: tuple, lower: bool = False, fault: Optional[str] = None):
    """One updating timestep from state `s` (its ring is written in
    place): (new state, what was produced)."""
    gen, env_gen = gens
    n = s["obs"].shape[0]
    eps = cfg["exploration_sigma"] * torch.randn((n, cfg["act_dim"]), generator=gen, device=gen.device)
    quant = bool(s["qat_step"] >= cfg["qat_delay"])
    a_det = forward(s["actor"], s["obs"], _sites(s, ACTOR_SITES, cfg["qat_bits"]), quant, cfg["qat_bits"],
                    cfg["actor_activations"], lower)[0]
    action = torch.clamp(a_det + eps, -1.0, 1.0)

    q, qd, t, obs, reward, done = env_step(cfg, s["env_q"], s["env_qd"], s["env_t"], action)
    if fault == "altered_reward":
        reward = reward.clone()
        reward[0] += 0.01
    dof = q.shape[1]
    q_r = 0.1 * torch.randn((n, dof), generator=env_gen, device=env_gen.device)
    qd_r = 0.1 * torch.randn((n, dof), generator=env_gen, device=env_gen.device)
    sel = done[:, None]
    q, qd = torch.where(sel, q_r, q), torch.where(sel, qd_r, qd)
    t = torch.where(done, torch.zeros_like(t), t)
    next_obs = torch.where(sel, env_obs(q_r, qd_r, cfg["n_aux"]), obs)

    cap = s["buf_obs"].shape[0]
    slots = (s["buf_ptr"] + torch.arange(n, device=s["obs"].device)) % cap
    rows = {"obs": s["obs"], "action": action, "reward": reward, "next_obs": next_obs, "done": done}
    buf = {k: s[f"buf_{k}"] for k in rows}  # the reference's own ring, written in place
    for k, v in rows.items():
        buf[k][slots] = v.to(buf[k].dtype)
    ptr = (s["buf_ptr"] + n) % cap
    size = torch.clamp(s["buf_size"] + n, max=cap)

    bound = torch.clamp(size, min=1)
    u = torch.rand((cfg["batch_size"],), generator=gen, dtype=torch.float64, device=gen.device)
    idx = torch.minimum((u * bound.to(torch.float64)).to(torch.int64), bound - 1)
    batch = {k: buf[k][idx] for k in rows}

    new = dict(s, env_q=q, env_qd=qd, env_t=t, obs=next_obs, buf_ptr=ptr, buf_size=size,
               **{f"buf_{k}": v for k, v in buf.items()})
    grads = None
    if fault != "unchanged":
        new, grads = update(new, batch, cfg, lower=lower, half=fault == "half_batch")
    made = {"action": action, "a_det": a_det, "slots": slots, "rows": rows, "grads": grads}
    return new, made


def follow(s0: dict, cfg: dict, steps: int, lower: bool = False, fault: Optional[str] = None,
           track: Optional[list] = None):
    """`steps` timesteps from the program's state `s0` (the layout the
    driver's snapshot gives, full buffer included, with the generators'
    states): [(state, what was produced)] after each step.

    With `track` (the program's snapshots after each step), every step
    after the first starts from the program's state after the step before
    (agent, optimizer, QAT ranges and counters, fleet, cursor, and the
    rows it wrote into the ring), so each step is the reference's step
    from the program's own state; the generators run on from `s0`'s."""
    dev = s0["obs"].device
    gens = []
    for key in ("gen_state", "env_gen_state"):
        g = torch.Generator(device=dev)
        g.set_state(s0[key])
        gens.append(g)
    out, s = [], s0
    with torch.no_grad():
        for k in range(steps):
            s, made = timestep(s, cfg, tuple(gens), lower=lower, fault=fault)
            out.append((s, made))
            if track is not None:
                p = track[k]
                for key, v in p["rows"].items():
                    s[f"buf_{key}"][made["slots"]] = v.to(s[f"buf_{key}"].dtype)
                s = dict(s, **{key: v for key, v in p.items() if key in s and not key.startswith("buf_")},
                         buf_ptr=p["buf_ptr"], buf_size=p["buf_size"])
    return out


def _init_net(gen: torch.Generator, dims: list) -> dict:
    """DDPG's initialisation (Lillicrap et al. 2015): uniform in
    ±1/sqrt(fan_in), the last layer in ±3e-3, weight then bias layer by
    layer, drawn from a host generator; then onto the Q15.16 lattice (the
    weight memory is fixed point from step 0)."""
    net = {}
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        bound = 3e-3 if i == len(dims) - 2 else float(k) ** -0.5
        w = torch.empty((k, n), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
        b = torch.empty((n,), dtype=torch.float32).uniform_(-bound, bound, generator=gen)
        net[f"l{i}"] = {"w": q32(w), "b": q32(b)}
    return net


def start(cfg: dict, seed: int, n_envs: int, device) -> dict:
    """The training state a run starts from, worked out from the seed: the
    agent from a host generator seeded `seed` (actor, then critic), targets
    equal to the nets, Adam and the QAT monitors empty; the fleet's first
    states from a device generator seeded `seed + 1`, 0.1 × standard
    normal positions then velocities; the loop's generator seeded
    `seed + 2`.  (The ring is the benchmark's input: `transitions`.)"""
    host = torch.Generator().manual_seed(seed)
    hidden = list(cfg["hidden"])
    nets = {"actor": _init_net(host, [cfg["obs_dim"], *hidden, cfg["act_dim"]]),
            "critic": _init_net(host, [cfg["obs_dim"] + cfg["act_dim"], *hidden, 1])}
    nets = {k: tree_map(lambda t: t.to(device), v) for k, v in nets.items()}
    zeros = lambda t: torch.zeros_like(t)  # noqa: E731
    env_gen = torch.Generator(device=device).manual_seed(seed + 1)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    dof = cfg["n_joints"] + cfg["n_aux"]
    q = 0.1 * torch.randn((n_envs, dof), generator=env_gen, device=device)
    qd = 0.1 * torch.randn((n_envs, dof), generator=env_gen, device=device)
    scalar = lambda v, dt: torch.full((), v, dtype=dt, device=device)  # noqa: E731
    return {
        **nets, "actor_target": tree_map(torch.clone, nets["actor"]),
        "critic_target": tree_map(torch.clone, nets["critic"]),
        **{f"{n}_{m}": tree_map(zeros, nets[n]) for n in ("actor", "critic") for m in ("mu", "nu")},
        "actor_opt_step": scalar(0, torch.int32), "critic_opt_step": scalar(0, torch.int32),
        "qat_step": scalar(0, torch.int32), "step": scalar(0, torch.int32),
        "ranges": {site: (scalar(math.inf, torch.float32), scalar(-math.inf, torch.float32), scalar(0, torch.int32))
                   for site in ACTOR_SITES + CRITIC_SITES},
        "env_q": q, "env_qd": qd, "env_t": torch.zeros((n_envs,), dtype=torch.int32, device=device),
        "obs": env_obs(q, qd, cfg["n_aux"]),
        "gen_state": gen.get_state(), "env_gen_state": env_gen.get_state(),
    }


FILL_WIDTH = 4000  # envs of the fleet that makes the ring's contents


def transitions(cfg: dict, seed: int, rows: int, device):
    """The ring's contents at the start of a run, `rows` transitions made
    from the seed: a fleet of up to 4,000 surrogate envs from 0.1 × standard
    normal positions and velocities, stepped under uniform random actions
    in [-1, 1] and reset as the timestep resets them, every draw from a
    device generator seeded `seed + 3`.  Yields (first row, rows in the
    ring's layout) a fleet step at a time, so that the whole never sits in
    memory twice."""
    gen = torch.Generator(device=device).manual_seed(seed + 3)
    n = min(rows, FILL_WIDTH)
    dof = cfg["n_joints"] + cfg["n_aux"]
    normal = lambda: 0.1 * torch.randn((n, dof), generator=gen, device=device)  # noqa: E731
    q, qd = normal(), normal()
    t = torch.zeros((n,), dtype=torch.int32, device=device)
    obs = env_obs(q, qd, cfg["n_aux"])
    with torch.no_grad():
        for lo in range(0, rows, n):
            u = 2.0 * torch.rand((n, cfg["act_dim"]), generator=gen, device=device) - 1.0
            q, qd, t, obs_n, reward, done = env_step(cfg, q, qd, t, u)
            q_r, qd_r = normal(), normal()
            sel = done[:, None]
            q, qd = torch.where(sel, q_r, q), torch.where(sel, qd_r, qd)
            t = torch.where(done, torch.zeros_like(t), t)
            next_obs = torch.where(sel, env_obs(q_r, qd_r, cfg["n_aux"]), obs_n)
            k = min(n, rows - lo)
            yield lo, {"obs": obs[:k], "action": u[:k], "reward": reward[:k], "next_obs": next_obs[:k],
                       "done": done[:k]}
            obs = next_obs


START_KEYS = ("actor", "critic", "actor_target", "critic_target", "actor_mu", "actor_nu", "critic_mu", "critic_nu",
              "env_q", "env_qd", "env_t", "obs")


def compare_start(prog: dict, ref: dict) -> float:
    """How many of the start's tensors differ from the seed's, bit for bit."""
    flat = lambda x: [x] if isinstance(x, Tensor) else [t for v in x.values() for t in flat(v)]  # noqa: E731
    pairs = [(a, b) for k in START_KEYS for a, b in zip(flat(prog[k]), flat(ref[k]), strict=True)]
    return float(sum(not torch.equal(a.cpu(), b.cpu()) for a, b in pairs))


# ---------------------------------------------------------------- the comparison
def _norm(x: Tensor) -> float:
    return float(torch.linalg.vector_norm(x.to(torch.float64)))


def _leaf_gaps(prog: dict, ref: dict, skip=frozenset()) -> tuple[float, float]:
    """Each leaf's gap of norms, program against reference, over the
    reference's norm of that leaf or of the median leaf, whichever is
    larger: (the median leaf's gap, the worst leaf's gap)."""
    norms = {k: (_norm(prog[k]), _norm(ref[k])) for k in ref if k not in skip}
    median = sorted(r for _, r in norms.values())[len(norms) // 2]
    gaps = sorted(abs(p - r) / max(r, median, 1e-30) for p, r in norms.values())
    return gaps[len(gaps) // 2], gaps[-1]


def _leaves(tree: dict, prefix: str) -> dict:
    return {f"{prefix}.{k}.{n}": tree[k][n] for k in tree for n in tree[k]}


def _field_gap(pairs: list) -> float:
    """The worst field's largest gap, program against reference, over the
    reference's largest magnitude of that field or of the median field,
    whichever is larger (one env's reward can be all but zero)."""
    scales = [float(b.abs().max()) if b.numel() else 0.0 for _, b in pairs]
    floor = sorted(scales)[len(scales) // 2]
    return max(float((a.to(torch.float64) - b.to(torch.float64)).abs().max()) / max(scale, floor, 1e-12)
               for (a, b), scale in zip(pairs, scales))


def compare(s0: dict, prog: list, ref: list, cfg: dict) -> dict:
    """The numbers compared, each a reading that a sound run keeps small:

    act      — the actions the program stored, against the reference's:
               the median over the steps of each step's largest gap;
    env      — the fleet's state, observations and rewards after each step
               (1 where a done flag or an episode clock differs);
    replay   — the rows written and the ring's cursor (1 where ptr or size
               differs);
               env and replay each the worst field's gap (`_field_gap`);
               these three from `ref` that followed each step from the
               program's state before it (`follow(track=)`);
    grad     — each step's gradient as the optimizer got it, worked out
               from the first moment before and after ((mu1 - b1 mu0) /
               (1 - b1)): the median over the steps of the median leaf's
               gap of norms (`grad_median`) and of the worst leaf's
               (`grad_worst`);
    change   — the change of every parameter and target in step 1, the
               same two (`change_median`, `change_worst`);
    moments  — Adam's two moments after step 1, the same two;
    ranges   — the QAT sites' ranges after the three steps (`compare_ranges`);
    counters — how many step counters differ (agent, both optimizers, the
               QAT step, each site's range count): exact.

    Leaves whose gradient in the reference is under a thousandth of the
    median leaf's move by round-off alone and are left out of grad,
    change and moments (their targets stay in).

    The worst leaf swings from seed to seed by single discrete decisions
    (a ReLU at a pre-activation one rounding from 0, a 16-bit code or a
    Q15.16 weight one rounding from its edge) landing in a small leaf; the
    median leaf's gap is steady, so the limits hold the median numbers.
    Change and moments are read after step 1.  Act, env, replay and grad
    are read from each step's own start (`follow(track=)`): a gradient
    element one Q15.16 rounding from zero becomes a whole Adam step of
    about lr, several lattice units, in one weight, and a later step's
    action moves with it in sound runs.  Grad is the median over the
    steps: most leaves' gradients are a few tens of Q15.16 units, so one
    input code of one row rounded the other way in the update's forward
    tips elements of several leaves by a unit, and that step's median
    leaf then reads up to about 1e-3 in a sound run.  Act is the median
    over the steps too: in the quant phase one 16-bit code at a tie in
    the last layer's input, rounded the other way, moves that step's
    action by a bfloat16 unit of the code's value times a weight.  Such
    steps are rare; a fault or the control moves every step."""
    b1 = float(cfg["adam_b1"])
    read = {}
    scale_a = max(float(m["a_det"].abs().max()) for _, m in ref)
    read["act"] = statistics.median(float((p["rows"]["action"].double() - m["action"].double()).abs().max())
                                    for p, (_, m) in zip(prog, ref)) / max(scale_a, 1e-6)
    env, replay = 0.0, 0.0
    for p, (r, m) in zip(prog, ref):
        env = max(env, _field_gap([(p[key], r[key]) for key in ("env_q", "env_qd", "obs")]
                                  + [(p["rows"]["reward"], m["rows"]["reward"])]))
        if not torch.equal(p["env_t"], r["env_t"]) or not torch.equal(p["rows"]["done"], m["rows"]["done"]):
            env = max(env, 1.0)
        replay = max(replay, _field_gap([(p["rows"][k], v) for k, v in m["rows"].items() if k != "done"]))
        if int(p["buf_ptr"]) != int(r["buf_ptr"]) or int(p["buf_size"]) != int(r["buf_size"]):
            replay = max(replay, 1.0)
    read["env"], read["replay"] = env, replay

    gaps, skips = [], []
    for step, (p, (_, m)) in enumerate(zip(prog, ref)):
        g_ref = {**_leaves(m["grads"]["actor"], "actor"), **_leaves(m["grads"]["critic"], "critic")}
        norms = sorted(_norm(v) for v in g_ref.values())
        skips.append({k for k, v in g_ref.items() if _norm(v) < 1e-3 * norms[len(norms) // 2]})
        before = s0 if step == 0 else prog[step - 1]
        g_prog = {}
        for net in ("actor", "critic"):
            mu0, mu1 = _leaves(before[f"{net}_mu"], net), _leaves(p[f"{net}_mu"], net)
            for k in mu0:
                g_prog[k] = (mu1[k].double() - b1 * mu0[k].double()) / (1.0 - b1)
        gaps.append(_leaf_gaps(g_prog, g_ref, skips[-1]))
    read["grad_median"] = statistics.median(g for g, _ in gaps)
    read["grad_worst"] = statistics.median(w for _, w in gaps)
    skip = skips[0]

    first_p, first_r = prog[0], ref[0][0]
    d_prog, d_ref, m_prog, m_ref = {}, {}, {}, {}
    for net in ("actor", "critic"):
        for kind, tag in ((net, net), (f"{net}_target", f"{net}.target")):
            p0, pp, rr = (_leaves(x[kind], tag) for x in (s0, first_p, first_r))
            for k in p0:
                d_prog[k] = pp[k].double() - p0[k].double()
                d_ref[k] = rr[k].double() - p0[k].double()
        for mom in ("mu", "nu"):
            pp, rr = _leaves(first_p[f"{net}_{mom}"], net), _leaves(first_r[f"{net}_{mom}"], net)
            for k in pp:
                m_prog[f"{k}.{mom}"], m_ref[f"{k}.{mom}"] = pp[k], rr[k]
    read["change_median"], read["change_worst"] = _leaf_gaps(d_prog, d_ref, skip)
    read["moments_median"], read["moments_worst"] = _leaf_gaps(
        m_prog, m_ref, {f"{k}.{m}" for k in skip for m in ("mu", "nu")})

    last_p, last_r = prog[-1], ref[-1][0]
    counters = sum(int(int(last_p["ranges"][name][2]) != int(r[2])) for name, r in last_r["ranges"].items())
    for key in ("step", "actor_opt_step", "critic_opt_step", "qat_step"):
        counters += int(int(last_p[key]) != int(last_r[key]))
    read["ranges"], read["counters"] = compare_ranges(last_p, last_r), float(counters)
    return read


def compare_ranges(prog: dict, ref: dict) -> float:
    """The QAT sites' ranges, the program's against the reference's: the
    worst site's gap over its span in the reference (1 where one side's
    bound is infinite and the other's is not, or where the fold counts
    differ)."""
    gap = 0.0
    for name, (lo_r, hi_r, c_r) in ref["ranges"].items():
        lo_p, hi_p, c_p = prog["ranges"][name]
        span = max(float((hi_r - lo_r).abs()), 1e-12) if math.isfinite(float(hi_r - lo_r)) else 1.0
        for a, b in ((lo_p, lo_r), (hi_p, hi_r)):
            if not (math.isfinite(float(a)) and math.isfinite(float(b))):
                gap = max(gap, 0.0 if float(a) == float(b) else 1.0)
            else:
                gap = max(gap, abs(float(a) - float(b)) / span)
        if int(c_p) != int(c_r):
            gap = max(gap, 1.0)
    return gap
