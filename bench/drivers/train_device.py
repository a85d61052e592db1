"""Driver of the training cells: FIXAR's DDPG timestep loop through the
program's device-resident window (`repro_torch.rl.loop`), whose updating
timestep is one CUDA graph replayed.

The loop that `train_device` runs between evaluations is driven here
directly (`init_train_state` and the window class `loop._Window`, the
same calls `train_device` makes), because the output check needs the
whole training state — fleet, replay ring and generators as well as the
agent — before and after single timesteps, and `train_device` hands its
`eval_fn` only the agent.

A run, in order (set-up is everything before step 5):

1. build the agent, fleet, replay and noise from the seed on the card;
2. fill the whole replay ring with transitions made from the seed
   (`transitions` of the configuration's reference), as a paper run's
   ring is full for all but its first thousandth: the batches are gathers
   from the whole ring, not from the few rows a run itself writes;
3. run the warm-up timesteps, if the mix has any (eager, no update), the
   first updating timestep (eager, snapshots before and after it) and the
   capture of the updating timestep, then replay it until the QAT phase is
   the cell's (the quant-phase cells cross the delay here), then one
   unmeasured window;
4. snapshot the state and run the three checked timesteps, one replay
   each, with a snapshot after each (every snapshot is kept on the host);
5. measure whole windows of `window_timesteps` until `--seconds` have
   passed, each ending in the one device read `train_device` makes;
6. with `--trace 1`, one more window under the profiler;
7. read the memory peak, free the program's state, and follow the first
   update and the three checked timesteps with the plain reference on the
   card.
"""

from __future__ import annotations

import time

import torch

NETS = ("actor", "critic", "actor_target", "critic_target")


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def _tree(params: dict) -> dict:
    return {k: {n: _cpu(v) for n, v in layer.items()} for k, layer in params.items()}


def reference_config(config: dict, traffic: dict) -> dict:
    """The plain reference's settings: the configuration's, with the
    traffic's batch and QAT delay."""
    return dict(config, batch_size=traffic["batch_size"], qat_delay=traffic["qat_delay"])


class Cell:
    """One training cell's program state on `device` (module docstring)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.phases = {"start": time.perf_counter()}
        from repro_torch.rl import ddpg, loop
        from repro_torch.rl.envs import locomotion

        self.phases["import_program"] = time.perf_counter()
        self.config, self.traffic, self.seed, self.loop = config, traffic, seed, loop
        self.env = locomotion.make(config["env"], episode_length=config["episode_length"])
        for key in ("n_joints", "n_aux", "torque_gain", "ctrl_cost", "terminate_on_fall", "fall_height"):
            if getattr(self.env, key) != config[key]:
                raise ValueError(f"the program's {config['env']} has {key}={getattr(self.env, key)!r}, "
                                 f"the configuration states {config[key]!r}")
        if (self.env.spec.obs_dim, self.env.spec.act_dim) != (config["obs_dim"], config["act_dim"]):
            raise ValueError(f"the program's {config['env']} has dims {self.env.spec}")
        self.tcfg = loop.TrainConfig(
            total_steps=2**62, warmup_steps=traffic["warmup_steps"], replay_capacity=config["replay_capacity"],
            eval_every=traffic["window_timesteps"], n_envs=traffic["n_envs"], seed=seed,
            noise_kind=config["exploration"], noise_sigma=config["exploration_sigma"])
        self.dcfg = ddpg.DDPGConfig(
            gamma=config["gamma"], tau=config["tau"], actor_lr=config["actor_lr"], critic_lr=config["critic_lr"],
            batch_size=traffic["batch_size"], qat_delay=traffic["qat_delay"], qat_bits=config["qat_bits"],
            backend=config["backend"], exploration_sigma=config["exploration_sigma"])
        from repro_torch.optim.fxp_adam import FxpAdamConfig

        adam = FxpAdamConfig()
        stated = {"hidden": (tuple(ddpg.HIDDEN), tuple(config["hidden"])),
                  "adam": ((adam.b1, adam.b2, adam.eps), (config["adam_b1"], config["adam_b2"], config["adam_eps"]))}
        for key, (program, configured) in stated.items():
            if program != configured:
                raise ValueError(f"the program's {key} is {program}, the configuration states {configured}")
        ts = loop.init_train_state(self.env, self.tcfg, self.dcfg, device=device)
        self.win = loop._Window(ts, self.env, self.tcfg, self.dcfg)
        self.mark("init")
        self.step = 0
        self.window = traffic["window_timesteps"]
        self.snaps: dict = {}

    @property
    def ts(self):
        return self.win.ts

    def run(self, steps: int) -> float:
        """`steps` timesteps; ends in the window's one device read."""
        reward_sum, _ = self.win.run(self.step, steps)
        self.step += steps
        return float(reward_sum)

    def quant_phase(self) -> bool:
        return int(self.ts.agent.qat.step) >= self.dcfg.qat_delay

    def fill_ring(self, ref_module) -> None:
        """Set-up step 2: the reference's transitions from the seed into
        the program's ring, which then holds `replay_capacity` rows, its
        cursor at 0."""
        buf = self.ts.buf
        cfg = reference_config(self.config, self.traffic)
        for lo, rows in ref_module.transitions(cfg, self.seed, buf.capacity, buf.obs.device):
            for k, v in rows.items():
                getattr(buf, k)[lo:lo + v.shape[0]] = v.to(getattr(buf, k).dtype)
        buf.ptr.fill_(0)
        buf.size.fill_(buf.capacity)

    def prepare(self, ref_module) -> None:
        """Set-up steps 2 and 3 (module docstring), with snapshots of the
        start and of the first update; `phases` records when each ended."""
        self.snaps["start"] = self.snapshot("start")
        self.fill_ring(ref_module)
        self.mark("fill")
        warm = next(s for s in range(10**9) if self.loop._updates_at(s, self.tcfg))
        self.run(warm)
        self.snaps["first0"] = self.snapshot("ring")
        self.run(1)  # the first update, eager
        self.snaps["first1"] = self.snapshot("rows")
        self.mark("first_update")
        self.run(1)  # the capture and its first replay
        self.mark("capture")
        if self.traffic["phase"] == "quant":
            self.run(max(0, self.dcfg.qat_delay - int(self.ts.agent.qat.step)))
        self.run(self.window)
        self.mark("unmeasured")
        if self.win.graph is None and self.ts.obs.device.type == "cuda":
            raise RuntimeError("the updating timestep was not captured")

    def mark(self, phase: str) -> None:
        if self.ts.obs.device.type == "cuda":
            torch.cuda.synchronize()
        self.phases[phase] = time.perf_counter()

    def snapshot(self, kind: str) -> dict:
        """The state in the reference's layout, on the host: "start" the
        agent and the fleet; "ring" also the whole replay ring and the
        generators' states; "rows" also the rows the last timestep wrote."""
        ts, a = self.ts, self.ts.agent
        s = {net: _tree(getattr(a, net)) for net in NETS}
        for net in ("actor", "critic"):
            opt = getattr(a, f"{net}_opt")
            s[f"{net}_mu"], s[f"{net}_nu"], s[f"{net}_opt_step"] = _tree(opt.mu), _tree(opt.nu), _cpu(opt.step)
        s["qat_step"], s["step"] = _cpu(a.qat.step), _cpu(a.step)
        s["ranges"] = {k: (_cpu(r.a_min), _cpu(r.a_max), _cpu(r.count)) for k, r in a.qat.ranges.items()}
        s["env_q"], s["env_qd"], s["env_t"], s["obs"] = (_cpu(x) for x in (ts.env_state.q, ts.env_state.qd,
                                                                           ts.env_state.t, ts.obs))
        s["buf_ptr"], s["buf_size"] = _cpu(ts.buf.ptr), _cpu(ts.buf.size)
        fields = ("obs", "action", "reward", "next_obs", "done")
        if kind == "ring":
            for k in fields:
                s[f"buf_{k}"] = _cpu(getattr(ts.buf, k))
            s["gen_state"], s["env_gen_state"] = ts.gen.get_state(), ts.env_gen.get_state()
        elif kind == "rows":
            n, cap = ts.obs.shape[0], ts.buf.capacity
            slots = (self._ptr + torch.arange(n, device=ts.obs.device)) % cap
            s["rows"] = {k: _cpu(getattr(ts.buf, k)[slots]) for k in fields}
        self._ptr = ts.buf.ptr.clone()
        return s

    def checked_steps(self, steps: int) -> dict:
        """Set-up step 4: every snapshot the check reads.  The one before
        the checked steps records whether the program is in the cell's QAT
        phase."""
        self.snaps["s0"] = self.snapshot("ring")
        self.snaps["s0"]["phase_is_the_cells"] = self.quant_phase() == (self.traffic["phase"] == "quant")
        after = []
        for _ in range(steps):
            self.run(1)
            after.append(self.snapshot("rows"))
        self.snaps["after"] = after
        self.mark("checked")
        return self.snaps

    def close(self) -> None:
        del self.win
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


def to_device(x, device):
    if isinstance(x, dict):
        return {k: to_device(v, device) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_device(v, device) for v in x)
    if isinstance(x, torch.Tensor) and x.dtype != torch.uint8:  # generator states stay on the host
        return x.to(device)
    return x


def _strip_ring(s: dict) -> dict:
    return {k: v for k, v in s.items() if not k.startswith("buf_") or k in ("buf_ptr", "buf_size")}


def check(ref_module, config: dict, traffic: dict, seed: int, snaps: dict, device: str) -> dict:
    """The readings of the program's snapshots against the plain reference:
    its start against the reference's start from the seed (exact), the QAT
    ranges after its first update against the reference's first update
    from the program's state before it, and the three checked timesteps,
    each of which the reference follows from the program's state before
    it."""
    cfg = reference_config(config, traffic)
    read = {"start": ref_module.compare_start(snaps["start"], ref_module.start(cfg, seed, traffic["n_envs"], device))}
    (first, _), = ref_module.follow(to_device(snaps["first0"], device), cfg, 1)
    read["ranges_first"] = ref_module.compare_ranges(to_device(snaps["first1"], device), first)
    del first
    s0 = to_device(snaps["s0"], device)
    prog = [to_device(s, device) for s in snaps["after"]]
    ref = ref_module.follow(s0, cfg, len(prog), track=prog)
    read.update(ref_module.compare(s0, prog, ref, cfg))
    read["phase"] = 0.0 if snaps["s0"]["phase_is_the_cells"] else 1.0
    return read


def stand_in(ref_module, config: dict, traffic: dict, seed: int, snaps: dict, device: str, lower=False,
             fault=None) -> dict:
    """The reference put in the program's place (the control, or a planted
    fault), in the snapshots' layout: its own start from the seed, and the
    first update and the checked timesteps from the program's state before
    them."""
    cfg = reference_config(config, traffic)
    out = {"start": to_device(ref_module.start(cfg, seed, traffic["n_envs"], device), "cpu"),
           "first0": snaps["first0"], "s0": snaps["s0"]}
    (first, _), = ref_module.follow(to_device(snaps["first0"], device), cfg, 1, lower=lower, fault=fault)
    out["first1"] = to_device(_strip_ring(first), "cpu")
    del first
    after = []
    for s, made in ref_module.follow(to_device(snaps["s0"], device), cfg, len(snaps["after"]), lower=lower,
                                     fault=fault):
        s = _strip_ring(s)
        s["rows"] = made["rows"]
        after.append(to_device(s, "cpu"))
    out["after"] = after
    return out


def run(h) -> dict:
    """One run of a training cell (module docstring).  `h` is the harness
    (`bench/run.py`): config, traffic, seed, seconds, trace, device and the
    reference module."""
    from repro_torch.rl import loop

    cell = Cell(h.config, h.traffic, h.seed, h.device)
    cell.prepare(h.reference)
    snaps = cell.checked_steps(h.traffic["checked_steps"])
    h.sync()

    meter = h.energy_meter()
    n_envs = h.traffic["n_envs"]
    timesteps = 0
    t0 = time.perf_counter()
    meter.start()
    while True:
        cell.run(cell.window)
        timesteps += cell.window
        t1 = time.perf_counter()
        if t1 - t0 >= h.seconds:
            break
    joules = meter.stop()
    out = {"window_start": t0, "timesteps": timesteps, "seconds": t1 - t0,
           "attempted": timesteps, "failed": 0,
           "end_to_end": {"train_ips": timesteps * n_envs / (t1 - t0)},
           "energy_source": meter.source,
           "setup_phases": {k: round(v - h.started, 3) for k, v in {**h.phases, **cell.phases}.items()}}
    if joules:
        out["end_to_end"]["train_samples_per_j"] = timesteps * n_envs / joules
        out["joules"] = joules

    if h.trace:
        from bench import trace, yardstick

        replays0 = loop.train_device.graph_replays
        events = trace.capture(lambda: cell.run(cell.window))
        out["trace"] = dict(trace.reduce(events), timesteps=cell.window,
                            replays=loop.train_device.graph_replays - replays0)
        out["layer_inputs"] = {"trace": out["trace"], "counts": yardstick.timestep(h.config, h.traffic),
                               "timesteps_per_s": timesteps / (t1 - t0), "peaks": yardstick.PEAKS}
    out["memory_peak_bytes"] = h.memory_peak()
    cell.close()
    t_check = time.perf_counter()
    out["readings"] = check(h.reference, h.config, h.traffic, h.seed, snaps, h.device)
    out["check_s"] = time.perf_counter() - t_check
    return out


__all__ = ["Cell", "run", "check", "stand_in", "reference_config"]
