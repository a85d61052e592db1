"""Driver of the LM training cells: a DeepSeek-V3-block model (latent
attention, shared and sigmoid-routed experts behind leading dense layers)
trained through the program's normal LM path, `train.step.make_train_step`,
with 16-bit QAT and Adam on the Q15.16 lattice, on the data of the port's
synthetic stream (`data.synthetic`).

The program's model is the registry's configuration (`program_arch`) with
the configuration file's cut applied by `dataclasses.replace` (its layers,
the experts held, the vocabulary); every other width of the file has to be
the registry's, or the run stops before it allocates anything.

A run, in order (set-up is everything before step 3):

1. build the train state from the seed on the card, and the data stream;
2. train the QAT delay's steps (the monitor phase; the quant-phase cells
   cross it here), a copy of the parameters and the routing bias before
   each, and its routing, kept on the host; then one unmeasured window;
3. measure whole windows of `window_timesteps` steps until `--seconds`
   have passed, each ending in one device read of the step's metrics (the
   loss and the MoE counters), the data pipeline running inside;
4. with `--trace 1`, `trace_timesteps` more steps under the profiler
   (`for_reduce` says what of the trace `bench.trace.reduce` reads);
5. read the memory peak; then the checked step: on the state the windows
   left, the program's forward on the step's batch (its routing kept),
   its loss and gradients (`train.step.value_and_grad`, the call the step
   makes) and the step itself, a copy of every result kept (on the card:
   the state before and after, the moments and the gradients fit beside
   the step); free the program's state; the plain reference folds the QAT
   ranges from the monitor phase's steps on its own, and follows the
   checked step with them, on the card, layer by layer.

On the CPU (the CPU tests only: the harness never runs a cell there) the
configuration's `cpu_cut` sizes replace the file's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict

import torch

SPANS = ("lm.mla.attend", "lm.moe.route", "lm.moe.dispatch", "lm.moe.experts", "lm.qat.site")
# the configuration file's keys that are program fields, and the fields
FIELDS = {"num_hidden_layers": "n_layers", "hidden_size": "d_model", "num_attention_heads": "n_heads",
          "num_key_value_heads": "n_kv_heads", "moe_intermediate_size": "d_ff", "vocab_size": "vocab_size",
          "rope_theta": "rope_theta", "n_routed_experts": "n_experts", "num_experts_per_tok": "experts_per_token",
          "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_head_dim",
          "qk_rope_head_dim": "qk_rope_head_dim", "v_head_dim": "v_head_dim",
          "first_k_dense_replace": "first_k_dense", "intermediate_size": "dense_d_ff",
          "n_shared_experts": "n_shared_experts", "norm_topk_prob": "norm_topk_prob",
          "routed_scaling_factor": "routed_scaling", "n_experts_held": "n_experts_held",
          "first_expert_held": "first_expert_held", "bias_update_rate": "bias_update_rate",
          "seq_aux_alpha": "seq_aux_coef", "rms_norm_eps": "rms_norm_eps", "qat_bits": "qat_bits"}
CUT = ("num_hidden_layers", "vocab_size", "n_experts_held", "first_expert_held")
ROUTE_MARGIN = 3e-3  # the near-tie margin of the routing's comparison (`check`; PERF.md says why)


def effective(config: dict, traffic: dict, device: str) -> tuple[dict, dict]:
    """The configuration and mix as run on `device` (the CPU: `cpu_cut`)."""
    if device != "cpu":
        return config, traffic
    cut = config["cpu_cut"]
    return dict(config, **cut), dict(traffic, seq_len=cut["seq_len"])


def program_config(config: dict, traffic: dict, on_card: bool):
    """The program's `DeepSeekV3Config` for the file (module docstring)."""
    from repro_torch.configs import registry

    base = registry.get(config["program_arch"])
    program = {"hidden_act": base.act, "tie_word_embeddings": base.tie_embeddings, "q_lora_rank": None, "n_group": 1,
               "scoring_func": "sigmoid" if base.is_mla else "softmax", "topk_method": "noaux_tc"}
    for key, value in program.items():
        if config[key] != value:
            raise ValueError(f"the configuration's {key}={config[key]!r}; the program's {config['program_arch']} "
                             f"has {value!r}")
    if on_card:
        for key, field in FIELDS.items():
            if key not in CUT and key in config and config[key] != getattr(base, field):
                raise ValueError(f"the configuration's {key}={config[key]!r}; the program's {field} is "
                                 f"{getattr(base, field)!r}")
    cfg = dataclasses.replace(base, **{f: config[k] for k, f in FIELDS.items() if k in config},
                              dtype=config["compute_dtype"], qat=True, qat_delay=traffic["qat_delay"])
    return cfg


class Cell:
    """One LM training cell's program state on `device` (module docstring)."""

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.phases = {"start": time.perf_counter()}
        config, traffic = effective(config, traffic, device)
        from repro_torch.data.synthetic import DataConfig, DataIterator
        from repro_torch.models.config import ShapeConfig
        from repro_torch.optim.adam import AdamConfig
        from repro_torch.train import step as train_step

        self.cfg = program_config(config, traffic, device != "cpu")
        self.phases["import_program"] = time.perf_counter()
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.opt_cfg = AdamConfig(lr=config["adam_lr"], b1=config["adam_b1"], b2=config["adam_b2"],
                                  eps=config["adam_eps"])
        self.train_step = train_step
        self.step_fn = train_step.make_train_step(self.cfg, self.opt_cfg)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.state = train_step.init_state(gen, self.cfg, device=device)
        dcfg = DataConfig(seed=seed, zipf_a=traffic["zipf_a"], structure_period=traffic["structure_period"])
        self.shape = ShapeConfig("lm_train", "train", traffic["seq_len"], traffic["batch_size"])
        self.data = DataIterator(dcfg, self.cfg, self.shape, device=device)
        self.window = traffic["window_timesteps"]
        self.steps = 0
        self.monitor: list[dict] = []
        self.mark("init")

    def mark(self, phase: str) -> None:
        if self.device != "cpu":
            torch.cuda.synchronize()
        self.phases[phase] = time.perf_counter()

    def run(self, steps: int) -> dict:
        """`steps` train steps; ends in one device read of the last step's
        loss and MoE counters."""
        for _ in range(steps):
            self.state, metrics = self.step_fn(self.state, next(self.data))
        self.steps += steps
        keys = sorted(k for k in metrics if k != "moe_load")
        return dict(zip(keys, torch.stack([metrics[k].to(torch.float32) for k in keys]).tolist()))

    def prepare(self, ref_module=None) -> None:
        """Set-up step 2: the QAT delay's steps, each one's parameters,
        routing bias, data step and routing kept on the host first; then
        one window.  (`ref_module`, and `checked_steps`' `steps`, are the
        drivers' common signature; this cell checks one step.)"""
        for _ in range(self.traffic["qat_delay"]):
            ts, data_step, batch = self.state, self.data.step, next(self.data)
            with torch.no_grad():  # the step's routing: the same forward, its ranges dropped
                _, extras = _forward(ts, batch, self.cfg)
            self.monitor.append({"data_step": data_step, "params": to_reference(ts.params, _cpu),
                                 "bias": _cpu(ts.router_bias), "chosen": _cpu(extras["moe"]["experts"])})
            del extras
            self.state, _ = self.step_fn(ts, batch)
            self.steps += 1
        self.mark("delay")
        self.run(self.window)
        self.mark("unmeasured")

    def checked_steps(self, steps: int = 1) -> dict:
        """The checked step (module docstring, step 5) on the current state:
        every result in the reference's layout."""
        ts, cfg = self.state, self.cfg
        data_step = self.data.step
        batch = next(self.data)
        quant = ts.step >= cfg.qat_delay
        snaps = {"data_step": data_step, "tokens": _cpu(batch["tokens"]), "labels": _cpu(batch["labels"]),
                 "phase_is_the_cells": bool(quant) == (self.traffic["phase"] == "quant"),
                 "params": to_reference(ts.params), "ranges": ranges_of(ts.ranges, bool(quant)),
                 "bias": _copy(ts.router_bias), "mu": to_reference(ts.opt.mu), "nu": to_reference(ts.opt.nu),
                 "adam_step": int(ts.opt.step) + 1, "monitor": self.monitor}
        with torch.no_grad():
            logits, extras = _forward(ts, batch, cfg)
        snaps["logits"] = logits[0].to(torch.float32)
        snaps["chosen"] = extras["moe"]["experts"]
        del logits, extras
        loss, _, grads = self.train_step.value_and_grad(cfg, ts.params, ts.ranges, batch, quant,
                                                        router_bias=ts.router_bias)
        snaps["loss"] = float(loss)
        snaps["grads"] = to_reference(grads)
        del grads
        new, metrics = self.step_fn(ts, batch)
        self.state = new
        snaps["after"] = to_reference(new.params)
        snaps["bias_after"] = _copy(new.router_bias)
        snaps["load"] = _copy(metrics["moe_load"])
        self.mark("checked")
        return snaps

    def close(self) -> None:
        del self.state
        if self.device != "cpu":
            torch.cuda.empty_cache()


def _forward(ts, batch, cfg):
    from repro_torch.models import transformer as T

    return T.forward(ts.params, batch, cfg, ranges=ts.ranges, quant_phase=ts.step >= cfg.qat_delay,
                     router_bias=ts.router_bias)


def _cpu(t):
    return t.detach().to("cpu", copy=True)


def _copy(t):
    return t.detach().clone()


def to_reference(params: dict, copy=None) -> dict:
    """A copy (`copy`, by default a clone where it lies) of a program
    tree (params, gradients or moments) in the reference's layout: the
    lead layers, then the stacked MoE layers one by one."""
    def block(bp, dense):
        a = bp["attn"]
        out = {"ln1": bp["ln1"]["scale"], "ln2": bp["ln2"]["scale"],
               **{k: a[k] for k in ("wq", "wkv_a", "kv_norm", "wkv_b", "wo")}}
        if dense:
            out["mlp"] = dict(bp["ffn"])
        else:
            out.update({k: bp["ffn"][k] for k in ("router", "wg", "wu", "wd")}, shared=dict(bp["ffn"]["shared"]))
        return out

    layers = [block(bp, True) for bp in params.get("lead", [])]
    stacked = params["scan"][0]
    n = stacked["ln1"]["scale"].shape[0]
    layers += [block(_index(stacked, i), False) for i in range(n)]
    tree = {"embed": params["embed"]["embedding"], "head": params["embed"]["head"],
            "final_norm": params["final_norm"]["scale"], "layers": layers}
    return _map(copy or _copy, tree)


def _index(tree, i):
    return {k: _index(v, i) for k, v in tree.items()} if isinstance(tree, dict) else tree[i]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def ranges_of(ranges: dict, quant: bool):
    """The program's finalized (frozen, in the quant phase) ranges in the
    reference's layout: per layer {site: (min, max)}, and the head's."""
    if not quant:
        return None
    from repro_torch.core.ranges import RangeStat, finalized

    def sites(tree, i):
        return {s: tuple(float(v) for v in finalized(RangeStat(r.a_min[i], r.a_max[i], r.count[i])))
                for s, r in tree.items()}

    layers = [sites(t, 0) for t in ranges.get("lead", [])]
    scan = ranges["scan"][0]
    layers += [sites(scan, i) for i in range(next(iter(scan.values())).a_min.shape[0])]
    return {"layers": layers, "head": sites(ranges["head"], 0)}


# --------------------------------------------------------------------------- the check
def _to(tree, device):
    return _map(lambda t: t.to(device) if isinstance(t, torch.Tensor) else t, tree)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.to(torch.float32) - b.to(torch.float32)).norm() / b.to(torch.float32).norm().clamp_min(1e-30))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _leaves(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _phase(snaps) -> str:
    return "quant" if snaps["ranges"] is not None else "monitor"


def reference_step(ref, config, traffic, snaps, ranges, device, lower=False, follow=True) -> dict:
    """The reference's step from the state before the checked step, on
    `ranges`; with `follow`, taking the snapshots' routing where a
    near-tie of `ROUTE_MARGIN` admits it."""
    st = ref.settings(config)
    params = _to(snaps["params"], device)
    return ref.step_grads(params, _to(ranges, device) if ranges else None, snaps["bias"].to(device),
                          snaps["tokens"].to(device), snaps["labels"].to(device), _phase(snaps), st, lower=lower,
                          logits_rows=1, follow=snaps["chosen"].to(device) if follow else None, margin=ROUTE_MARGIN)


def reference_ranges(ref, config, traffic, seed, snaps, device, lower=False, follow=True):
    """The ranges the reference folds from the monitor phase's steps, on
    their parameters and bias and the stream's tokens at their steps (with
    `follow`, taking the program's routing there where a near-tie admits
    it); None for a cell checked in the monitor phase (no range is
    frozen)."""
    if _phase(snaps) != "quant":
        return None
    st = ref.settings(config)
    passes = []
    for m in snaps["monitor"]:
        tokens, _ = ref.stream(seed, m["data_step"], traffic["batch_size"], traffic["seq_len"], st["vocab"],
                               traffic["zipf_a"], traffic["structure_period"])
        chosen = m["chosen"].to(device) if follow else None
        passes.append((_to(m["params"], device), m["bias"].to(device), tokens.to(device), chosen))
    return ref.monitor_ranges(passes, st, lower=lower, margin=ROUTE_MARGIN)


def _range_gap(prog: dict, want: dict) -> float:
    """The largest gap of a site's frozen min or max from the reference's,
    over the reference's span."""
    pairs = [(pl[k], wl[k]) for pl, wl in zip(prog["layers"], want["layers"], strict=True) for k in wl]
    pairs += [(prog["head"][k], want["head"][k]) for k in want["head"]]
    return max(max(abs(p[0] - w[0]), abs(p[1] - w[1])) / max(w[1] - w[0], 1e-30) for p, w in pairs)


def check(ref, config: dict, traffic: dict, seed: int, snaps: dict, device: str) -> dict:
    """The readings of the program's checked step against the plain
    reference, which folds the QAT ranges from the monitor phase's steps
    on its own and follows the checked step from the program's state
    before it, on its own ranges:

    start: the share of the step's tokens and labels that are not the
      stream's at (seed, step) (exact);
    range_rel: the largest gap of a site's frozen min or max from the
      reference's fold, over the site's span;
    loss_rel, logits_rel (one sequence), grad_rel_median (the median
      leaf's relative L2 gap), grad_rel_worst (the worst latent attention
      or expert leaf's) and grad_rel_router (the worst router's);
    route_mismatch: the share of the program's chosen (token, expert)
      pairs whose biased score lies more than `ROUTE_MARGIN` below the
      reference's k-th largest (or that repeat an expert); where a token's
      choice has no such pair the reference takes it, so that a near-tie
      broken the other way does not part the two runs after it;
    route_followed: the share of tokens whose choice the reference took
      in place of its own top k (what the margin excused; no limit);
    update_rel: the relative L2 gap, over every leaf, of the parameters'
      change against the reference's (its gradients, Adam, the lattice
      projections);
    bias_exact: the largest gap of the program's new routing bias from the
      rule applied to the program's own loads (exact);
    phase: 0 when the program was in the cell's QAT phase."""
    config, traffic = effective(config, traffic, device)
    st = ref.settings(config)
    tokens, labels = ref.stream(seed, snaps["data_step"], traffic["batch_size"], traffic["seq_len"],
                                st["vocab"], traffic["zipf_a"], traffic["structure_period"])
    start = float(((tokens != snaps["tokens"]) | (labels != snaps["labels"])).float().mean())
    ranges = reference_ranges(ref, config, traffic, seed, snaps, device)
    r = reference_step(ref, config, traffic, snaps, ranges, device)
    read = {"start": start, "range_rel": _range_gap(snaps["ranges"], ranges) if ranges else 0.0,
            "loss_rel": abs(snaps["loss"] - float(r["loss"])) / abs(float(r["loss"])),
            "logits_rel": _rel(snaps["logits"].to(device), r["logits"][0])}
    gaps = {}
    for (name, g), (_, gr) in zip(_leaves(snaps["grads"]), _leaves(r["grads"]), strict=True):
        gaps[name] = _rel(g.to(device), gr)
    worst = [v for k, v in gaps.items() if any(w in k for w in ("wq", "wkv_a", "wkv_b", "wo", ".wg", ".wu", ".wd"))
             and "mlp" not in k and "shared" not in k]
    read["grad_rel_median"] = float(torch.tensor(sorted(gaps.values())).median())
    read["grad_rel_worst"] = max(worst)
    read["grad_rel_router"] = max(v for k, v in gaps.items() if k.endswith(".router"))
    read["route_mismatch"] = float(r["inadmissible"].float().mean())
    read["route_followed"] = float(r["followed"].float().mean())
    num = den = 0.0
    step = snaps["adam_step"]
    for (_, p0), (_, g), (_, m), (_, v), (_, p1) in zip(*(_leaves(t) for t in (
            snaps["params"], r["grads"], snaps["mu"], snaps["nu"], snaps["after"])), strict=True):
        p0d = p0.to(device)
        want, _, _ = ref.adam_leaf(p0d, g, m.to(device), v.to(device), step, st)
        num += float(((p1.to(device) - p0d) - (want - p0d)).square().sum())
        den += float((want - p0d).square().sum())
    read["update_rel"] = (num / max(den, 1e-30)) ** 0.5
    rule = ref.bias_rule(snaps["bias"].to(device), snaps["load"].to(device), st["gamma"])
    read["bias_exact"] = float((snaps["bias_after"].to(device) - rule).abs().max())
    read["phase"] = 0.0 if snaps["phase_is_the_cells"] else 1.0
    return read


def stand_in(ref, config: dict, traffic: dict, seed: int, snaps: dict, device: str, lower=False,
             fault=None) -> dict:
    """The reference put in the program's place (the control, or a planted
    fault), in the snapshots' layout, from the program's state before the
    checked step, routing on its own throughout: the ranges it folds, and
    on them its loss, gradients, logits and choices, its Adam on its own
    gradients, its bias rule on its own loads."""
    config, traffic = effective(config, traffic, device)
    st = ref.settings(config)
    ranges = reference_ranges(ref, config, traffic, seed, snaps, device, lower=lower, follow=False)
    if fault == "expert_in_unfolded" and ranges:  # the site left as it started, which `finalized` makes [-1, 1]
        for layer in ranges["layers"]:
            if "expert_in" in layer:
                layer["expert_in"] = (-1.0, 1.0)
    r = reference_step(ref, config, traffic, snaps, ranges, device, lower=lower, follow=False)
    out = dict(snaps, ranges=ranges, loss=float(r["loss"]), logits=r["logits"][0], chosen=r["chosen"],
               grads=r["grads"], load=r["load"])
    after = []
    for (_, p0), (_, g), (_, m), (_, v) in zip(_leaves(snaps["params"]), _leaves(out["grads"]), _leaves(snaps["mu"]),
                                               _leaves(snaps["nu"]), strict=True):
        p1, _, _ = ref.adam_leaf(p0.to(device), g.to(device), m.to(device), v.to(device), snaps["adam_step"], st)
        after.append(p1)
    out["after"] = _unflatten(snaps["params"], after)
    out["bias_after"] = ref.bias_rule(snaps["bias"].to(device), r["load"], st["gamma"])
    if fault == "unchanged":
        out["after"], out["bias_after"] = snaps["params"], snaps["bias"]
    elif fault == "bias_frozen":
        out["bias_after"] = snaps["bias"]
    return out


def _unflatten(template, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    return build(template)


# --------------------------------------------------------------------------- spans
def _runtime_call(e: dict) -> bool:
    """A CUDA runtime or driver call on the host (its name: this card's
    profiler gives no activity kinds)."""
    return not e["device"] and e["name"].startswith("cu")


def _kernel(e: dict) -> bool:
    """A device operation, not the device's copy of a host range."""
    from bench import trace

    return e["device"] and e["name"] not in (trace.WINDOW,) + SPANS


def span_device_s(events: list[dict]) -> dict:
    """Device seconds inside each of `SPANS` over a traced window: each
    device operation goes to the innermost span around its launch on the
    host, matched by correlation id."""
    from bench import trace

    windows = [e for e in events if e["name"] == trace.WINDOW and not e["device"]]
    w0, w1 = windows[0]["start"], windows[0]["end"]
    launch = {e["corr"]: e["start"] for e in events if _runtime_call(e) and e["corr"]}
    marks = []
    for i, e in enumerate(events):
        if not e["device"] and e["name"] in SPANS:
            marks += [(e["start"], 0, i), (e["end"], 2, i)]
    ops = [e for e in events if _kernel(e) and w0 <= e["start"] and e["end"] <= w1 and e["corr"] in launch]
    marks += [(launch[e["corr"]], 1, j) for j, e in enumerate(ops)]
    marks.sort()
    out, open_ = defaultdict(float), []
    for _, kind, i in marks:
        if kind == 0:
            open_.append(i)
        elif kind == 2:
            if i in open_:
                open_.remove(i)
        elif open_:
            out[events[open_[-1]]["name"]] += ops[i]["end"] - ops[i]["start"]
    return dict(out)


def for_reduce(events: list[dict]) -> list[dict]:
    """The events `bench.trace.reduce` is given: every device operation
    (not the device's copies of the spans, which would count as busy time),
    and of the host's only the window, the spans and the CUDA runtime and
    driver calls other than kernel launches (the syncs and copies a gap
    waits on).  `reduce` labels each idle gap by a scan of the host events,
    and a step of this model makes tens of thousands of gaps and a hundred
    thousand host operations; the busy time, the window and the kernel
    totals do not read the host's events."""
    from bench import trace

    ranges = (trace.WINDOW,) + SPANS
    return [e for e in events if _kernel(e) or (not e["device"] and e["name"] in ranges)
            or (_runtime_call(e) and "Launch" not in e["name"])]


# --------------------------------------------------------------------------- a run
def run(h) -> dict:
    """One run of an LM training cell (module docstring).  `h` is the
    harness (`bench/run.py`)."""
    cell = Cell(h.config, h.traffic, h.seed, h.device)
    cell.prepare()
    h.sync()
    tokens_a_step = cell.traffic["batch_size"] * cell.traffic["seq_len"]
    meter = h.energy_meter()
    steps, rows = 0, 0.0
    t0 = time.perf_counter()
    meter.start()
    while True:
        read = cell.run(cell.window)
        steps += cell.window
        rows += read["moe_rows_held"] * cell.window
        t1 = time.perf_counter()
        if t1 - t0 >= h.seconds:
            break
    joules = meter.stop()
    samples = steps * tokens_a_step
    out = {"window_start": t0, "timesteps": steps, "seconds": t1 - t0, "attempted": steps, "failed": 0,
           "end_to_end": {"train_ips": samples / (t1 - t0)}, "energy_source": meter.source,
           "last_window": read,
           "setup_phases": {k: round(v - h.started, 3) for k, v in {**h.phases, **cell.phases}.items()}}
    if joules:
        out["end_to_end"]["train_samples_per_j"] = samples / joules
        out["joules"] = joules
    if h.trace:
        from bench import lm_counts, trace

        traced = cell.traffic["trace_timesteps"]
        events = trace.capture(lambda: cell.run(traced))
        out["trace"] = dict(trace.reduce(for_reduce(events)), timesteps=traced)
        out["layer_inputs"] = {
            "lm_span_s": {k: v / traced for k, v in span_device_s(events).items()},
            "lm_counts": lm_counts.step_counts(cell.config, cell.traffic, rows / steps),
            "lm_steps_per_s": steps / (t1 - t0)}
        del events
    out["memory_peak_bytes"] = h.memory_peak()
    snaps = cell.checked_steps()
    cell.close()
    t_check = time.perf_counter()
    out["readings"] = check(h.reference, h.config, h.traffic, h.seed, snaps, h.device)
    out["check_s"] = time.perf_counter() - t_check
    return out


__all__ = ["Cell", "run", "check", "stand_in", "effective", "program_config", "span_device_s", "for_reduce",
           "to_reference"]
