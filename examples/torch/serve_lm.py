"""Continuously-batched LM serving: concurrent clients with staggered
arrivals through `serve/lm.LMEngine`, traced end to end, on the
PyTorch/CUDA port.

Eight clients submit prompts of different lengths at different times; the
engine admits each into a free decode lane as soon as one opens (mid-decode
— nobody waits for the current batch to finish), decodes every active lane
in ONE batched step, and evicts sequences the moment they hit their
max_new.  The run writes a Chrome trace (open it at
https://ui.perfetto.dev) whose spans show the lifecycle:

    serve_lm.batcher.*       queue depth / wait (the shared runtime queue)
    serve_lm.admit           per-sequence prefill + lane insertion
    serve_lm.launch          one batched decode step over all active lanes
    serve_lm.block_until_ready   device-bound portion of the step
    serve_lm.reply           futures resolving on eviction
    serve_lm.request         whole-request wall time (TTFT + decode)

    PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]

The port of `examples/serve_lm.py`: the same model (qwen2-0.5b's smoke
config, random weights from seed 0), clients and printed lines.  The trace
goes to `results/serve_lm_trace.jsonl` (the reference writes
`examples/serve_lm_trace.jsonl`), or under `out_dir=`.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import threading
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import Observability
from repro_torch.serve.lm import LMEngine

RESULTS = pathlib.Path(__file__).resolve().parents[2] / "results"


def main(device=None, *, n_clients=8, max_new=12, out_dir=None):
    """Serve and print as the reference does; returns the engine's stats,
    the prompts, each client's sequence, the trace's path and the metrics
    registry's snapshot (the batcher's queue series among them)."""
    dev = resolve_device(device)
    out = pathlib.Path(out_dir) if out_dir is not None else RESULTS
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "serve_lm_trace.jsonl"
    cfg = registry.get_smoke("qwen2_0_5b")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    rng = np.random.default_rng(0)

    obs = Observability.tracing(trace_path=str(trace))
    eng = LMEngine(params, cfg, lanes=4, max_seq=64, obs=obs, device=dev)

    # staggered clients: prompt lengths 5..19, arrivals 3 ms apart — more
    # clients than lanes, so later arrivals admit mid-decode as lanes free
    prompts = [rng.integers(0, cfg.vocab_size, size=5 + 2 * k).astype(np.int32) for k in range(n_clients)]

    # warm the per-length prefills + the decode step outside the measured
    # run (first calls would otherwise dominate the trace)
    eng.generate_batch(prompts, [1] * len(prompts))
    eng.generate_batch(prompts[:4], [2] * 4)
    eng.reset_stats()

    results = [None] * len(prompts)

    def client(k):
        time.sleep(0.003 * k)
        t0 = time.perf_counter()
        results[k] = eng.submit(prompts[k], max_new=max_new).result(timeout=120.0)
        dt = (time.perf_counter() - t0) * 1e3
        print(f"  client {k}: prompt {len(prompts[k]):2d} tokens -> "
              f"{results[k].shape[0]} total in {dt:6.1f} ms")

    with eng:   # start(); __exit__ stops, drains, and flushes the trace
        threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        st = eng.stats()

    print(f"\n{st['requests']} requests, {st['tokens']} tokens, "
          f"{st['decode_steps']} decode steps "
          f"(sequential would need {max_new * len(prompts) - len(prompts)})")
    print(f"decode occupancy {st['decode_occupancy']:.2f} over "
          f"{st['lanes']} lanes, ttft p50 {st['ttft_p50_ms']:.1f} ms, "
          f"request p50 {st['p50_ms']:.1f} ms")
    print(f"trace: {trace} (load in https://ui.perfetto.dev)")
    return {"stats": st, "prompts": prompts, "results": results, "trace": trace,
            "registry": obs.registry.snapshot()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
