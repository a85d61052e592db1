"""Serve a small model with batched requests through the KV-cache decode
engine (the serve_step the decode dry-run cells run), on the PyTorch/CUDA
port.

    PYTHONPATH=src python examples/torch/serve_batched.py [--device cpu]

The port of `examples/serve_batched.py`: the same model (qwen2-0.5b's
smoke config, random weights from seed 0), sizes and printed lines.  The
LM path runs in plain PyTorch (the reference computes it in jnp, outside
any Pallas kernel); each step's latency is read after a device sync.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

import time

import torch

from repro_torch.configs import registry
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.serve.engine import generate, make_serve_step


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(device=None, *, batch=8, prompt_len=12, max_new=16, cache_len=64, steps=20):
    """Generate and time as the reference does; returns the generated
    tokens (batch, prompt_len + max_new) and the serve_step ms."""
    dev = resolve_device(device)
    cfg = registry.get_smoke("qwen2_0_5b")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)

    with torch.inference_mode():
        # batched requests: 8 prompts decoded together
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                                generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        t0 = time.perf_counter()
        out = generate(params, cfg, prompts, max_new=max_new,
                       generator=torch.Generator(device=dev).manual_seed(2), temperature=0.8)
        _sync(dev)
        dt = time.perf_counter() - t0
        print(f"generated {out.shape[0]}x{out.shape[1]} tokens in {dt:.2f}s "
              f"({batch * max_new / dt:.1f} tok/s decode)")
        print("first sequence:", out[0].tolist())

        # one-step latency of serve_step (what decode cells measure)
        serving = T.serving_params(params, cfg)
        cache = T.init_cache(cfg, batch, cache_len, device=dev)
        step = make_serve_step(cfg)
        tok = prompts[:, :1].to(torch.int32)
        logits, cache = step(serving, tok, cache, 0)  # warm
        _sync(dev)
        t0 = time.perf_counter()
        for i in range(1, steps):
            logits, cache = step(serving, tok, cache, i)
        _sync(dev)
        ms = (time.perf_counter() - t0) / (steps - 1) * 1e3
    print(f"serve_step latency: {ms:.2f} ms (batch {batch}, cache {cache_len})")
    return {"tokens": out.cpu(), "prompts": prompts.cpu(), "serve_step_ms": ms, "logits": logits.float().cpu()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    main(ap.parse_args().device)
