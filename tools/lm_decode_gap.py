#!/usr/bin/env python3
"""Decode against the full forward, the port beside the JAX reference, on
the CPU, at an arch's full width and a cut depth.

    PYTHONPATH=src python3 tools/lm_decode_gap.py ARCH [--layers N] [--tokens S] [--seed K]

Both packages serve the same weights (the reference's `init_params` from
the seed, carried across by `convert.lm_params_from_numpy`; the port's
bf16 serving tree) in the config's own compute dtype.  For one prompt of
S tokens each side runs its full forward and S one-token decode steps;
the script prints one JSON line with each side's max |decode − forward|
and logit scale, the reference's contract 0.05·scale + 0.05
(`tests/test_archs.py:77-78`), and the max |Δ| between the two sides'
forwards.  It tells whether a gap `chip_smoke.py`'s `lm` phase measures
on the card is the reference's own (bf16 through a deep recurrence) or
the port's.  Memory: the reference's float32 tree and the port's copies
(≈ 3 × 4 bytes a param); keep the depth cut.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from repro.configs import registry as rreg
    from repro.models import transformer as RT
    from repro_torch import convert
    from repro_torch.configs import registry as preg
    from repro_torch.models import transformer as PT

    rc = dataclasses.replace(rreg.get(args.arch), n_layers=args.layers)
    pc = dataclasses.replace(preg.get(args.arch), n_layers=args.layers)
    rp = RT.init_params(jax.random.key(args.seed), rc)
    pp = PT.serving_params(convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu"), pc)
    s = args.tokens
    toks = np.random.default_rng(args.seed + 1).integers(0, rc.vocab_size, (1, s)).astype(np.int32)

    full, _ = RT.forward(rp, {"tokens": jnp.asarray(toks)}, rc)
    cache = RT.init_cache(rc, 1, s)
    step = jax.jit(lambda p, t, c, i: RT.decode_step(p, t, c, i, rc))
    outs = []
    for i in range(s):
        lg, cache = step(rp, jnp.asarray(toks[:, i:i + 1]), cache, jnp.int32(i))
        outs.append(np.asarray(lg.astype(jnp.float32)))
    ref_full, ref_dec = np.asarray(full.astype(jnp.float32)), np.concatenate(outs, 1)

    with torch.inference_mode():
        full, _ = PT.forward(pp, {"tokens": torch.from_numpy(toks)}, pc)
        pcache = PT.init_cache(pc, 1, s, device="cpu")
        dec = torch.cat([PT.decode_step(pp, torch.from_numpy(toks[:, i:i + 1]), pcache, i, pc)[0]
                         for i in range(s)], 1)
    port_full, port_dec = full.float().numpy(), dec.float().numpy()

    def side(f, d):
        scale = float(np.abs(f).max())
        return {"max_abs": float(np.abs(d - f).max()), "scale": scale, "limit": 0.05 * scale + 0.05}

    print(json.dumps({"arch": args.arch, "layers": args.layers, "tokens": s, "seed": args.seed,
                      "compute_dtype": rc.dtype, "reference": side(ref_full, ref_dec),
                      "port": side(port_full, port_dec),
                      "forward_port_vs_reference": float(np.abs(port_full - ref_full).max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
