#!/usr/bin/env python3
"""Time one tree's kernels with its own `chip_smoke.py` `times` phase, for an
A/B comparison of two trees on one card.

    python3 tools/ab_times.py TREE [--label NAME] [--smoke DIR]

TREE is a checkout of the repository (for example the parent commit,
unpacked with `git archive` into a directory `.gitignore` lists).  The
script imports TREE's `src/` and the `chip_smoke.py` of DIR (TREE's own by
default), builds TREE's kernels into TREE/build/kernels, runs the `device`
and `times` phases, and prints one JSON line with the label and every
`times` row.  With `--smoke .` an older tree is timed at the current
script's rows, so rows added since have an earlier time too.  Run the two
trees in turns in one call on one card (parent, change, change, parent)
and compare rows of the same kernel, shape, batch and phase.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", type=pathlib.Path)
    ap.add_argument("--label", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", type=pathlib.Path, default=None, help="directory of the chip_smoke.py to time with")
    args = ap.parse_args(argv)
    tree = args.tree.resolve()
    sys.path[:0] = [str((args.smoke or tree).resolve()), str(tree / "src")]
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("ab_times: no CUDA device available", file=sys.stderr)
        return 2
    dev_info = chip_smoke.phase_device()
    chip_smoke.phase_build()
    rows = chip_smoke.phase_times(torch.Generator().manual_seed(args.seed), torch.device("cuda"), dev_info)
    print(json.dumps({"ab_times": args.label or str(args.tree), "card": dev_info["nvidia_smi"],
                      "rows": list(rows.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
