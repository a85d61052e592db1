"""Readings that the limits of `correct` are set from (not part of a run).

    python3 bench/calibrate.py --workloads A,B --seeds 12 --first-seed N [--out FILE]

For each cell and seed, in one process on the card: the cell's set-up as a
run makes it, the three checked timesteps, and the readings of

* the program against the plain reference (the lower readings: the
  largest over the seeds bounds what a sound run reads);
* the control: the reference in the next precision below the
  configuration's, put in the program's place (it has to read above the
  limit);
* each fault a training cell can have, planted in the reference put in
  the program's place: the update returning its state unchanged, half of
  the batch left out (the mean over the rest), a reward altered where
  the env produces it.

One JSON line a cell and seed; the last line sums each number up:
lower = max over the program's seeds, control = min over the control's,
and each fault's min.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workloads", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, default=3_000_000_001)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.run import cell_files, load_module, read_json

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = read_json(ROOT / "BENCHMARK.json")
    lines = []
    for workload in args.workloads.split(","):
        files = cell_files(ROOT, bench, workload)
        ref = load_module(files["reference"], "calib_reference")
        drv = load_module(files["driver"], "calib_driver")
        config, traffic = files["config"], files["traffic"]
        for i in range(args.seeds):
            seed = args.first_seed + 7919 * i
            t0 = time.perf_counter()
            cell = drv.Cell(config, traffic, seed, "cuda")
            cell.prepare(ref)
            snaps = cell.checked_steps(traffic["checked_steps"])
            cell.close()
            row = {"workload": workload, "seed": seed,
                   "program": drv.check(ref, config, traffic, seed, snaps, "cuda"),
                   "control": drv.check(ref, config, traffic, seed,
                                        drv.stand_in(ref, config, traffic, seed, snaps, "cuda", lower=True), "cuda")}
            for fault in ref.FAULTS:
                row[fault] = drv.check(ref, config, traffic, seed,
                                       drv.stand_in(ref, config, traffic, seed, snaps, "cuda", fault=fault), "cuda")
            row["seconds"] = time.perf_counter() - t0
            print(json.dumps(row), flush=True)
            lines.append(row)
    summary = {}
    for workload in args.workloads.split(","):
        rows = [r for r in lines if r["workload"] == workload]
        names = rows[0]["program"].keys()
        summary[workload] = {name: {"lower": max(r["program"][name] for r in rows),
                                    **{k: min(r[k][name] for r in rows) for k in ("control", *ref.FAULTS)}}
                             for name in names}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text("\n".join(json.dumps(r) for r in lines) + "\n"
                                          + json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
