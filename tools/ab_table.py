#!/usr/bin/env python3
"""Tabulate the `times` rows of several `tools/ab_times.py` runs side by side.

    python3 tools/ab_table.py LOG [LOG ...] [--kernel NAME ...]

Each LOG holds the output of one `ab_times.py` run (its JSON line with
"ab_times" as key).  Prints one Markdown row per (kernel, shape, batch,
phase): each run's `ms` in µs under its label in the order given, then the
row's `bound_ms`, `plain_ms` and `library_ms` (of the last run) in µs.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def load(path: pathlib.Path) -> tuple[str, dict]:
    for line in path.read_text().splitlines():
        if line.startswith("{") and '"ab_times"' in line:
            run = json.loads(line)
            return run["ab_times"], {(r["kernel"], r["shape"], r["batch"], r["phase"]): r for r in run["rows"]}
    raise SystemExit(f"{path}: no ab_times line")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("logs", nargs="+", type=pathlib.Path)
    ap.add_argument("--kernel", action="append", default=None, help="only these kernels")
    args = ap.parse_args(argv)
    runs = [load(p) for p in args.logs]
    us = lambda v: "—" if v is None else f"{v * 1e3:.1f}"  # noqa: E731
    print("| kernel | shape | B | phase | " + " | ".join(label for label, _ in runs) + " | bound | plain | library |")
    print("|---" * (7 + len(runs)) + "|")
    for key, last in runs[-1][1].items():
        if args.kernel and key[0] not in args.kernel:
            continue
        cells = [us(rows[key]["ms"]) if key in rows else "—" for _, rows in runs]
        print(f"| {key[0]} | {key[1]} | {key[2]} | {key[3]} | " + " | ".join(cells)
              + f" | {us(last['bound_ms'])} | {us(last['plain_ms'])} | {us(last['library_ms'])} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
