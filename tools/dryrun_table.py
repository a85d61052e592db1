#!/usr/bin/env python3
"""Tabulate the production dry run's records (`launch.dryrun`'s
`<arch>_<shape>_<mesh>.json`, one per cell and mesh) as a markdown table,
one row per (arch × shape) cell, each entry "256-rank mesh; 512-rank
mesh": status, per-rank peak GB, whether it fits the card
(`launch.dryrun.HBM_BYTES`, the threshold `chip_smoke.py` uses too),
per-rank argument GB, flops per rank, collective GB by kind and run
seconds.

    python3 tools/dryrun_table.py DIR

DIR holds the records (the CLI writes them to `results/dryrun/`).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch.dryrun import HBM_BYTES  # noqa: E402

KINDS = ("all_gather", "all_reduce", "reduce_scatter", "all_to_all")
MESHES = ("pod16x16", "pod2x16x16")
ARCHS = ("gemma3-1b", "internlm2-1.8b", "qwen2-0.5b", "deepseek-7b", "rwkv6-1.6b", "dbrx-132b",
         "moonshot-v1-16b-a3b", "phi-3-vision-4.2b", "hubert-xlarge", "recurrentgemma-2b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def _pair(recs: dict, fmt) -> str:
    return "; ".join(fmt(recs[m]) if m in recs and recs[m].get("status") == "ok" else "—" for m in MESHES)


def rows(records: list) -> list[str]:
    cells: dict = {}
    for r in records:
        cells.setdefault((r["arch"], r["shape"]), {})[r["mesh"]] = r
    out = ["| arch | shape | status | peak GB / rank | fits | args GB / rank | flops / rank | "
           + " | ".join(f"{k} GB" for k in KINDS) + " | run s |",
           "|" + "---|" * (8 + len(KINDS))]
    order = lambda key: (ARCHS.index(key[0]) if key[0] in ARCHS else len(ARCHS),  # noqa: E731
                         SHAPES.index(key[1]) if key[1] in SHAPES else len(SHAPES))
    for (arch, shape), recs in sorted(cells.items(), key=lambda kv: order(kv[0])):
        status = "; ".join(recs[m]["status"] if m in recs else "—" for m in MESHES)
        if all(recs.get(m, {}).get("status") != "ok" for m in MESHES):
            why = next((r.get("skip_reason") or r.get("error") or "" for r in recs.values()), "").replace("\n", " ")
            out.append(f"| {arch} | {shape} | {status}: {why[:70]} |" + " |" * (5 + len(KINDS)))
            continue
        peak = lambda r: f"{r['memory']['peak_bytes'] / 1e9:.2f}"  # noqa: E731
        fits = lambda r: "yes" if r["memory"]["peak_bytes"] <= HBM_BYTES else "no"  # noqa: E731
        out.append(f"| {arch} | {shape} | {status} | {_pair(recs, peak)} | {_pair(recs, fits)} | "
                   f"{_pair(recs, lambda r: format(r['memory']['argument_bytes'] / 1e9, '.2f'))} | "
                   f"{_pair(recs, lambda r: format(r['flops_per_rank'], '.3g'))} | "
                   + " | ".join(_pair(recs, lambda r, k=k: format(r['collective_bytes'].get(k, 0.0) / 1e9, '.3g'))
                                for k in KINDS)
                   + f" | {_pair(recs, lambda r: format(r['run_s'], '.1f'))} |")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", type=pathlib.Path)
    args = ap.parse_args(argv)
    records = [json.loads(p.read_text()) for p in sorted(args.dir.glob("*.json"))]
    print("\n".join(rows([r for r in records if "arch" in r and "mesh" in r])))


if __name__ == "__main__":
    main()
