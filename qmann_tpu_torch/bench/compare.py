"""Sweep results side by side (counterpart of ``qmann_tpu/bench/compare.py``;
the analysis half of the reference's merge_results.sh).

    python -m qmann_tpu_torch.bench.compare runs/sweep_m2_iwl0 runs/mega_m3

Reads each directory's summary.json (bench/sweep.py's or
bench/megasweep.py's), prints a per-(iwl, task) markdown table of the mean
test error and the means over the tasks every column covers.  Labels
default to the directory names.  Reads files only: no device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def load_summary(path: str):
    with open(os.path.join(path, "summary.json")) as f:
        rows = json.load(f)
    return {(r["iwl"], r["task"]): r["err_test_avg"] for r in rows}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.compare")
    p.add_argument("dirs", nargs="+", help="sweep output directories")
    p.add_argument("--labels", default=None,
                   help="comma list overriding the column labels")
    args = p.parse_args(argv)

    labels = (args.labels.split(",") if args.labels
              else [os.path.basename(os.path.normpath(d)) for d in args.dirs])
    if len(labels) != len(args.dirs):
        p.error(f"--labels names {len(labels)} columns but "
                f"{len(args.dirs)} directories were given")
    results = [load_summary(d) for d in args.dirs]
    keys = sorted(set().union(*results))
    common = sorted(set(results[0]).intersection(*results[1:]))

    print("| iwl | task | " + " | ".join(labels) + " |")
    print("|---|---|" + "---|" * len(labels))
    for key in keys:
        cells = [f"{r[key]:.3f}" if key in r else "—" for r in results]
        print(f"| {key[0]} | {key[1]} | " + " | ".join(cells) + " |")
    # the means compare only over the tasks every column covers
    means = [f"{sum(r[k] for k in common) / len(common):.4f}" if common
             else "—" for r in results]
    print(f"| | mean (n={len(common)} common) | " + " | ".join(means) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
