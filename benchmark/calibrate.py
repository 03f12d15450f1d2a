"""The readings the check's limits were set from: for each seed, one cell's
program (set-up, a short window at the cell's load, the numbers against
the reference) and, on the same inputs, the control (the reference in
TF32 in the program's place) and, for a training cell, a fault of the
reference (half the batch left out, the mean taken over the rest).  One
JSON line a seed; several seeds share one process, so the card's kernels
are built once.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3
        [--seconds 2] [--controls tf32,half_batch] [--out FILE]
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import common, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--controls", default="tf32")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.fixed_caches(common.ROOT)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    cell = common.find_cell(common.load_spec(), args.workload)
    controls = [c for c in args.controls.split(",") if c]
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        job = harness.load_job(cell["traffic"]["job"])(cell, seed, dev)
        job.setup()
        t1 = time.perf_counter()
        res = job.window(args.seconds)
        job.release()
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed,
                "setup_s": t1 - t0, "failed": res["failed"],
                "metrics": res["metrics"], "program": job.readings()}
        for c in controls:
            line[c] = job.readings(control=c)
        line["check_s"] = time.perf_counter() - t1 - res["elapsed_s"]
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del job
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
