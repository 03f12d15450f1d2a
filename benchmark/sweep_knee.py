"""The sweep that found the engine cell's rate: one engine, set up once,
offered one open-loop Poisson window at each rate in turn.  For each rate
it prints the latency percentiles, the median of each quarter of the
window's requests (a backlog that grows shows as rising quarters) and the
sender's lag.  The knee is the highest rate with no growing backlog; the
cell's traffic file takes four fifths of it.

    python3 benchmark/sweep_knee.py --workload engine.m2.open
        --rates 1000,2000,4000 [--seconds 6] [--seed 1]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benchmark import common, harness  # noqa: E402
from benchmark.jobs.engine_open import percentile  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/sweep_knee.py")
    p.add_argument("--workload", default="engine.m2.open")
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    harness.fixed_caches(common.ROOT)
    if not torch.cuda.is_available():
        print("sweep_knee: no CUDA card", file=sys.stderr)
        return 2
    cell = common.find_cell(common.load_spec(), args.workload)
    job = harness.load_job(cell["traffic"]["job"])(
        cell, args.seed, torch.device("cuda:0"))
    job.setup()
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            job.rate = rate
            res = job.window(args.seconds)
            lat = res["work"]["latencies_s"]
            q = max(1, len(lat) // 4)
            quarters = [1e3 * percentile(lat[i * q:(i + 1) * q], 50)
                        for i in range(4)]
            w = res["work"]
            print(json.dumps({
                "rate": rate, "requests": len(lat), "failed": res["failed"],
                "p50_ms": 1e3 * percentile(lat, 50),
                "p95_ms": 1e3 * percentile(lat, 95),
                "p99_ms": 1e3 * percentile(lat, 99),
                "quarter_p50_ms": quarters,
                "missing": sum(1 for x in lat if math.isinf(x)),
                "waves": w["waves"],
                "requests_per_wave": w["requests"] / max(w["waves"], 1),
                "vectorize_ms_per_wave": 1e3 * w["vectorize_s"]
                / max(w["waves"], 1),
                "infer_ms_per_wave": 1e3 * w["infer_s"] / max(w["waves"], 1),
                "lag_p95_ms": 1e3 * w["lag_p95_s"]}), flush=True)
    finally:
        job.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
