"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result as the last line of standard
output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

With ``--trace 0`` the result holds the cell's end-to-end metrics and
``setup_s`` (process start to the window's start); with ``--trace 1`` the
window is a short one (the traffic's ``trace_seconds``) under
``torch.profiler``, and the result holds the cell's per-layer metrics,
each read by ``metrics/<name>.py`` from the trace, the program's counters
and the window's work, with the device's busy and window seconds and a
breakdown.  Either way the check runs once the window has closed, the
memory peak has been read and the program's state is freed: the numbers
compared, each with its limit (``workloads/<name>.json``), are the last
lines of standard error and the result's last key.

No result is printed, and the exit code is not 0, when the card is missing
or the cell asks for more cards than there are, when the program cannot be
imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

from benchmark import common
from benchmark.trace import traced


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fixed_caches(root) -> None:
    """Every compile cache the program or torch may use, at a fixed path
    inside the checkout (the program's own kernels build into
    ``qmann_tpu_torch/_build/``)."""
    base = root / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(base / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(base / "nv_compute")


def load_job(name: str):
    return importlib.import_module(f"benchmark.jobs.{name}").Job


def read_metric(name: str, ctx: dict, root=common.ROOT):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"
    return out.splitlines()[0] if out else "nvidia-smi unavailable"


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: torch.device) -> dict:
    """Set-up, window and check of one cell on ``device``; returns the
    result's fields (the harness's chip check is the caller's)."""
    job = load_job(cell["traffic"]["job"])(cell, seed, device)
    job.setup()
    setup_s = common.process_age_s()
    out = {}
    if trace:
        with traced(device) as box:
            res = job.window(min(seconds, cell["traffic"]["trace_seconds"]))
        tr = box["trace"]
        ctx = {"trace": tr, "work": res["work"]}
        metrics = {}
        for m in cell["per_layer"]:
            value = read_metric(m["name"], ctx, cell["root"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["trace"] = tr
        out["breakdown"] = tr.breakdown()
    else:
        res = job.window(seconds)
        metrics = {m["name"]: {"value": res["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell["end_to_end"] if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    # the process's peak since it started: set-up and window
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    job.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = job.readings()
    limits = cell["cell"]["limits"]
    compared = {k: {"value": readings[k], "limit": limits[k]}
                for k in limits}
    correct = (res["failed"] == 0
               and all(v["value"] <= v["limit"] for v in compared.values()))
    out.update(correct=correct, attempted=res["attempted"],
               failed=res["failed"], metrics=metrics, peak=peak,
               compared=compared, window=res, setup_s=setup_s)
    return out


def main(argv=None) -> int:
    args = parse(argv)
    fixed_caches(common.ROOT)
    spec = common.load_spec()
    cell = common.find_cell(spec, args.workload)
    chips = cell["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); {found} "
              "found", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    banned = common.banned_modules()
    if banned:
        print(f"benchmark: the run loaded {', '.join(banned)}",
              file=sys.stderr)
        return 3
    result = result_line(out, torch.cuda.get_device_name(0), chips,
                         card_line())
    for k, v in out["compared"].items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


def result_line(out: dict, kind: str, chips: int, card: str) -> dict:
    """The result's last line from ``run_cell``'s fields: the keys the
    driver reads, then what the records keep (the card's name and power
    limit, the set-up, the window's length and work), then the numbers
    compared, last."""
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": out["peak"]}
    if "trace" in out:
        dev["busy_s"] = out["trace"].busy_s
        dev["window_s"] = out["trace"].window_s
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": dev}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["card"] = card
    result["setup_s"] = out["setup_s"]
    result["window_s"] = out["window"]["elapsed_s"]
    result["work"] = {k: v for k, v in out["window"]["work"].items()
                      if isinstance(v, (int, float))}
    result["compared"] = out["compared"]
    return result
