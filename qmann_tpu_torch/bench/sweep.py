"""Sweep harness (counterpart of ``qmann_tpu/bench/sweep.py``): the
reference's shell sweeps as one process, one ``train_task`` per (iwl,
task, loop).

The reference's run.sh is 10 loops x tasks 1-20 at iwl 5, sweep_fixed.sh
iwl in {0, 1} x tasks 1-20 x 2 loops, merge_results.sh concatenates their
result CSVs.  Here a sweep is one process with the same flags and defaults
as the JAX tool, plus ``--device`` (default ``cuda``; raises without a
card unless ``--device cpu``).  It writes out-dir/summary.json (one row per
(iwl, task), rewritten after every task, so an interrupted sweep leaves a
loadable summary; ``--resume`` continues one) and the result CSVs per iwl
(``utils/reporting.py``).  The family trainer's version is
``bench/megasweep.py``.

    python -m qmann_tpu_torch.bench.sweep --tasks 1-20 --iwl 5 --loops 10
    python -m qmann_tpu_torch.bench.sweep --tasks 1-20 --iwl 0,1 --loops 2
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse_range(spec: str):
    """'1-3,7' -> [1, 2, 3, 7]."""
    out = []
    for part in spec.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        else:
            out.append(int(part))
    return out


def write_summary(out_dir: str, summary) -> None:
    """summary.json, replaced atomically."""
    tmp = os.path.join(out_dir, "summary.json.tmp")
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2)
    os.replace(tmp, os.path.join(out_dir, "summary.json"))


def add_model_flags(p: argparse.ArgumentParser) -> None:
    """The model and data flags the sweep and the megasweep share."""
    p.add_argument("--tasks", default="1-20")
    p.add_argument("--iwl", default="5", help="comma list, e.g. '0,1' or '5'")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--attention-mode", type=int, default=2)
    p.add_argument("--no-fixed-point", action="store_true",
                   help="float control run (EN_FIXED_POINT undef)")
    p.add_argument("--bw-wl", type=int, default=8,
                   help="total word length; 4 = the INT4 study")
    p.add_argument("--binary-mode", action="store_true",
                   help="BINARY_MODE: iwl = frac = 0 everywhere")
    p.add_argument("--sc-att", action="store_true",
                   help="EN_SC_ATT learnable attention scale")
    p.add_argument("--weight-decay", type=float, default=0.0,
                   help="L2 lambda")
    p.add_argument("--save-best-model", action="store_true")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--max-test-samples", type=int, default=None)


def add_io_flags(p: argparse.ArgumentParser, out_dir: str) -> None:
    p.add_argument("--out-dir", default=out_dir)
    p.add_argument("--data-path",
                   default="/root/reference/MemN2N/dataset/en_10k_parsed")
    p.add_argument("--raw-data-path",
                   default="/root/reference/MemN2N/dataset/"
                           "tasks_1-20_v1-2/en-10k")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")


def config_for(args, iwl: int, **kw):
    """The sweep's QmannConfig at one iwl (verbose off unless kw says)."""
    from qmann_tpu_torch.config import QmannConfig
    return QmannConfig(iwl=iwl, num_itr=args.epochs,
                       attention_mode=args.attention_mode,
                       en_fixed_point=not args.no_fixed_point,
                       bw_wl=args.bw_wl, binary_mode=args.binary_mode,
                       en_sc_att=args.sc_att, lambda_=args.weight_decay,
                       en_save_best_model=args.save_best_model,
                       data_path=args.data_path,
                       raw_data_path=args.raw_data_path,
                       **{"verbose": False, **kw})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.sweep")
    add_model_flags(p)
    p.add_argument("--loops", type=int, default=10)
    p.add_argument("--seed-base", type=int, default=0,
                   help="loop i trains with seed = seed_base + i")
    p.add_argument("--resume", action="store_true",
                   help="skip (iwl, task) rows already in out-dir/summary.json"
                        " with >= --loops recorded loops")
    p.add_argument("--uniform-shapes", action="store_true",
                   help="pad every task to dict=64 / 50 memory rows")
    add_io_flags(p, "sweep_results")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.train import train_task
    from qmann_tpu_torch.utils.reporting import (
        TaskLoopResult, TaskResult, write_run_outputs,
    )

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    summary = []
    existing = {}
    if args.resume:
        path = os.path.join(args.out_dir, "summary.json")
        if os.path.exists(path):
            with open(path) as f:
                summary = json.load(f)
            for row in summary:
                # a row without its per-loop errs holds one loop (seed_base)
                row.setdefault("errs", [row["err_test_avg"]])
                existing[(row["iwl"], row["task"])] = row
    for iwl in parse_range(args.iwl):
        cfg = config_for(args, iwl)
        results = []
        for task_index in parse_range(args.tasks):
            prev = existing.get((iwl, task_index))
            start_loop = len(prev["errs"]) if prev else 0
            if start_loop >= args.loops:
                continue
            t0 = time.time()
            pad = (64, 50) if args.uniform_shapes else (0, 0)
            data = load_task_native(
                cfg.task_name(task_index), cfg.data_path,
                raw_path=cfg.raw_data_path, limit_train=args.max_samples,
                limit_test=args.max_test_samples, pad_dict=pad[0],
                pad_line=pad[1])
            loops = []
            for loop in range(start_loop, args.loops):
                res = train_task(cfg.replace(seed=args.seed_base + loop),
                                 data, device=dev)
                loops.append(TaskLoopResult(
                    res.time_train,
                    res.history[-1].err_train if res.history else 1.0,
                    res.time_test, res.err_test))
            errs = (prev["errs"] if prev else []) + [lp.err_test
                                                     for lp in loops]
            row = {
                "iwl": iwl, "task": task_index,
                "err_test_avg": sum(errs) / len(errs),
                "err_test_min": min(errs), "err_test_max": max(errs),
                "errs": errs,
                "wallclock": (time.time() - t0
                              + (prev["wallclock"] if prev else 0.0)),
            }
            if prev:
                summary[summary.index(prev)] = row
                existing[(iwl, task_index)] = row
            else:
                summary.append(row)
            print(json.dumps(row), flush=True)
            results.append(TaskResult(task_index, loops))
            write_summary(args.out_dir, summary)
        if results:
            write_run_outputs(os.path.join(args.out_dir, f"iwl{iwl}"), cfg,
                              results)
    write_summary(args.out_dir, summary)
    if summary:
        mean_err = sum(r["err_test_avg"] for r in summary) / len(summary)
        print(json.dumps({"sweep_mean_err_test": mean_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
