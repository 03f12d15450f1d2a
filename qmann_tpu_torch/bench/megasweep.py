"""The family sweep (counterpart of ``qmann_tpu/bench/megasweep.py``): the
reference's multi-run protocols as one stacked family per configuration
(``train/multi.py::train_tasks_multi``).

    # run.sh: 10 seeds x 20 tasks at iwl 5
    python -m qmann_tpu_torch.bench.megasweep --tasks 1-20 --seeds 0-9 \\
        --iwl 5 --save-best-model --out-dir runs/mega_iwl5
    # sweep_fixed.sh: mode 3, iwl 0 and 1, 2 seeds
    python -m qmann_tpu_torch.bench.megasweep --tasks 1-20 --seeds 0,1 \\
        --iwl 0,1 --attention-mode 3

The flags and defaults are the JAX tool's, plus ``--device`` (default
``cuda``; raises without a card unless ``--device cpu``).  The default
route is JAX's: the integer fast path on, no ``use_pallas``
(``--no-fast-path`` is the A/B).  Outputs per out-dir:
  summary.json   one row per (iwl, task) with per-seed errs: the schema
                 bench/sweep.py writes, so bench/compare.py reads both
  history.npz    per-epoch train/valid curves of every run
  meta.json      the protocol and its wall-clock times
  iwl<k>/        result.csv and result_all.csv (``utils/reporting.py``;
                 per-run times are the family's, divided by R)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from qmann_tpu_torch.bench.sweep import (add_io_flags, add_model_flags,
                                         config_for, parse_range,
                                         write_summary)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.megasweep")
    add_model_flags(p)
    p.add_argument("--seeds", default="0-9",
                   help="range/list of per-run seeds, e.g. '0-9' (run.sh's"
                        " 10 loops) or '0,1' (sweep_fixed.sh's 2 loops)")
    p.add_argument("--att-shift", action="store_true",
                   help="opt-in saturation mitigation (qscore score_mod)")
    p.add_argument("--eval-chunk", type=int, default=128)
    p.add_argument("--keep-fast-path", action="store_true",
                   help="(the default) keep the integer fast path")
    p.add_argument("--no-fast-path", action="store_true",
                   help="A/B: the lattice for every embedding")
    p.add_argument("--pad-dict", type=int, default=64)
    p.add_argument("--pad-line", type=int, default=50)
    add_io_flags(p, "megasweep_results")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.train.multi import train_tasks_multi
    from qmann_tpu_torch.utils.reporting import (
        TaskLoopResult, TaskResult, write_run_outputs,
    )

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    seeds = parse_range(args.seeds)
    task_list = parse_range(args.tasks)
    summary = []
    meta = {"seeds": seeds, "tasks": task_list, "epochs": args.epochs,
            "attention_mode": args.attention_mode,
            "fixed_point": not args.no_fixed_point, "bw_wl": args.bw_wl,
            "binary_mode": args.binary_mode, "sc_att": args.sc_att,
            "att_shift": args.att_shift,
            "weight_decay": args.weight_decay, "stages": []}
    hist_arrays = {}
    for iwl in parse_range(args.iwl):
        cfg = config_for(args, iwl, en_att_shift=args.att_shift,
                         verbose=True)
        tasks = {ti: load_task_native(
            cfg.task_name(ti), cfg.data_path, raw_path=cfg.raw_data_path,
            limit_train=args.max_samples, limit_test=args.max_test_samples,
            pad_dict=args.pad_dict, pad_line=args.pad_line)
            for ti in task_list}
        t0 = time.time()
        res = train_tasks_multi(
            cfg, tasks, seeds, eval_chunk=args.eval_chunk,
            integer_fast_path=False if args.no_fast_path else None,
            device=dev)
        wall = time.time() - t0
        n_runs = len(res.err_test)
        meta["stages"].append({"iwl": iwl, "wallclock": wall,
                               "runs": n_runs, "time_train": res.time_train,
                               "time_test": res.time_test})
        task_results = []
        for ti in task_list:
            sel = [i for i, t in enumerate(res.task_indices) if t == ti]
            errs = [float(res.err_test[i]) for i in sel]
            # the family trains as one program: per-run times are its
            # share
            task_results.append(TaskResult(ti, [
                TaskLoopResult(
                    res.time_train / n_runs,
                    float(res.history[-1]["err_train"][i])
                    if res.history else 1.0,
                    res.time_test / n_runs, float(res.err_test[i]))
                for i in sel]))
            row = {
                "iwl": iwl, "task": ti,
                "err_test_avg": sum(errs) / len(errs),
                "err_test_min": min(errs), "err_test_max": max(errs),
                "errs": errs,
                "seeds": [res.seeds[i] for i in sel],
                "err_valid_best": [float(res.err_valid_best[i])
                                   for i in sel],
                "ind_best": [int(res.ind_best[i]) for i in sel],
                "wallclock": wall / len(task_list),
            }
            summary.append(row)
            print(json.dumps(row), flush=True)
        write_summary(args.out_dir, summary)
        write_run_outputs(os.path.join(args.out_dir, f"iwl{iwl}"), cfg,
                          task_results)
        for k in ("cost_train", "err_train", "cost_valid", "err_valid"):
            hist_arrays[f"iwl{iwl}_{k}"] = np.stack(
                [h[k] for h in res.history])                  # [E, R]
        hist_arrays[f"iwl{iwl}_task"] = np.array(res.task_indices)
        hist_arrays[f"iwl{iwl}_seed"] = np.array(res.seeds)
        np.savez_compressed(os.path.join(args.out_dir, "history.npz"),
                            **hist_arrays)
        with open(os.path.join(args.out_dir, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
    if summary:
        mean_err = sum(r["err_test_avg"] for r in summary) / len(summary)
        print(json.dumps({"sweep_mean_err_test": mean_err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
