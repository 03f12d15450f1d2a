"""Saturation-collapse mitigation study (counterpart of
``qmann_tpu/bench/scatt_study.py``; qa1, mode 2, Q5.2).

Quantized training can converge and then collapse when attention scores
pin at the Q-format bound.  Each mitigation of ``MITIGATIONS`` (the
reference's EN_SC_ATT, L2 lambda and EN_COSINE_SIM, and the opt-in score
shift and clip) trains the full epoch budget with early stopping off, and
its row reports the BEST-model test error against the FINAL-model test
error: a large gap is the collapse signature.  Rows go to
out-dir/summary.json, rewritten after every run; --resume skips the
(mitigation, seed) pairs already there.  Adds the port's --data-path,
--raw-data-path and --device.

    python -m qmann_tpu_torch.bench.scatt_study --out-dir runs/scatt_study
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

MITIGATIONS = [
    ("baseline", dict()),
    ("sc_att", dict(en_sc_att=True)),
    ("wd_1e-3", dict(lambda_=0.001)),
    ("wd_1e-2", dict(lambda_=0.01)),
    ("sc_att+wd_1e-3", dict(en_sc_att=True, lambda_=0.001)),
    # EN_COSINE_SIM (define.h:200) bounds scores to [-1, 1]: they cannot
    # saturate the format
    ("cosine_sim", dict(en_cosine_sim=True)),
    # opt-in, not reference knobs (ops/qlinear.qscore score_mod)
    ("att_shift", dict(en_att_shift=True)),
    ("att_clip", dict(en_att_clip=True)),
]


def build_parser() -> argparse.ArgumentParser:
    from qmann_tpu_torch.bench.sweep import add_io_flags
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.scatt_study")
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--resume", action="store_true")
    add_io_flags(p, "runs/scatt_study")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from qmann_tpu_torch.bench.sweep import write_summary
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.train import eval_split, train_task

    dev = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, "summary.json")
    rows = []
    if args.resume and os.path.exists(path):
        with open(path) as f:
            rows = json.load(f)
    done = {(r["mitigation"], r["seed"]) for r in rows}

    base = QmannConfig(iwl=args.iwl, num_itr=args.epochs,
                       en_save_best_model=True,
                       # early stopping off: the post-collapse tail is the
                       # measurement
                       count_early_stopping=10**9, verbose=False,
                       data_path=args.data_path,
                       raw_data_path=args.raw_data_path)
    data = load_task_native(base.task_name(args.task), base.data_path,
                            raw_path=base.raw_data_path)
    for name, overrides in MITIGATIONS:
        for seed in range(args.seeds):
            if (name, seed) in done:
                continue
            cfg = base.replace(seed=seed, **overrides)
            t0 = time.time()
            res = train_task(cfg, data, device=dev)
            _, err_final, _ = eval_split(res.params, data.test, cfg,
                                         device=dev)
            best_epoch = min(range(len(res.history)),
                             key=lambda i: (res.history[i].err_valid,
                                            res.history[i].cost_valid))
            row = {
                "mitigation": name, "seed": seed,
                "err_test_best": res.err_test,
                "err_test_final": err_final,
                "collapse_gap": err_final - res.err_test,
                "best_epoch": best_epoch,
                "err_valid_final": res.history[-1].err_valid,
                "wallclock": time.time() - t0,
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            write_summary(args.out_dir, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
