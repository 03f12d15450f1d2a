"""Training-collapse diagnosis (counterpart of
``qmann_tpu/bench/diagnose.py``): per-epoch weight and score statistics.

Quantized (mode 2, Q5.2) training on qa1 can converge and then collapse.
Per epoch this prints one JSON record with the JAX tool's keys: the train
and valid errors, the share of the live attention scores of a 256-sample
validation probe pinned at the format's bound, their largest magnitude,
and max|w| of every parameter — to find which tensor leaves its Q-format
range first.  Adds the port's --data-path, --raw-data-path and --device.

    python -m qmann_tpu_torch.bench.diagnose [--epochs 20] [--task 1]
"""
from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    from qmann_tpu_torch.bench.common import add_path_flags
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.diagnose")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--max-samples", type=int, default=None)
    add_path_flags(p)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "versions of the kernels)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.graphs import Graphs
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.numerics import fixed_max_float
    from qmann_tpu_torch.train import eval_split, train_epoch
    from qmann_tpu_torch.train.optim import lr_schedule
    from qmann_tpu_torch.train.trainer import _batched_arrays
    from qmann_tpu_torch.utils.verification import overflow_stats

    dev = resolve_device(args.device)
    cfg = QmannConfig(iwl=args.iwl, num_itr=args.epochs, verbose=False,
                      data_path=args.data_path,
                      raw_data_path=args.raw_data_path)
    data = load_task_native(cfg.task_name(args.task), cfg.data_path,
                            raw_path=cfg.raw_data_path,
                            limit_train=args.max_samples)
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(cfg.seed),
                                device=dev)
    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               _batched_arrays(data.train, cfg.size_batch).items()}

    probe = 256
    pm, pq, pmask = (torch.from_numpy(a[:probe]).to(dev) for a in (
        data.valid.memory, data.valid.question, data.valid.mask))
    fmt = cfg.fmt_att[0]
    # quantized scores clip AT the bound, so count values pinned there
    maxf = float(fixed_max_float(fmt.iwl, fmt.frac))

    graphs = Graphs(dev)
    lr_t = graphs.static("lr", ())
    for itr, lr, rm in lr_schedule(cfg):
        lr_t.fill_(lr)
        params, _, match = train_epoch(params, batches, lr_t, cfg, rm,
                                       graphs=graphs)
        _, err_valid, _ = eval_split(params, data.valid, cfg, device=dev,
                                     graphs=graphs)
        with torch.no_grad():
            out = memn2n.forward(params, pm, pq, pmask, cfg)
        scores = out.scores.cpu().numpy()
        live = scores[np.broadcast_to(data.valid.mask[:probe][None],
                                      scores.shape)]
        rec = {
            "itr": itr,
            "err_train": round(1.0 - int(match) / len(data.train), 4),
            "err_valid": round(err_valid, 4),
            "scores_pinned_at_bound": round(
                float((np.abs(live) >= maxf).mean()), 4),
            "scores_max_abs": round(overflow_stats(live, fmt)["max_abs"], 2),
        }
        for k, v in params.items():
            rec[f"max|{k}|"] = round(float(v.abs().max()), 3)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
