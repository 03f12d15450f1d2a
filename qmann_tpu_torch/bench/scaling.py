"""Scaling harness (counterpart of ``qmann_tpu/bench/scaling.py``): the
sharded training step's samples per second against the number of ranks.

    python -m qmann_tpu_torch.bench.scaling [--batch 256] [--devices 1,2,4]
        [--memory-rows 64] [--dim-input 128] [--dim-emb 64] [--iters 20]
        [--device cuda]

For each count n, n ranks are spawned as one process group
(``parallel/launch.py``) on a mesh of JAX's default layout
(``make_mesh(n)``), and each times ``--iters`` sharded steps on one
synthetic batch after a warm-up step: CUDA events on the card, the host
clock with ``--device cpu`` (where the counts are gloo processes).  Prints
JAX's JSON line per count (devices, train_samples_per_sec,
scaling_efficiency against the first count, per rank), with the card's
name and power limit on the card.  On the card a count above
``torch.cuda.device_count()`` exits 2, as JAX's tool refuses counts above
its devices: ranks sharing one card would give an efficiency for hardware
that is not there.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def measure(batch: int, m: int, dim_input: int, dim_emb: int, iters: int,
            device: str) -> float:
    """One rank's part: samples per second of the sharded step."""
    import numpy as np
    import torch

    from qmann_tpu_torch.bench.common import Timer
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import DataDims
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.parallel import (make_mesh, make_sharded_train_step,
                                          shard_batch, shard_params)

    mesh = make_mesh(device=device)
    cfg = QmannConfig(dim_emb=dim_emb, verbose=False)
    dims = DataDims(dim_dict=dim_input - m, max_line=m, max_word=7,
                    dim_word=8, dim_input=dim_input)
    rng = np.random.default_rng(0)
    params = shard_params(mesh, memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(0), device="cpu"))
    answer = np.zeros((batch, dim_input), np.float32)
    answer[np.arange(batch), rng.integers(1, dim_input, batch)] = 1.0
    batch_np = {
        "memory": rng.integers(0, 2, (batch, m, dim_input)).astype(
            np.float32),
        "question": rng.integers(0, 2, (batch, dim_input)).astype(np.float32),
        "answer": answer, "mask": np.ones((batch, m), bool),
        "sample_mask": np.ones(batch, np.float32)}
    step = make_sharded_train_step(cfg, mesh)
    lay = step.layout(batch, m)
    local = shard_batch(mesh, batch_np, lay.specs())
    lr = torch.tensor(0.3, device=mesh.device)
    size_b = torch.tensor(float(batch), device=mesh.device)
    step.local(params, local, lr, size_b, lay)
    timer = Timer(mesh.device)
    timer.start()
    for _ in range(iters):
        step.local(params, local, lr, size_b, lay)
    return batch * iters / timer.stop()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.scaling")
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--memory-rows", type=int, default=64)
    p.add_argument("--dim-input", type=int, default=128)
    p.add_argument("--dim-emb", type=int, default=64)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--devices", default=None,
                   help="comma list of rank counts; default 1..N pow2")
    p.add_argument("--device", default="cuda",
                   help="cuda (one rank per card) or cpu (gloo processes)")
    args = p.parse_args(argv)

    import torch

    from qmann_tpu_torch.bench.common import card
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.parallel.launch import run_ranks

    dev = resolve_device(args.device)
    total = (torch.cuda.device_count() if dev.type == "cuda"
             else os.cpu_count() or 1)
    if args.devices:
        counts = [int(x) for x in args.devices.split(",")]
        bad = [c for c in counts if c > total]
        if bad and dev.type == "cuda":
            print(f"error: requested device counts {bad} exceed the "
                  f"{total} available device(s)", file=sys.stderr)
            return 2
    else:
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= total]
    card_name = card() if dev.type == "cuda" else None
    base = None
    for n in counts:
        sps = run_ranks(measure, n, (args.batch, args.memory_rows,
                                     args.dim_input, args.dim_emb,
                                     args.iters, dev.type),
                        device=dev.type)[0]
        if base is None:
            base = sps
        print(json.dumps({
            "devices": n, "train_samples_per_sec": sps,
            "scaling_efficiency": sps / (base * n / counts[0]),
            "device": dev.type, "card": card_name,
            "timer": "cuda_events" if dev.type == "cuda" else "host_clock"}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
