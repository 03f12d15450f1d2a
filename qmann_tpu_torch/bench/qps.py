"""Throughput of the port on one device (counterpart of
``qmann_tpu/bench/qps.py``).

    python -m qmann_tpu_torch.bench.qps [--batch 1000] [--iters 30]
        [--train-iters 10] [--requests 2048] [--attention-mode 2]
        [--iwl 5] [--use-pallas] [--use-pallas-hamming] [--use-fused-chain]
        [--data-path DIR --raw-data-path DIR | --synthetic] [--device cuda]

Measures four numbers, as the JAX tool does:
  * inference_qps — ``forward`` + argmax over ``--batch`` test queries,
    ``--iters`` calls;
  * serving_engine_qps — the ``InferenceEngine`` (batch 256, 0.5 ms wait)
    answering ``--requests`` requests;
  * train_samples_per_sec and epoch_seconds — ``train_epoch`` over the
    training split, ``--train-iters`` epochs (on the card replays of the
    step's graph, captured in the untimed first epoch).
Inputs are qa1 (``load_task_native`` at ``--data-path`` /
``--raw-data-path``) or, with ``--synthetic``, ``synthetic_task`` at qa1's
shape (V=19, M=10, W=6; 9000/1000/1000 stories, or ``--max-samples``
training stories); the output says which.  The route flags choose the
route as on the CLI.  On a CUDA device every time is CUDA events around
the work, closed by ``torch.cuda.synchronize()``; on the CPU
(``--device cpu``) the host clock, and the output says so.  Prints one
JSON line with the card's name and power limit (``nvidia-smi``) and the
torch and CUDA versions, and as ``devices`` the process group's world
size (1 outside one).  ``--sharded`` parses and changes nothing, as JAX's
flag (``qmann_tpu/bench/qps.py``, never read).
"""
from __future__ import annotations

import argparse
import json
import sys

from qmann_tpu_torch.bench.common import (
    Timer, add_data_flags, card, load_qa1, route_of)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.qps")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--train-iters", type=int, default=10)
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--sharded", action="store_true",
                   help="accepted and unused, as in the JAX tool")
    p.add_argument("--attention-mode", type=int, default=2,
                   choices=[1, 2, 3, 4])
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--use-pallas", action="store_true")
    p.add_argument("--use-pallas-hamming", action="store_true")
    p.add_argument("--use-fused-chain", action="store_true")
    p.add_argument("--max-samples", type=int, default=None,
                   help="limit train samples")
    add_data_flags(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.graphs import Graphs
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.losses import cross_entropy
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.train.trainer import _batched_arrays, train_epoch

    cfg = QmannConfig(attention_mode=args.attention_mode, iwl=args.iwl,
                      use_pallas=args.use_pallas,
                      use_pallas_hamming=args.use_pallas_hamming,
                      use_fused_chain=args.use_fused_chain, verbose=False,
                      data_path=args.data_path,
                      raw_data_path=args.raw_data_path, seed=args.seed)
    dev = resolve_device(args.device)
    card_name = card() if dev.type == "cuda" else None
    data, source = load_qa1(args, args.seed, n_train=args.max_samples)
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(args.seed),
                                device=dev)
    timer = Timer(dev)

    # ---- inference qps: forward + argmax ----
    n = min(args.batch, len(data.test))
    t = data.test
    mem, que, ans, mask = (torch.from_numpy(np.ascontiguousarray(a[:n]))
                           .to(dev) for a in (t.memory, t.question,
                                              t.answer, t.mask))

    @torch.no_grad()
    def infer():
        out = memn2n.forward(params, mem, que, mask, cfg)
        return cross_entropy(out.logits, ans).pred

    infer()
    timer.start()
    for _ in range(args.iters):
        infer()
    qps = n * args.iters / timer.stop()

    # ---- training throughput ----
    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               _batched_arrays(data.train, cfg.size_batch).items()}
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=dev)
    p_train = {k: v.clone() for k, v in params.items()}
    graphs = Graphs(dev)   # the epoch's graph, captured in the first
    train_epoch(p_train, batches, lr, cfg, graphs=graphs)
    timer.start()
    for _ in range(args.train_iters):
        train_epoch(p_train, batches, lr, cfg, graphs=graphs)
    epoch_s = timer.stop() / args.train_iters
    train_sps = len(data.train) / epoch_s

    # ---- serving-engine throughput (continuous batching waves) ----
    eng = InferenceEngine(params, cfg, data.dims, data.dictionary,
                          batch_size=256, max_wait_ms=0.5,
                          device=dev).start()
    try:
        words = data.dictionary.words
        story = [[words[1], words[2], words[3]]]
        question = [words[1]]
        eng.submit(story, question).result(120)   # warm the path
        timer.start()
        futs = [eng.submit(story, question) for _ in range(args.requests)]
        for f in futs:
            f.result(120)
        serve_qps = args.requests / timer.stop()
    finally:
        eng.stop()

    print(json.dumps({
        "inference_qps": qps,
        "serving_engine_qps": serve_qps,
        "train_samples_per_sec": train_sps,
        "epoch_seconds": epoch_s,
        "device": str(dev),
        "devices": dist.get_world_size() if dist.is_initialized() else 1,
        "card": card_name,
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "data": source, "batch": n, "iters": args.iters,
        "train_iters": args.train_iters, "train_samples": len(data.train),
        "requests": args.requests,
        "route": route_of(cfg)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
