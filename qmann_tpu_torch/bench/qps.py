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
    training split, ``--train-iters`` epochs.
Inputs are qa1 (``load_task_native`` at ``--data-path`` /
``--raw-data-path``) or, with ``--synthetic``, ``synthetic_task`` at qa1's
shape (V=19, M=10, W=6; 9000/1000/1000 stories, or ``--max-samples``
training stories); the output says which.  The route flags choose the
route as on the CLI.  On a CUDA device every time is CUDA events around
the work, closed by ``torch.cuda.synchronize()``; on the CPU
(``--device cpu``) the host clock, and the output says so.  Prints one
JSON line with the card's name and power limit (``nvidia-smi``) and the
torch and CUDA versions.  ``--sharded`` raises: the device mesh is not
ported.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

QA1 = "qa1_single-supporting-fact"
QA1_SHAPE = (19, 10, 6)          # V, M, W of qa1
SYNTHETIC_SPLITS = (9000, 1000, 1000)


class _Timer:
    """Seconds of the work between start() and stop(): CUDA events on a
    CUDA device (closed by a synchronize), else the host clock."""

    def __init__(self, dev):
        import torch
        self.torch, self.cuda = torch, dev.type == "cuda"

    def start(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            self._t0 = self.torch.cuda.Event(enable_timing=True)
            self._t1 = self.torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._h0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._t1.record()
            self.torch.cuda.synchronize()
            return self._t0.elapsed_time(self._t1) / 1e3
        return time.perf_counter() - self._h0


def _card() -> str:
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.qps")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--train-iters", type=int, default=10)
    p.add_argument("--requests", type=int, default=2048)
    p.add_argument("--sharded", action="store_true",
                   help="not ported: raises NotImplementedError")
    p.add_argument("--attention-mode", type=int, default=2,
                   choices=[1, 2, 3, 4])
    p.add_argument("--iwl", type=int, default=5)
    p.add_argument("--use-pallas", action="store_true")
    p.add_argument("--use-pallas-hamming", action="store_true")
    p.add_argument("--use-fused-chain", action="store_true")
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic_task at qa1's shape instead of files")
    p.add_argument("--max-samples", type=int, default=None,
                   help="limit train samples")
    p.add_argument("--data-path",
                   default="/root/reference/MemN2N/dataset/en_10k_parsed")
    p.add_argument("--raw-data-path",
                   default="/root/reference/MemN2N/dataset/"
                           "tasks_1-20_v1-2/en-10k")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.sharded:
        raise NotImplementedError("--sharded: the device mesh (parallel/) is "
                                  "not ported to qmann_tpu_torch yet "
                                  "(ROADMAP.md, Queue 1)")

    import numpy as np
    import torch

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.losses import cross_entropy
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.train.trainer import (_batched_arrays, check_ported,
                                               train_epoch)

    cfg = QmannConfig(attention_mode=args.attention_mode, iwl=args.iwl,
                      use_pallas=args.use_pallas,
                      use_pallas_hamming=args.use_pallas_hamming,
                      use_fused_chain=args.use_fused_chain, verbose=False,
                      data_path=args.data_path,
                      raw_data_path=args.raw_data_path, seed=args.seed)
    check_ported(cfg)
    dev = resolve_device(args.device)
    card = _card() if dev.type == "cuda" else None
    if args.synthetic:
        n_train = args.max_samples or SYNTHETIC_SPLITS[0]
        data = synthetic_task(np.random.default_rng(args.seed), n_train,
                              *SYNTHETIC_SPLITS[1:], *QA1_SHAPE)
        source = (f"synthetic_task at qa1's shape (V, M, W = {QA1_SHAPE}), "
                  f"seed {args.seed}")
    else:
        data = load_task_native(QA1, cfg.data_path,
                                raw_path=cfg.raw_data_path,
                                limit_train=args.max_samples)
        source = f"bAbI {QA1} from {cfg.data_path} / {cfg.raw_data_path}"
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(args.seed),
                                device=dev)
    timer = _Timer(dev)

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
    train_epoch(p_train, batches, lr, cfg)
    timer.start()
    for _ in range(args.train_iters):
        train_epoch(p_train, batches, lr, cfg)
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
        "devices": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "card": card,
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "torch": torch.__version__, "cuda": torch.version.cuda,
        "data": source, "batch": n, "iters": args.iters,
        "train_iters": args.train_iters, "train_samples": len(data.train),
        "requests": args.requests,
        "route": {"attention_mode": cfg.attention_mode, "iwl": cfg.iwl,
                  "use_pallas": cfg.use_pallas,
                  "use_pallas_hamming": cfg.use_pallas_hamming,
                  "use_fused_chain": cfg.use_fused_chain}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
