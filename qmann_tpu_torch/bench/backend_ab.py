"""A/B of the serving forward's routes on bench.py's program (counterpart
of ``qmann_tpu/bench/backend_ab.py``).

Variants (all serving-prepared, all checked to give identical predictions
before any timing):
  unfused   forward_prepared on the plain route (bench.py's default)
  chain     forward_prepared + use_fused_chain: the whole K-hop loop as
            one launch of the chain kernel (csrc/hop_chain.cu)
  read      forward_prepared + use_pallas: each hop's read on the read
            kernel (csrc/attention_read.cu), the lin maps on the lattice
            kernel (csrc/qmatvec.cu)
  hamming   forward_prepared + use_pallas_hamming, attention mode 3 only:
            the Hamming score on its kernel (csrc/hamming.cu)

    python -m qmann_tpu_torch.bench.backend_ab [--repeats 7] [--scan-k 30]
        [--batch 1000] [--variants unfused,chain] [--attention-mode 2]
        [--synthetic V,M,W,D] [--weight-scale 1]
        [--data-path DIR --raw-data-path DIR] [--device cuda]

The program: ``--scan-k`` serially dependent batches of ``--batch``
queries (``bench/common.py::dependent_batches``: each batch adds to the
question a device scalar made from the previous batch's predictions, as
JAX's lax.scan body does), with no host sync between them: on the card
the K batches are one captured CUDA graph per variant (JAX jits the
scan), run under torch's sync debug mode "error", so a sync would raise.
The first call (the row's ``first_call_s``) runs them eagerly, the second
captures the graph, and its predictions must equal the first's.  Each
sample is CUDA events around all K batches; the row gives
the median, least and most of ``--repeats`` samples as queries/s (on the
CPU, ``--device cpu``, the host clock).  The data: qa1's test split
(``load_task_native`` at the path flags), or with ``--synthetic V,M,W,D``
random bag-of-words stories (dict size V, M memory rows, W words a row,
dim_emb D; numpy seed 0, as JAX's).  The weights: ``init_params`` from
seed 0, times ``--weight-scale`` (1, JAX's weights, by default); the
prepared route must be exact (JAX asserts the same).  Each row gives the
number of distinct predictions, which says how much the gate compares.

JAX's ``--chain-tile`` (the Pallas chain kernel's batch tile) has no
counterpart: the CUDA chain takes its geometry from
``ops/cuda/geometry.py``, so the flag is left out.  ``--weight-scale``,
``--data-path``, ``--raw-data-path`` and ``--device`` are added.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

from qmann_tpu_torch.bench.common import (
    QA1, Timer, add_path_flags, card, dependent_batches, sync_free)

VARIANTS = {"unfused": {}, "chain": dict(use_fused_chain=True),
            "read": dict(use_pallas=True),
            # mode-3 only: the kernel for JUST the Hamming score
            "hamming": dict(use_pallas_hamming=True)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.backend_ab")
    p.add_argument("--repeats", type=int, default=7)
    p.add_argument("--scan-k", type=int, default=30)
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--variants", default="unfused,chain")
    p.add_argument("--attention-mode", type=int, default=2,
                   choices=[1, 2, 3],
                   help="attention mode under test; 3 = Hamming (the "
                        "paper's core op — variants unfused/hamming/"
                        "read/chain give the plain lattice vs the Hamming "
                        "kernel vs the per-hop read kernel vs the chain)")
    p.add_argument("--synthetic", default="",
                   help="V,M,W,D: skip bAbI — random BoW stories with "
                        "dict size V, M memory rows, W words/row, "
                        "dim_emb D")
    p.add_argument("--weight-scale", type=float, default=1.0,
                   help="multiply the seeded weights (1: JAX's; at 1 the "
                        "mode-2 model predicts one class for every query, "
                        "so the gate compares little)")
    add_path_flags(p)
    p.add_argument("--device", default="cuda")
    return p


def synthetic_inputs(V: int, M: int, W: int, B: int):
    """JAX's --synthetic recipe (numpy seed 0): (dims, memory, question,
    mask) as numpy arrays."""
    from qmann_tpu_torch.data import DataDims
    rng = np.random.default_rng(0)
    mem = np.zeros((B, M, V + M), np.float32)
    b_ix = np.arange(B)[:, None, None]
    m_ix = np.arange(M)[None, :, None]
    np.add.at(mem, (b_ix, m_ix, rng.integers(0, V, (B, M, W))), 1.0)
    mem[:, np.arange(M), V + np.arange(M)] = 1.0  # temporal one-hots
    que = np.zeros((B, V + M), np.float32)
    np.add.at(que, (np.arange(B)[:, None], rng.integers(0, V, (B, W))), 1.0)
    return DataDims(V, M, W, W + 1, V + M), mem, que, np.ones((B, M), bool)


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    names = [v.strip() for v in args.variants.split(",") if v.strip()]
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        p.error(f"--variants: unknown {unknown}; choose from "
                f"{sorted(VARIANTS)}")
    if "hamming" in names and args.attention_mode != 3:
        p.error("--variants hamming is mode-3 only (use_pallas_hamming is "
                "a no-op elsewhere; the A/B would compare identical "
                "programs)")

    import torch

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.graphs import Graphs
    from qmann_tpu_torch.models import memn2n

    dev = resolve_device(args.device)
    base = QmannConfig(verbose=False, attention_mode=args.attention_mode)
    if args.synthetic:
        V, M, W, D = (int(t) for t in args.synthetic.split(","))
        base = base.replace(dim_emb=D)
        dims, *arrays = synthetic_inputs(V, M, W, args.batch)
        max_count = float(arrays[0].max())
        max_rowsum = float(np.abs(arrays[0]).sum(-1).max())
        source = f"synthetic V,M,W,D = {args.synthetic}, numpy seed 0"
    else:
        data = load_task_native(QA1, args.data_path,
                                raw_path=args.raw_data_path)
        dims, test = data.dims, data.test
        arrays = [a[:args.batch] for a in (test.memory, test.question,
                                           test.mask)]
        max_count = max_rowsum = float(dims.max_word + 1)
        source = f"bAbI {QA1} from {args.data_path} / {args.raw_data_path}"
    memory, question, mask = (
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)
    batch = int(memory.shape[0])
    params = {k: args.weight_scale * v for k, v in memn2n.init_params(
        base, dims, torch.Generator().manual_seed(0), device=dev).items()}
    k = args.scan_k
    timer = Timer(dev)
    card_name = card() if dev.type == "cuda" else None

    def build(cfg):
        prepared = memn2n.prepare_inference(
            params, cfg, max_count=max_count, max_rowsum=max_rowsum)
        if not prepared.fast:
            raise ValueError("the prepared route is not exact under these "
                             "weights and inputs: the A/B would time the "
                             "training forward")

        def forward(mem, que, mask_):
            return memn2n.forward_prepared(prepared, mem, que, mask_, cfg)

        graphs = Graphs(dev)
        return lambda: dependent_batches(forward, memory, question, mask, k,
                                         graphs)

    ref_preds = None
    rows = []
    for name in names:
        fn = build(base.replace(**VARIANTS[name]))
        t0 = time.perf_counter()
        preds = fn().cpu()
        first_s = time.perf_counter() - t0
        if ref_preds is None:
            ref_preds = preds
        elif not torch.equal(preds, ref_preds):
            raise AssertionError(
                f"{name} diverges: {int((preds != ref_preds).sum())} of "
                f"{preds.numel()} predictions differ from {names[0]}'s")
        if not torch.equal(fn().cpu(), preds):   # the capture's replay
            raise AssertionError(f"{name}: the graph's predictions differ "
                                 "from the eager call's")
        samples = []
        for _ in range(args.repeats):
            timer.start()
            sync_free(fn, dev)
            samples.append(batch * k / timer.stop())
        rows.append({"variant": name,
                     "qps_median": statistics.median(samples),
                     "qps_min": min(samples), "qps_max": max(samples),
                     "ms_per_batch_median":
                         1e3 * batch / statistics.median(samples),
                     "first_call_s": first_s, "outputs_identical": True,
                     "distinct_predictions": int(preds.unique().numel()),
                     "host_syncs_in_loop": 0 if dev.type == "cuda" else None,
                     "batch": batch, "scan_k": k,
                     "attention_mode": args.attention_mode,
                     "device": str(dev), "card": card_name,
                     "timer": ("cuda_events" if dev.type == "cuda"
                               else "host_clock"), "data": source})
        print(json.dumps(rows[-1]), flush=True)
    if len(rows) > 1:
        best = max(rows, key=lambda r: r["qps_median"])
        print(json.dumps({"winner": best["variant"],
                          "speedup_vs_unfused":
                              best["qps_median"] / rows[0]["qps_median"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
