"""How much of a serving call is host dispatch (counterpart of
``qmann_tpu/bench/probe_dispatch.py``): per-call time, each call synced
(the serving engine's regime, on 8 distinct rolled waves), against bench.py's
program of K serially dependent batches with no host sync between them
(``bench/common.py::dependent_batches``, as bench/backend_ab.py runs it).

    python -m qmann_tpu_torch.bench.probe_dispatch [--batch 1000]
        [--iters 30] [--scan-k 30] [--use-fused-chain]
        [--data-path DIR --raw-data-path DIR | --synthetic] [--device cuda]

Prints one JSON line:
  per_call_qps           ``forward`` (the training forward on the raw
                         weights) + the prediction (``argmax_last``, as in
                         ``dependent_batches``), each call ended by a copy
                         of the predictions to the host;
  per_call_prepared_qps  the same with ``forward_prepared``;
  device_scan_qps        ``forward_prepared`` over --scan-k dependent
                         batches, one host sync at the end (on the card one
                         captured CUDA graph, replayed under torch's sync
                         debug mode "error");
  prepared_speedup_x     per_call_prepared_qps / per_call_qps;
  dispatch_overhead_x    device_scan_qps / per_call_qps (JAX's ratio);
  prepared_dispatch_overhead_x  device_scan_qps / per_call_prepared_qps:
                         the same program synced per call and not.
JAX's scan runs ``forward``; the port's ``forward`` on the plain route
reads its integer fast path's predicates in one host sync per call
(``models/memn2n.py::_integer_fast_decisions``), so its scan could not be
free of syncs: the scan here runs ``forward_prepared``, and the notes in
the output say so.  The flags are JAX's plus the data flags, --device and
--use-fused-chain (the prepared calls on the chain kernel, the route whose
dispatch PERF.md's bottleneck (1) measures).  On the card the times are
CUDA events closed by a synchronize; on the CPU the host clock.
"""
from __future__ import annotations

import argparse
import json
import sys

from qmann_tpu_torch.bench.common import (
    Timer, add_data_flags, card, dependent_batches, load_qa1, route_of,
    sync_free)

NOTES = [
    "per_call_qps: the port's forward on the plain route reads the integer "
    "fast path's predicates in one host sync per call, besides the copy of "
    "the predictions that ends each call",
    "device_scan_qps runs forward_prepared (JAX's scan runs forward, which "
    "here syncs per call), with no host sync between its batches",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.probe_dispatch")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--scan-k", type=int, default=30)
    p.add_argument("--use-fused-chain", action="store_true",
                   help="the prepared calls on the chain kernel")
    add_data_flags(p)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.graphs import Graphs
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.losses import argmax_last

    dev = resolve_device(args.device)
    cfg = QmannConfig(verbose=False, use_fused_chain=args.use_fused_chain)
    # the train split only sets the dims: 1000 synthetic stories do
    data, source = load_qa1(args, n_train=1000 if args.synthetic else None)
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(0), device=dev)
    t = data.test
    n = min(args.batch, len(t))
    # distinct pre-staged waves (rolled copies of the test split): serving
    # waves differ call to call
    nrot = 8
    waves = []
    for r in range(nrot):
        idx = np.roll(np.arange(n), r)
        waves.append(tuple(torch.from_numpy(np.ascontiguousarray(a[idx]))
                           .to(dev) for a in (t.memory, t.question, t.mask)))
    timer = Timer(dev)

    def per_call_qps(infer):
        infer(*waves[0]).cpu()
        timer.start()
        for i in range(args.iters):
            infer(*waves[i % nrot]).cpu()
        return n * args.iters / timer.stop()

    @torch.inference_mode()
    def infer(mem, que, mask):
        return argmax_last(memn2n.forward(params, mem, que, mask, cfg).logits)

    per_call = per_call_qps(infer)

    prepared = memn2n.prepare_inference(
        params, cfg, max_count=float(data.dims.max_word + 1),
        max_rowsum=float(data.dims.max_word + 1))

    @torch.inference_mode()
    def infer_prepared(mem, que, mask):
        return argmax_last(memn2n.forward_prepared(prepared, mem, que, mask,
                                                   cfg).logits)

    per_call_prepared = per_call_qps(infer_prepared)

    k = args.scan_k
    mem, que, mask = waves[0]
    graphs = Graphs(dev)

    def forward_p(m, q, msk):
        return memn2n.forward_prepared(prepared, m, q, msk, cfg)

    def scan():
        return dependent_batches(forward_p, mem, que, mask, k, graphs)

    scan()   # eager: builds the kernels
    scan()   # captures the graph
    timer.start()
    sync_free(scan, dev)
    scan_qps = n * k / timer.stop()

    print(json.dumps({
        "per_call_qps": per_call,
        "per_call_prepared_qps": per_call_prepared,
        "prepared_speedup_x": per_call_prepared / per_call,
        "device_scan_qps": scan_qps,
        "dispatch_overhead_x": scan_qps / per_call,
        "prepared_dispatch_overhead_x": scan_qps / per_call_prepared,
        "prepared_exact_route": prepared.fast,
        "batch": n, "iters": args.iters, "scan_k": k,
        "device": str(dev), "card": card() if dev.type == "cuda" else None,
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "data": source, "route": route_of(cfg), "notes": NOTES}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
