"""Device time of the flagship forward (and optionally the training epoch)
per op and per model phase (counterpart of
``qmann_tpu/bench/trace_forward.py``) — the reference's
time_profile[10][7] observability (MemN2N/MemN2N.c:133-141, report at
:3000-3021) on torch.profiler.

JAX buckets device time by the HLO ``op_name``, which records the jaxpr
path.  Here each timed record is given the Python call path that issued
it: the trace is taken with ``with_stack`` (``utils/profiling.py::trace``),
a kernel is linked by its correlation id to the runtime call that launched
it, and the trace's python_function events that enclose that call on its
thread give the path.  That holds for the hand kernels too, which are
launched through ctypes with no aten op above them.  The path's functions
of this package, outermost first, are matched against JAX's BUCKETS (first
bucket wins), then against the port's own names (``PORT_KEYS``: the
embedding GEMM, the chain and read kernels); what matches neither is
"other".  On the CPU (``--device cpu``) the records are the outermost aten
ops instead of kernels.

    python -m qmann_tpu_torch.bench.trace_forward --out runs/trace
        [--train] [--iters 3] [--top 40] [--no-fast-path]
        [--use-fused-chain] [--data-path DIR --raw-data-path DIR |
        --synthetic] [--device cuda]

The inference profile runs bench.py's program, 30 serially dependent
1000-query batches (``bench/common.py::dependent_batches``), on
``forward`` (JAX's) or, with ``--use-fused-chain``, on
``forward_prepared`` through the chain kernel (the chain's only caller).
``--train`` profiles ``train_epoch`` (its backward runs on autograd's
thread, whose kernels have no Python path: "other").  ``--no-fast-path``
turns the integer fast path off in the inference forward; the training
step always runs without it, as JAX's ``train_epoch`` does by default.
JAX's compiled cost analysis has no counterpart and is left out.

The buckets need each launch's Python path, so the traced program runs
eagerly.  On the card the inference program is then also run as the one
CUDA graph the serving tools replay (``dependent_batches`` with a
``Graphs``) and profiled again: ``graph_replay`` in the JSON line gives,
per hand kernel, the kernel records CUPTI kept for the replays beside the
launches the wrappers' counts added (a replay's kernels have no Python
path of their own: they were launched at the capture).

The profiler may keep fewer kernel records than launches late in a long
process (PERF.md), so every time is given over the records kept, never
over the calls; for the four hand kernels the output puts the wrappers'
launch counts beside their records.  Prints the tables, then one JSON
line.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import time

# model-phase buckets: JAX's labels and keys, matched against the call
# path's function names joined outermost first.  Order matters: first
# match wins.
BUCKETS = [
    ("embed (A/C dense_mat)", ["qembed", "embed"]),
    ("query/linmap/output (qmatvec)", ["qmatvec", "matvec"]),
    ("attention score", ["attention", "score", "hamming"]),
    ("softmax", ["softmax"]),
    ("weighted sum", ["weighted"]),
    ("residual/sum/act", ["qsum", "activation"]),
    ("quantize", ["quant", "fixed"]),
    ("cross-entropy/pred", ["cross_entropy", "argmax", "log_softmax"]),
    ("sgd/clip/zeroing", ["sgd", "clip", "norm", "null"]),
    ("data movement", ["copy", "gather", "dynamic", "transpose-start",
                       "all-", "reduce-scatter"]),
]
# the port's names that JAX's keys miss, tried after them: the serving
# path's embedding GEMMs, the chain kernel (score, softmax, weighted sum
# and lin map of every hop in one launch) and the read kernel
PORT_KEYS = [
    ("embed (A/C dense_mat)", ["exact_matmul"]),
    ("attention score", ["hop_chain", "fused_read"]),
]
# the hand kernels: the kernels-line name -> the stem of the CUDA
# function's name in csrc/*.cu
HAND_KERNELS = {"hop_chain": "hop_chain_kernel", "qmatvec": "qmatvec_",
                "attention_read": "attention_read_kernel",
                "hamming_score": "hamming_kernel"}
_FRAME = re.compile(r"(.*)\((\d+)\): (.*)")


def classify(path: str) -> str:
    low = path.lower()
    for table in (BUCKETS, PORT_KEYS):
        for label, keys in table:
            if any(k in low for k in keys):
                return label
    return "other"


def _port_frame(name: str):
    """(module, function) of a python_function event of this package,
    else None."""
    m = _FRAME.match(name)
    if m is None or "qmann_tpu_torch" not in m.group(1):
        return None
    return os.path.splitext(os.path.basename(m.group(1)))[0], m.group(3)


def _enclosing(intervals, points):
    """intervals: {tid: [(start, end, payload)]} properly nested per
    thread; points: {tid: [(t, key)]} -> {key: [payloads of the intervals
    that hold t, outermost first]}."""
    out = {}
    for tid, pts in points.items():
        evs = sorted(intervals.get(tid, ()), key=lambda e: (e[0], -e[1]))
        stack, i = [], 0
        for t, key in sorted(pts, key=lambda p: p[0]):
            while i < len(evs) and evs[i][0] <= t:
                while stack and stack[-1][1] <= evs[i][0]:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1][1] <= t:
                stack.pop()
            out[key] = [e[2] for e in stack]
    return out


def _outermost(ops):
    """The cpu_op events not inside another cpu_op of their thread."""
    by_tid = collections.defaultdict(list)
    for e in ops:
        by_tid[e["tid"]].append(e)
    out = []
    for evs in by_tid.values():
        end = float("-inf")
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            if e["ts"] >= end:
                out.append(e)
                end = e["ts"] + e["dur"]
    return out


def aggregate_trace(trace_path: str, on_device: bool):
    """Parse a chrome trace written with with_stack -> a list of records
    {name, us, path (port frames outermost first), bucket}: the device's
    kernels, copies and sets linked to their launching call (on_device),
    else the outermost aten ops."""
    with open(trace_path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    py = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "python_function" and "dur" in e:
            frame = _port_frame(e["name"])
            if frame is not None:
                py[e["tid"]].append((e["ts"], e["ts"] + e["dur"], frame))
    if on_device:
        # launches through the runtime API, and the driver API's (cuBLAS
        # launches some of its GEMMs there)
        launch = {e["args"]["correlation"]: e for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        timed = [e for e in events
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        points = collections.defaultdict(list)
        for i, e in enumerate(timed):
            src = launch.get(e.get("args", {}).get("correlation"))
            if src is not None:
                points[src["tid"]].append((src["ts"], i))
    else:
        timed = _outermost([e for e in events if e.get("cat") == "cpu_op"
                            and "dur" in e])
        points = collections.defaultdict(list)
        for i, e in enumerate(timed):
            points[e["tid"]].append((e["ts"], i))
    stacks = _enclosing(py, points)
    records = []
    for i, e in enumerate(timed):
        path = "/".join(f for _, f in stacks.get(i, []))
        hand = next((k for k, stem in HAND_KERNELS.items()
                     if on_device and stem in e["name"]), None)
        records.append({"name": e["name"], "us": float(e["dur"]),
                        "path": path, "hand": hand,
                        "bucket": classify(path) if path else "other"})
    return records


def summarize(records, launches, top: int):
    """Per-bucket and per-(op, bucket) totals over the records kept (an
    op may serve several phases, as JAX keys its ops by (name, op_name)),
    and each hand kernel's records beside its wrapper's launches."""
    total = sum(r["us"] for r in records)
    buckets = collections.defaultdict(lambda: [0.0, 0])
    per_op = collections.defaultdict(lambda: [0.0, 0])   # (name, bucket)
    # per hand kernel: us, records, buckets, records without a path
    hand = {k: [0.0, 0, set(), 0] for k in launches}
    for r in records:
        b = buckets[r["bucket"]]
        b[0] += r["us"]
        b[1] += 1
        op = per_op[r["name"], r["bucket"]]
        op[0] += r["us"]
        op[1] += 1
        if r["hand"] in hand:
            h = hand[r["hand"]]
            h[0] += r["us"]
            h[1] += 1
            h[2].add(r["bucket"])
            h[3] += not r["path"]
    return {
        "total_ms": total / 1e3,
        "records": len(records),
        "records_without_path": sum(not r["path"] for r in records),
        "buckets": {label: {"ms": us / 1e3, "records": n,
                            "share": us / total if total else 0.0}
                    for label, (us, n) in sorted(buckets.items(),
                                                 key=lambda kv: -kv[1][0])},
        "top": [{"name": name, "bucket": b, "ms": us / 1e3, "records": n,
                 "ms_per_record": us / 1e3 / n}
                for (name, b), (us, n) in sorted(
                    per_op.items(), key=lambda kv: -kv[1][0])[:top]],
        "hand_kernels": {k: {"launches": launches[k], "records": n,
                             "records_without_path": no_path,
                             "ms": us / 1e3,
                             "ms_per_record": us / 1e3 / n if n else None,
                             "buckets": sorted(bs)}
                         for k, (us, n, bs, no_path) in hand.items()},
    }


def graph_records(run, wrappers, iters: int):
    """``run(graphs)`` (the inference program) captured as one CUDA graph
    and replayed ``iters`` times under the profiler: per hand kernel, the
    kernel records CUPTI kept and the launches the wrappers' counts
    added."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from qmann_tpu_torch.graphs import Graphs
    graphs = Graphs("cuda")
    run(graphs)   # eager
    run(graphs)   # the capture and its replay
    before = {k: fn.launches for k, fn in wrappers.items()}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run(graphs)
    recorded = collections.Counter()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            for k, stem in HAND_KERNELS.items():
                if stem in ev.key:
                    recorded[k] += ev.count
    return {k: {"records": recorded[k],
                "launches": fn.launches - before[k]}
            for k, fn in wrappers.items()}


def build_parser() -> argparse.ArgumentParser:
    from qmann_tpu_torch.bench.common import add_data_flags
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.trace_forward")
    p.add_argument("--out", default="runs/trace_r3")
    p.add_argument("--train", action="store_true",
                   help="profile the training epoch instead of inference")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--no-fast-path", action="store_true",
                   help="disable the runtime integer fast path in the "
                        "inference forward")
    p.add_argument("--use-fused-chain", action="store_true",
                   help="profile forward_prepared through the chain kernel")
    add_data_flags(p)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    from qmann_tpu_torch.bench.common import card, dependent_batches, load_qa1
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.cuda import attention_read, hamming, hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec
    from qmann_tpu_torch.utils.profiling import trace

    dev = resolve_device(args.device)
    cfg = QmannConfig(verbose=False,
                      en_integer_fast_path=not args.no_fast_path,
                      use_fused_chain=args.use_fused_chain)
    data, source = load_qa1(args, n_train=1000 if args.synthetic else None)
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(0), device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    if args.train:
        from qmann_tpu_torch.train.trainer import _batched_arrays, train_epoch
        batches = {k: torch.from_numpy(v).to(dev) for k, v in
                   _batched_arrays(data.train, cfg.size_batch).items()}
        lr = torch.tensor(0.3, dtype=torch.float32, device=dev)
        p_train = {k: v.clone() for k, v in params.items()}

        def run():
            train_epoch(p_train, batches, lr, cfg)
            sync()
    else:
        test = data.test
        batch = min(1000, len(test))
        memory, question, mask = (
            torch.from_numpy(a[:batch].copy()).to(dev)
            for a in (test.memory, test.question, test.mask))
        if args.use_fused_chain:
            prepared = memn2n.prepare_inference(
                params, cfg, max_count=float(data.dims.max_word + 1),
                max_rowsum=float(data.dims.max_word + 1))

            def forward(mem, que, msk):
                return memn2n.forward_prepared(prepared, mem, que, msk, cfg)
        else:
            def forward(mem, que, msk):
                return memn2n.forward(params, mem, que, msk, cfg)

        def run(graphs=None):
            dependent_batches(forward, memory, question, mask, 30, graphs)
            sync()

    wrappers = {"hop_chain": hop_chain.fused_hop_chain,
                "qmatvec": qmatvec.quantized_matvec,
                "attention_read": attention_read.fused_read,
                "hamming_score": hamming.hamming_score_kernel}
    run()  # warmup (kernel builds) outside the trace
    before = {k: fn.launches for k, fn in wrappers.items()}
    t0 = time.perf_counter()
    with trace(args.out, with_stack=True):
        for _ in range(args.iters):
            run()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches - before[k] for k, fn in wrappers.items()}
    print(f"traced {args.iters} iterations, wall {wall:.3f}s -> {args.out}")

    on_device = dev.type == "cuda"
    records = aggregate_trace(os.path.join(args.out, "trace.json"),
                              on_device)
    s = summarize(records, launches, args.top)
    graph_replay = (graph_records(run, wrappers, args.iters)
                    if on_device and not args.train else None)
    what = "device" if on_device else "host (outermost aten ops)"
    print(f"\n{what} total: {s['total_ms']:.3f} ms over {s['records']} "
          f"records ({s['records_without_path']} without a Python path), "
          f"{args.iters} iterations")
    print("\n== per-phase buckets (the time_profile analog) ==")
    for label, b in s["buckets"].items():
        print(f"  {label:<32s} {b['ms']:9.3f} ms  {100 * b['share']:5.1f}%"
              f"  {b['records']} records")
    print(f"\n== top {args.top} ops ==")
    for op in s["top"]:
        print(f"  {op['ms']:9.3f} ms  {op['records']:6d} records  "
              f"{op['ms_per_record']:.5f} ms/record  {op['bucket']}  "
              f"{op['name'][:80]}")
    if graph_replay is not None:
        print("\n== the program as one CUDA graph: kernel records / "
              "launches per hand kernel ==")
        for k, v in graph_replay.items():
            print(f"  {k:<16s} {v['records']} / {v['launches']}")
    print(json.dumps({
        **s, "timed": "kernel" if on_device else "cpu_op",
        "iters": args.iters, "wall_s": wall, "train": args.train,
        "device": str(dev), "card": card() if on_device else None,
        "graph_replay": graph_replay,
        "data": source, "trace": os.path.join(args.out, "trace.json"),
        "route": {"use_fused_chain": cfg.use_fused_chain,
                  "en_integer_fast_path": cfg.en_integer_fast_path}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
