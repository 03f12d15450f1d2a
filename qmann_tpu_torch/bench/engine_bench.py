"""Engine-regime throughput benchmark: the serving engine end to end
(counterpart of ``qmann_tpu/bench/engine_bench.py``).

bench.py's program times serially dependent batches with no host round
trip between them (``bench/backend_ab.py`` here).  The serving engine
lives in the other regime: one forward per wave, with host-side
vectorization, queueing, and a copy of the predictions to the host at the
end of every wave.  This tool drives the real ``serve.InferenceEngine``
with a test split's stories from producer threads and reports sustained
throughput, request-latency percentiles, and the engine's own wave phase
breakdown (vectorize vs the wave's forward, argmax and host copy).

A/B: --no-prepare serves with the training forward (per-wave weight
quantization and, on the plain route, the integer fast path's predicates)
instead of the serving-prepared path.  By default the A/B runs
INTERLEAVED: both engines are built up front, first answer every request
once each (the answers must be identical, or the tool raises), and the
passes alternate prepared/unprepared with the order flipped every pass,
so drift hits both variants equally and the per-pass paired ratio holds
even when the absolute qps moves.

    python -m qmann_tpu_torch.bench.engine_bench [--batch 200] [--passes 5]
        [--producers 8] [--requests 1000] [--no-prepare | --prepare-only]
        [--use-pallas] [--use-fused-chain] [--data-path DIR
        --raw-data-path DIR | --synthetic] [--device cuda]

The flags are JAX's plus bench/qps.py's data flags, --device and two
route flags: with --use-fused-chain --use-pallas the prepared engine
serves through the chain kernel and the unprepared one through the
lattice and read kernels.  --synthetic takes synthetic_task at qa1's
shape (for the dims and dictionary) and ``synthetic_samples`` stories as
the requests.  The weights: ``init_params`` from seed 0, as JAX's.
Wave times are the engine's host clock around work that ends in a host
copy; every row names the device and, on the card, its name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import sys
import threading
import time

from qmann_tpu_torch.bench.common import (
    QA1_SHAPE, add_data_flags, card, load_qa1, route_of)


def _run_pass(eng, samples, producers: int):
    """Submit every sample from `producers` threads; return (wall_s,
    per-request latencies)."""
    lat = [0.0] * len(samples)
    done = threading.Barrier(producers + 1)

    def produce(shard):
        done.wait()  # start together
        futs = []
        for i in samples_idx[shard::producers]:
            s = samples[i]
            t0 = time.perf_counter()
            futs.append((i, t0, eng.submit(s.sentences, s.question)))
        for i, t0, f in futs:
            f.result(timeout=300)
            lat[i] = time.perf_counter() - t0

    samples_idx = list(range(len(samples)))
    threads = [threading.Thread(target=produce, args=(k,))
               for k in range(producers)]
    for t in threads:
        t.start()
    done.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    return time.perf_counter() - t0, lat


def _answers(eng, samples):
    futs = [eng.submit(s.sentences, s.question) for s in samples]
    return [f.result(timeout=300) for f in futs]


def _summarize(prepare: bool, walls, lats, st):
    lats = sorted(lats)
    n = len(lats)
    total = sum(walls)
    return {
        "prepared": prepare,
        "requests": st["requests"],
        "waves": st["waves"],
        "mean_wave_fill": st["requests"] / max(st["waves"], 1),
        "sustained_qps": st["requests"] / total,
        "wall_s_per_pass": walls,
        "latency_ms_p50": 1e3 * lats[n // 2],
        "latency_ms_p95": 1e3 * lats[int(n * 0.95)],
        "latency_ms_p99": 1e3 * lats[int(n * 0.99)],
        "wave_vectorize_ms_avg": 1e3 * st["vectorize_s"] / max(st["waves"],
                                                               1),
        "wave_infer_ms_avg": 1e3 * st["infer_s"] / max(st["waves"], 1),
        "failed_waves": st["failed_waves"],
    }


def _make_engine(prepare: bool, args, cfg, data, params, dev):
    from qmann_tpu_torch.serve import InferenceEngine

    return InferenceEngine(params, cfg, data.dims, data.dictionary,
                           batch_size=args.batch,
                           max_wait_ms=args.max_wait_ms,
                           prepare=prepare, device=dev).start()


def _measure(prepare: bool, args, cfg, data, samples, params, dev):
    eng = _make_engine(prepare, args, cfg, data, params, dev)
    try:
        # warmup pass (kernel builds, allocator), excluded from the numbers
        _run_pass(eng, samples[:args.batch], args.producers)
        eng.stats = type(eng.stats)()  # reset counters
        walls, lats = [], []
        for _ in range(args.passes):
            wall, lat = _run_pass(eng, samples, args.producers)
            walls.append(wall)
            lats.extend(lat)
        st = eng.stats.snapshot()
    finally:
        eng.stop()
    return [_summarize(prepare, walls, lats, st)]


def _measure_interleaved(args, cfg, data, samples, params, dev):
    """Paired A/B: both engines live at once (waves run only inside
    submit-driven flushes, so they never contend for the device), passes
    alternate prepared/unprepared with the order flipped each round.
    Before any timing both engines answer every request once, and the
    answers must be identical."""
    eng = {v: _make_engine(v, args, cfg, data, params, dev)
           for v in (True, False)}
    try:
        answers = {v: _answers(eng[v], samples) for v in eng}
        differ = sum(a != b for a, b in zip(answers[True], answers[False]))
        if differ:
            raise RuntimeError(
                f"the prepared and unprepared engines answer {differ} of "
                f"{len(samples)} requests differently")
        for v in (True, False):  # warmup, both first
            _run_pass(eng[v], samples[:args.batch], args.producers)
            eng[v].stats = type(eng[v].stats)()
        walls = {True: [], False: []}
        lats = {True: [], False: []}
        for k in range(args.passes):
            order = (True, False) if k % 2 == 0 else (False, True)
            for v in order:
                wall, lat = _run_pass(eng[v], samples, args.producers)
                walls[v].append(wall)
                lats[v].extend(lat)
        stats = {v: eng[v].stats.snapshot() for v in eng}
    finally:
        for e in eng.values():
            e.stop()
    rows = [_summarize(v, walls[v], lats[v], stats[v])
            for v in (True, False)]
    ratios = sorted(walls[False][k] / walls[True][k]
                    for k in range(args.passes))
    rows.append({
        "answers_identical": True,
        "paired_speedup_per_pass": [walls[False][k] / walls[True][k]
                                    for k in range(args.passes)],
        "paired_speedup_median": ratios[len(ratios) // 2],
        "prepared_infer_ms_saved_per_wave":
            rows[1]["wave_infer_ms_avg"] - rows[0]["wave_infer_ms_avg"],
    })
    return rows


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="qmann_tpu_torch.bench.engine_bench")
    p.add_argument("--task", type=int, default=1)
    p.add_argument("--batch", type=int, default=200,
                   help="engine wave size (fixed batch shape)")
    p.add_argument("--passes", type=int, default=5,
                   help="measured passes over the test split per variant")
    p.add_argument("--producers", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--requests", type=int, default=1000,
                   help="test-split requests per pass")
    p.add_argument("--no-prepare", action="store_true",
                   help="measure ONLY the unprepared engine")
    p.add_argument("--prepare-only", action="store_true",
                   help="measure ONLY the prepared engine")
    p.add_argument("--use-pallas", action="store_true",
                   help="the unprepared engine on the lattice and read "
                        "kernels")
    p.add_argument("--use-fused-chain", action="store_true",
                   help="the prepared engine on the chain kernel")
    add_data_flags(p)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import load_samples, synthetic_samples
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.device import resolve_device
    from qmann_tpu_torch.models import memn2n

    dev = resolve_device(args.device)
    cfg = QmannConfig(use_pallas=args.use_pallas,
                      use_fused_chain=args.use_fused_chain, verbose=False,
                      data_path=args.data_path,
                      raw_data_path=args.raw_data_path)
    if args.synthetic:
        data, source = load_qa1(args, n_train=1000)
        samples = synthetic_samples(np.random.default_rng(1), args.requests,
                                    *QA1_SHAPE)
    else:
        name = cfg.task_name(args.task)
        data = load_task_native(name, cfg.data_path,
                                raw_path=cfg.raw_data_path)
        samples = load_samples(name, "test", cfg.data_path,
                               raw_path=cfg.raw_data_path,
                               limit=args.requests)
        source = f"bAbI {name} from {cfg.data_path} / {cfg.raw_data_path}"
    params = memn2n.init_params(cfg, data.dims,
                                torch.Generator().manual_seed(0), device=dev)

    if args.no_prepare or args.prepare_only:
        rows = _measure(args.prepare_only, args, cfg, data, samples, params,
                        dev)
    else:
        rows = _measure_interleaved(args, cfg, data, samples, params, dev)
    meta = {"device": str(dev),
            "card": card() if dev.type == "cuda" else None,
            "timer": "host_clock", "data": source,
            "requests_per_pass": len(samples), "route": route_of(cfg)}
    for r in rows:
        print(json.dumps({**r, **meta}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
