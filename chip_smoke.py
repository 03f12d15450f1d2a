#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device  — a CUDA device is required (no CPU fallback); prints
               nvidia-smi's name and power limit
  2. build   — compiles the chain kernel from qmann_tpu_torch/csrc
  3. kernel  — the hop-chain kernel against its plain PyTorch version, both
               on the card, at the flagship shape (B=1000, M=10, I=29, D=60,
               K=3, EN_MQ formats) and the wide layout (M=50, I=114)
  4. slice   — an InferenceEngine on cuda:0 answers ~100 synthetic
               qa1-shaped requests over several waves; every answer equals
               the plain route's, and the chain kernel must have launched
  5. times   — forward_prepared on 1000-query batches, kernel route and
               plain route, and the kernel alone against the plain chain
               (CUDA events, median of 7 samples)
Then one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.

Tolerances (as tests/test_torch_chain.py): hop 0's scores bit-identical;
p within atol 1e-6 (exp differs by an ulp between implementations); at
most 1 query per comparison in which a Q(p, act) requant flipped, and every
other query bit-identical in all scores and in u_final.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
BATCH = 1000


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def scaled_prepared(cfg, dims, mem, dev):
    """Seeded Gaussian params scaled x6, x5 or x4 — the largest scale at
    which prepare_inference keeps the exact-GEMM route (unscaled N(0, 0.1)
    weights quantize almost entirely to 0 or +-0.25 at Q5.2)."""
    import torch
    from qmann_tpu_torch.models import memn2n
    base = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(SEED))
    for scale in (6.0, 5.0, 4.0):
        params = {k: (v * scale).to(dev) for k, v in base.items()}
        prep = memn2n.prepare_inference(
            params, cfg, max_count=float(dims.max_word + 1),
            max_rowsum=float(dims.max_word + 1))
        if prep.fast and float(mem.max()) <= dims.max_word + 1:
            return scale, params, prep
    fail("no weight scale keeps prepare_inference on the exact route")


def compare_chain(cfg, got, want):
    """The module docstring's tolerances; returns (max |diff| per output,
    flipped-query count, whether all tolerances hold)."""
    import torch
    from qmann_tpu_torch.numerics import float_quant
    (u_g, p_g, s_g), (u_w, p_w, s_w) = got, want
    diffs = {name: float((a - b).abs().max()) for name, a, b in
             (("u_final", u_g, u_w), ("p", p_g, p_w), ("scores", s_g, s_w))}
    flipped = torch.zeros(u_g.shape[0], dtype=torch.bool, device=u_g.device)
    for h, fmt in enumerate(cfg.fmt_act):
        flipped |= (float_quant(p_g[h], fmt) != float_quant(p_w[h], fmt)).any(-1)
    ok = ~flipped
    good = (torch.equal(s_g[0], s_w[0]) and diffs["p"] <= 1e-6
            and torch.equal(s_g[:, ok], s_w[:, ok])
            and torch.equal(u_g[ok], u_w[ok]) and int(flipped.sum()) <= 1)
    return diffs, int(flipped.sum()), good


def cuda_ms(fn, n_iter=20, samples=7):
    """Median over samples of the mean time of n_iter calls (CUDA events)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n_iter):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n_iter)
    return statistics.median(times)


def device_ms(fn, n_iter=20):
    """Device busy time per call, summed over every kernel the call runs,
    from torch.profiler's CUDA activity; {kernel name: ms per call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    # only the device-side kernel events: an aten op also reports its
    # kernels' time as its own self device time
    return {ev.key: ev.self_device_time_total / n_iter / 1000.0
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0}


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (REPO / "qmann_tpu_torch" / "csrc").is_dir():
        fail(f"{REPO} is not a checkout of the repository")
    sys.path.insert(0, str(REPO))
    import numpy as np
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import Dictionary, synthetic_batch
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.numerics import float_quant
    from qmann_tpu_torch.ops import exact_matmul
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.serve import InferenceEngine, Request

    # 1. device
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path, log = hop_chain.build()
    hop_chain.load_library()
    ptxas = " ".join(ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "smem" in ln)
    print(f"[2 build] {lib_path.name} in {time.perf_counter() - t0:.2f} s; "
          f"ptxas: {ptxas or 'cached build'}", flush=True)

    # 3. kernel against plain, both on the card
    cfg = QmannConfig(use_fused_chain=True)
    rng = np.random.default_rng(SEED)
    shapes = {"flagship": (19, 10, 6), "wide": (64, 50, 7)}
    max_err, chain_args = 0.0, None
    for name, (V, M, W) in shapes.items():
        dims, mem, que, mask = synthetic_batch(rng, BATCH, V, M, W)
        scale, _, prep = scaled_prepared(cfg, dims, mem, dev)
        mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                for a in (mem, que, mask))
        flat = exact_matmul(mem_t, prep.embed_wt)
        u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
        args = (flat, u, prep.hmats, mask_t, cfg.fmt_w, cfg.fmt_att,
                cfg.fmt_bin, cfg.fmt_act)
        got = hop_chain.fused_hop_chain(*args)
        want = hop_chain.fused_hop_chain_reference(*args)
        torch.cuda.synchronize()
        diffs, flips, good = compare_chain(cfg, got, want)
        print(f"[3 kernel] {name} B={BATCH} M={M} I={V + M} D={cfg.dim_emb} "
              f"K={cfg.num_hops} weights x{scale}: max|diff| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
              + f"; queries with a flipped Q(p, act): {flips}", flush=True)
        if not good:
            fail(f"chain kernel disagrees with the plain version ({name})")
        max_err = max(max_err, *diffs.values())
        if name == "flagship":
            chain_args = args

    # 4. the slice: engine on cuda:0, ~100 requests over several waves
    V, M, W = shapes["flagship"]
    dictionary = Dictionary()
    for i in range(1, V):
        dictionary.add(f"w{i}")
    words = dictionary.words[1:]
    stories = [([[words[i] for i in rng.integers(0, len(words),
                                                 rng.integers(1, W + 1))]
                 for _ in range(rng.integers(1, M + 3))],
                [words[i] for i in rng.integers(0, len(words), 4)])
               for _ in range(100)]
    dims, mem0, _, _ = synthetic_batch(rng, 8, V, M, W)
    scale, params, _ = scaled_prepared(cfg, dims, mem0, dev)
    engine = InferenceEngine(params, cfg, dims, dictionary, batch_size=32,
                             device=dev)
    if not engine.prepared.fast:
        fail("the engine's prepared forward left the exact route")
    hop_chain.fused_hop_chain.launches = 0
    engine.start()
    try:
        futures = [engine.submit(s, q) for s, q in stories]
        answers = [f.result(timeout=300) for f in futures]
    finally:
        engine.stop()
    launches = hop_chain.fused_hop_chain.launches
    stats = engine.stats
    plain = InferenceEngine(params, cfg.replace(use_fused_chain=False), dims,
                            dictionary, batch_size=32, device=dev)
    want, logits_ok = [], True
    for i in range(0, len(stories), 32):
        reqs = [Request(s, q) for s, q in stories[i:i + 32]]
        batch = plain._vectorize(reqs)
        want.extend(plain.infer(*batch)[:len(reqs)].tolist())
        out = memn2n.forward_prepared(
            engine.prepared, *(torch.from_numpy(a).to(dev) for a in batch),
            cfg)
        logits_ok &= (tuple(out.logits.shape) == (32, V + M)
                      and bool(torch.isfinite(out.logits).all()))
    print(f"[4 slice] {len(answers)} answers over {stats.waves} waves, "
          f"failed_waves {stats.failed_waves}, chain launches {launches}, "
          f"weights x{scale}, distinct answers {len(set(answers))}, "
          f"equal to plain route: {answers == want}", flush=True)
    if stats.failed_waves or stats.requests != len(stories):
        fail("engine waves failed or requests went missing")
    if launches < 1:
        fail("the main path never launched the chain kernel")
    if answers != want or not logits_ok:
        fail("engine answers differ from the plain route or are not finite")

    # 5. times at B=1000 on the flagship shape
    _, mem, que, mask = synthetic_batch(rng, BATCH, V, M, W)
    batch = tuple(torch.from_numpy(a).to(dev) for a in (mem, que, mask))
    prep_k = engine.prepared
    cfg_plain = cfg.replace(use_fused_chain=False)
    with torch.inference_mode():
        t_route = cuda_ms(lambda: memn2n.forward_prepared(prep_k, *batch, cfg))
        t_plain = cuda_ms(lambda: memn2n.forward_prepared(prep_k, *batch,
                                                          cfg_plain))
        t_kern = cuda_ms(lambda: hop_chain.fused_hop_chain(*chain_args))
        t_ref = cuda_ms(lambda: hop_chain.fused_hop_chain_reference(
            *chain_args))
        busy = {name: device_ms(fn) for name, fn in (
            ("kernel route", lambda: memn2n.forward_prepared(
                prep_k, *batch, cfg)),
            ("plain route", lambda: memn2n.forward_prepared(
                prep_k, *batch, cfg_plain)),
            ("chain kernel", lambda: hop_chain.fused_hop_chain(*chain_args)))}
    print(f"[5 times] {card} | forward_prepared B={BATCH}: kernel route "
          f"{t_route:.4f} ms, plain route {t_plain:.4f} ms | chain alone: "
          f"kernel {t_kern:.4f} ms, plain {t_ref:.4f} ms", flush=True)
    # device busy time per call (profiler); the rest of the event time is
    # the device waiting on the host
    for name, kernels in busy.items():
        total = sum(kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1])[:4]
        print(f"[5 device] {name}: busy "
              + (f"{total:.4f} ms/call over {len(kernels)} kernels; top "
                 + "; ".join(f"{k[:48]} {v:.4f}" for k, v in top)
                 if kernels else "not measured (profiler saw no device time)"),
              flush=True)

    print(json.dumps({"kernels": [{
        "name": "hop_chain", "route": "cuda",
        "source": "qmann_tpu_torch/csrc/hop_chain.cu",
        "replaces": "qmann_tpu/ops/pallas/qkernels.py:358",
        "launches": launches, "max_abs_err": max_err,
        "ms": t_kern, "plain_ms": t_ref}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
