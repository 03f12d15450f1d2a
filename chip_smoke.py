#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device  — a CUDA device is required (no CPU fallback); prints
               nvidia-smi's name and power limit
  2. build   — compiles the three kernels from qmann_tpu_torch/csrc, one
               nvcc per source, all started together
  3. kernel  — the hop-chain kernel against its plain PyTorch version, both
               on the card, at the flagship shape (B=1000, M=10, I=29, D=60,
               K=3, EN_MQ formats) and the wide layout (M=50, I=114)
  4. slice   — an InferenceEngine on cuda:0 answers ~100 synthetic
               qa1-shaped requests over several waves; every answer equals
               the plain route's, and the chain kernel must have launched
  5. times   — forward_prepared on 1000-query batches, kernel route and
               plain route, and the kernel alone against the plain chain
               (CUDA events, median of 7 samples)
  6. train-kernels — the qmatvec and attention-read kernels against their
               plain versions on the card, at the flagship training shape
               (B=32, M=10, I=29, D=60, EN_MQ formats; the 2K embeddings
               take B*M rows), the eval chunk (B=1024) and the wide layout
               (M=50, I=114); the last samples of each batch have no live
               memory row, as the padded samples of a partial batch
  7. train   — train_task on cuda:0 (use_pallas=True) for 2 epochs on a
               synthetic_task of 1000/100/100 qa1-shaped stories
               (1000 = 31*32 + 8: a last partial batch); 10 qmatvec and 3
               attention-read launches per training step and per eval
               chunk; every cost finite; one SGD step from the same weights
               on the kernel route and the plain route (a full batch and
               the partial one) agrees; prints both routes' histories
  8. train-times — one training step (forward + backward + SGD) at B=32 on
               each route, each new kernel and its plain version at B=32 and
               B=1024 (CUDA events, median of 7), and the profiler's device
               busy time and idle share of a step
Then one JSON line of kernels, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.

Tolerances.  Chain (as tests/test_torch_chain.py) and mode-2 attention
read: the scores bit-identical (hop 0's, for the chain); p within atol 1e-6
(exp and the softmax sum differ by an ulp between implementations); at
most 1 query per comparison in which a Q(p, act) requant flipped, every
other query bit-identical.  qmatvec: bit-identical (every lattice sum is
exact).  Mode-1 attention read: rtol 1e-5, atol 1e-6 (float sums in
another order).  SGD step: parameters within rtol 1e-5, atol 1e-6.

bound_ms is the larger of the bytes the call must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (float32 outside the tensor cores; H100 SXM data sheet at
700 W), counting 4 operations per float_quant (scale, convert, rescale,
saturate), 1 per multiply or add and 4 per softmax element.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
SEED = 0
BATCH = 1000
TRAIN_BATCH, EVAL_CHUNK = 32, 1024
DEVICE = "cuda:0"
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
Q_OPS = 4     # operations counted per float_quant


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
    base = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(SEED),
                              device=dev)
    for scale in (6.0, 5.0, 4.0):
        params = {k: v * scale for k, v in base.items()}
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


def _bound(nbytes, nops):
    """(least ms, what bounds it) for a call moving nbytes and doing nops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def qmatvec_bound(w, x):
    """Quantize w and x once, then per product a multiply, a requant and
    an add; requant each output."""
    (B, I), O = x.shape, w.shape[0]
    ops = Q_OPS * (O * I + B * I + B * O) + B * O * I * (2 + Q_OPS)
    return _bound(_nbytes(w, x) + 4 * B * O, ops)


def _read_ops(B, M, D):
    """One mode-2 attention read: quantize m, c and u; the score lattice
    and its requant; the softmax and Q(p); the weighted-sum lattice and
    the output requant."""
    return (Q_OPS * (2 * B * M * D + B * D) + B * M * D * (2 + Q_OPS)
            + B * M * (2 * Q_OPS + 4) + B * M * D * (2 + Q_OPS)
            + B * D * Q_OPS)


def attention_read_bound(m, c, u, mask):
    B, M, D = m.shape
    return _bound(_nbytes(m, c, u, mask) + 4 * (B * D + 2 * B * M),
                  _read_ops(B, M, D))


def chain_bound(flat, u, hmats, mask):
    """Per hop: the requant of the hop's A and C slices, one read, the lin
    map lattice (Q(H) once) and the residual (3 requants per element)."""
    B, M, _ = flat.shape
    K, D = hmats.shape[0], u.shape[1]
    per_hop = (Q_OPS * 2 * B * M * D + _read_ops(B, M, D)
               + Q_OPS * D * D + B * D * D * (2 + Q_OPS) + 3 * Q_OPS * B * D)
    return _bound(_nbytes(flat, u, hmats, mask) + 4 * (B * D + 2 * K * B * M),
                  K * per_hop)


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
    """Device time per call of every kernel the call runs, from
    torch.profiler's CUDA activity: {kernel name: (ms per call, launches
    per call)}."""
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
    return {ev.key: (ev.self_device_time_total / n_iter / 1000.0,
                     ev.count / n_iter)
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
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    from qmann_tpu_torch.serve import InferenceEngine, Request

    # 1. device
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # 2. build: one nvcc per source, all started together
    kernel_mods = {"hop_chain": hop_chain, "qmatvec": qmv,
                   "attention_read": ar}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernel_mods)) as pool:
        built = dict(zip(kernel_mods, pool.map(lambda m: m.build(),
                                               kernel_mods.values())))
    for mod in kernel_mods.values():
        mod.load_library()
    print(f"[2 build] {len(built)} kernels in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, (lib_path, log) in built.items():
        ptxas = " ".join(ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "smem" in ln)
        print(f"[2 build] {name}: {lib_path.name}; ptxas: "
              f"{ptxas or 'cached build'}", flush=True)

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
        total = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:4]
        print(f"[5 device] {name}: busy "
              + (f"{total:.4f} ms/call over {len(kernels)} kernels; top "
                 + "; ".join(f"{k[:48]} {v:.4f}" for k, (v, _) in top)
                 if kernels else "not measured (profiler saw no device time)"),
              flush=True)

    # 6. the training kernels against their plain versions, on the card
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.numerics import QFormat
    from qmann_tpu_torch.ops.qlinear import (qembed_mat_forward,
                                             qmatvec_forward)
    from qmann_tpu_torch.train import (sgd_update, train_step, train_task,
                                       zero_null_columns)
    from qmann_tpu_torch.train.trainer import _batched_arrays

    cfg_t = QmannConfig(use_pallas=True, verbose=False)
    K, fw = cfg_t.num_hops, cfg_t.fmt_w
    fmt_act = cfg_t.fmt_act[0]
    train_shapes = {"train": (TRAIN_BATCH, 19, 10, 6),
                    "eval": (EVAL_CHUNK, 19, 10, 6),
                    "wide": (TRAIN_BATCH, 64, 50, 7)}
    qmv_err, ar_err, qmv_args, read_args = 0.0, 0.0, {}, {}
    for name, (B, V, M, W) in train_shapes.items():
        dims, mem, que, mask = synthetic_batch(rng, B, V, M, W)
        for a in (mem, que, mask):
            a[-3:] = 0      # padded samples: no live memory row
        params = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg_t, dims, torch.Generator().manual_seed(SEED),
            device=dev).items()}
        mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                for a in (mem, que, mask))
        rows = mem_t.reshape(-1, dims.dim_input)
        u = qmatvec_forward(params["B"], que_t, fw[0], fw[0])
        cases = ([("query", params["B"], que_t, fw[0], fw[0])]
                 + [(f"embed {w}{h}", params[w], rows, fw[h], fw[h])
                    for w in "AC" for h in range(K)]
                 + [(f"linmap {h}", params["H"], u, fw[h], cfg_t.fmt_bin)
                    for h in range(K)]
                 + [("binary w", params["B"], que_t, QFormat(0, 0), fw[0]),
                    ("binary x", params["H"], u, fw[1], QFormat(0, 0))])
        unequal = []
        for label, w, x, f_w, f_x in cases:
            got = qmv.quantized_matvec(w, x, f_w, f_x)
            want = qmv.quantized_matvec_reference(w, x, f_w, f_x)
            qmv_err = max(qmv_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                unequal.append(label)
        torch.cuda.synchronize()
        print(f"[6 train-kernels] qmatvec {name}: {len(cases)} calls, "
              f"B={B} ({rows.shape[0]} embedding rows), I={dims.dim_input}, "
              f"O={cfg_t.dim_emb}; not bit-identical: "
              f"{', '.join(unequal) or 'none'}", flush=True)
        if unequal:
            fail(f"qmatvec kernel differs from its plain version ({name})")

        mask_f = mask_t.to(torch.float32)
        m = qembed_mat_forward(mem_t, params["A"], fw[0])
        c = qembed_mat_forward(mem_t, params["C"], fw[0])
        for mode in (2, 1):
            q = mode == 2
            args = (m, c, u, mask_f, cfg_t.fmt_att[0], cfg_t.fmt_bin,
                    fmt_act, q, q)
            got = ar.fused_read(*args)
            want = ar.fused_read_reference(*args)
            torch.cuda.synchronize()
            diffs = {k: float((a - b).abs().max())
                     for k, a, b in zip(("o", "p", "scores"), got, want)}
            o_pad = float_quant(torch.zeros_like(got[0][-3:]), fmt_act) \
                if q else torch.zeros_like(got[0][-3:])
            sound = (all(bool(torch.isfinite(t).all()) for t in got)
                     and bool((got[1][-3:] == 0).all())
                     and torch.equal(got[0][-3:], o_pad))
            flips = 0
            if q:
                flipped = (float_quant(got[1], fmt_act)
                           != float_quant(want[1], fmt_act)).any(-1)
                flips = int(flipped.sum())
                good = (torch.equal(got[2], want[2]) and diffs["p"] <= 1e-6
                        and torch.equal(got[0][~flipped], want[0][~flipped])
                        and flips <= 1)
            else:
                good = all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                           for a, b in zip(got, want))
            ar_err = max(ar_err, *diffs.values())
            print(f"[6 train-kernels] attention_read {name} mode {mode}: "
                  f"B={B} M={M} D={cfg_t.dim_emb}: max|diff| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
                  + f"; flipped Q(p, act) queries {flips}; padded samples "
                  f"p=0, o=Q(0), finite: {sound}", flush=True)
            if not (good and sound):
                fail(f"attention_read kernel disagrees with its plain version "
                     f"({name}, mode {mode})")
        if name != "wide":
            qmv_args[name] = (params["A"], rows, fw[0], fw[0])
            read_args[name] = (m, c, u, mask_f, cfg_t.fmt_att[0],
                               cfg_t.fmt_bin, fmt_act)

    # 7. the training path: train_task on cuda:0, kernel route and plain
    data = synthetic_task(np.random.default_rng(SEED), 1000, 100, 100,
                          19, 10, 6)
    cfg7 = QmannConfig(use_pallas=True, num_itr=2, verbose=False)
    cfg7_plain = cfg7.replace(use_pallas=False)
    n_batches = math.ceil(len(data.train) / cfg7.size_batch)
    n_calls = (cfg7.num_itr * n_batches
               + cfg7.num_itr * math.ceil(len(data.valid) / EVAL_CHUNK)
               + math.ceil(len(data.test) / EVAL_CHUNK))
    qmv.quantized_matvec.launches = 0
    ar.fused_read.launches = 0
    res_k = train_task(cfg7, data, device=dev)
    qmv_launches = qmv.quantized_matvec.launches
    ar_launches = ar.fused_read.launches
    res_p = train_task(cfg7_plain, data, device=dev)
    finite = True
    for route, res in (("kernel", res_k), ("plain", res_p)):
        for e, h in enumerate(res.history):
            print(f"[7 train] {route} route epoch {e}: cost_train "
                  f"{h.cost_train:.6f}, err_train {h.err_train:.4f}, "
                  f"cost_valid {h.cost_valid:.6f}, err_valid "
                  f"{h.err_valid:.4f}, lr {h.lr}", flush=True)
            finite &= math.isfinite(h.cost_train) and math.isfinite(
                h.cost_valid)
        finite &= math.isfinite(res.cost_test)
        print(f"[7 train] {route} route: test cost {res.cost_test:.6f}, "
              f"err {res.err_test:.4f}; {res.time_train:.3f} s for "
              f"{cfg7.num_itr} epochs", flush=True)
    print(f"[7 train] {n_calls} forwards ({cfg7.num_itr * n_batches} steps "
          f"+ {n_calls - cfg7.num_itr * n_batches} eval chunks): qmatvec "
          f"launches {qmv_launches} (want {10 * n_calls}), attention_read "
          f"launches {ar_launches} (want {3 * n_calls})", flush=True)
    if qmv_launches != 10 * n_calls or ar_launches != 3 * n_calls:
        fail("the training path did not launch each kernel as expected")
    if not finite:
        fail("a training or evaluation cost is not finite")

    batches_np = _batched_arrays(data.train, cfg7.size_batch)
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg7, data.dims, torch.Generator().manual_seed(SEED),
        device=dev).items()}
    lr_t = torch.tensor(cfg7.learning_rate, dtype=torch.float32, device=dev)
    for label, i in (("full batch", 0), ("partial batch", n_batches - 1)):
        batch = {k: torch.as_tensor(v[i]).to(dev)
                 for k, v in batches_np.items()}
        after = []
        for route_cfg in (cfg7, cfg7_plain):
            stepped = {k: v.clone() for k, v in base.items()}
            train_step(stepped, batch, lr_t, route_cfg)
            after.append(stepped)
        diff = max(float((after[0][k] - after[1][k]).abs().max())
                   for k in base)
        moved = max(float((after[0][k] - base[k]).abs().max()) for k in base)
        close = all(torch.allclose(after[0][k], after[1][k], rtol=1e-5,
                                   atol=1e-6) for k in base)
        print(f"[7 train] one SGD step, {label} "
              f"({int(batch['size_b'])} live samples, weights x4): max "
              f"|kernel route - plain route| {diff:.3g}, largest update "
              f"{moved:.3g}", flush=True)
        if not close:
            fail(f"one SGD step differs between the routes ({label})")

    # 8. training times at B=32, and each kernel alone
    batch0 = {k: torch.as_tensor(v[0]).to(dev) for k, v in batches_np.items()}
    p_k = {k: v.clone() for k, v in base.items()}
    p_p = {k: v.clone() for k, v in base.items()}
    steps = {"kernel route": lambda: train_step(p_k, batch0, lr_t, cfg7),
             "plain route": lambda: train_step(p_p, batch0, lr_t,
                                               cfg7_plain)}
    t_steps = {name: cuda_ms(fn) for name, fn in steps.items()}
    busy_steps = {name: device_ms(fn) for name, fn in steps.items()}
    print(f"[8 train-times] {card} | train step B={TRAIN_BATCH}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t_steps.items()),
          flush=True)
    # the step's parts: forward (with the autograd graph), forward +
    # backward, and the in-place update
    for name, route_cfg in (("kernel route", cfg7), ("plain route",
                                                     cfg7_plain)):
        leaves = {k: v.clone().requires_grad_() for k, v in base.items()}
        args = (batch0["memory"], batch0["question"], batch0["answer"],
                batch0["mask"], batch0["sample_mask"], route_cfg)

        def fwd():
            return memn2n.loss_and_metrics(leaves, *args)[0]

        def fwd_bwd():
            return torch.autograd.grad(fwd(), list(leaves.values()))

        grads = dict(zip(leaves, fwd_bwd()))
        upd_params = {k: v.clone() for k, v in base.items()}

        def update():
            sgd_update(upd_params, grads, lr_t, batch0["size_b"], route_cfg)
            zero_null_columns(upd_params, route_cfg)

        parts = {"forward": cuda_ms(fwd), "forward+backward": cuda_ms(fwd_bwd),
                 "update": cuda_ms(update)}
        print(f"[8 train-times] step parts, {name}: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items()),
              flush=True)
    for name, kernels in busy_steps.items():
        total = sum(ms for ms, _ in kernels.values())
        n_launch = sum(n for _, n in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:4]
        print(f"[8 device] train step, {name}: "
              + (f"busy {total:.4f} ms/step over {n_launch:.0f} launches of "
                 f"{len(kernels)} kernels, idle share "
                 f"{1.0 - total / t_steps[name]:.3f}; top "
                 + "; ".join(f"{k[:48]} {v:.4f} ({n:.0f}x)"
                             for k, (v, n) in top)
                 if kernels else
                 "not measured (profiler saw no device time)"), flush=True)
    k_times = {}
    with torch.inference_mode():
        for shape, a in qmv_args.items():
            k_times["qmatvec", shape] = (
                lambda a=a: qmv.quantized_matvec(*a),
                lambda a=a: qmv.quantized_matvec_reference(*a))
        for shape, a in read_args.items():
            k_times["attention_read", shape] = (
                lambda a=a: ar.fused_read(*a),
                lambda a=a: ar.fused_read_reference(*a))
        for key, (kernel_fn, plain_fn) in k_times.items():
            # event times of the wrapper (host issue included) and the
            # profiler's device time of the kernel itself
            busy = device_ms(kernel_fn)
            k_times[key] = (cuda_ms(kernel_fn), cuda_ms(plain_fn),
                            max((ms for ms, _ in busy.values()),
                                default=float("nan")))
    for (kname, shape), (t_k, t_p, t_dev) in k_times.items():
        print(f"[8 train-times] {kname} alone, {shape} shape (B="
              f"{TRAIN_BATCH if shape == 'train' else EVAL_CHUNK}): kernel "
              f"{t_k:.4f} ms (device {t_dev:.4f} ms), plain {t_p:.4f} ms",
              flush=True)
    print("[8 library] no single PyTorch call computes qmatvec, the "
          "attention read or the chain: each product is requantized before "
          "the sum, so library_ms is null", flush=True)

    b_chain = chain_bound(*chain_args[:4])
    b_qmv = qmatvec_bound(*qmv_args["train"][:2])
    b_read = attention_read_bound(*read_args["train"][:4])
    print(json.dumps({"kernels": [
        {"name": "hop_chain", "route": "cuda",
         "source": "qmann_tpu_torch/csrc/hop_chain.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:358",
         "launches": launches, "max_abs_err": max_err,
         "ms": t_kern, "plain_ms": t_ref, "bound_ms": b_chain[0],
         "bound_by": b_chain[1], "library_ms": None},
        {"name": "qmatvec", "route": "cuda",
         "source": "qmann_tpu_torch/csrc/qmatvec.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:88",
         "launches": qmv_launches, "max_abs_err": qmv_err,
         "ms": k_times["qmatvec", "train"][0],
         "plain_ms": k_times["qmatvec", "train"][1],
         "bound_ms": b_qmv[0], "bound_by": b_qmv[1], "library_ms": None},
        {"name": "attention_read", "route": "cuda",
         "source": "qmann_tpu_torch/csrc/attention_read.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:435",
         "launches": ar_launches, "max_abs_err": ar_err,
         "ms": k_times["attention_read", "train"][0],
         "plain_ms": k_times["attention_read", "train"][1],
         "bound_ms": b_read[0], "bound_by": b_read[1], "library_ms": None},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
