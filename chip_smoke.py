#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths once on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero:
  1. device  — a CUDA device is required (no CPU fallback); prints
               nvidia-smi's name and power limit
  2. build   — compiles the four kernels from qmann_tpu_torch/csrc, one
               nvcc per source, all started together
  3. kernel  — the hop-chain kernel against its plain PyTorch version, both
               on the card, at the flagship shape (B=1000, M=10, I=29, D=60,
               K=3, EN_MQ formats) and the wide layout (M=50, I=114), at
               each of the four rounding modes (the kernel fixes the mode
               at compile time: one instance per mode); the launch on the
               Q(H) that prepare_inference caches (the serving path's,
               requant skipped) equals the launch on raw H bit for bit
  4. slice   — an InferenceEngine on cuda:0 answers ~100 synthetic
               qa1-shaped requests over several waves; every answer equals
               the plain route's, and the chain kernel must have launched
  5. times   — forward_prepared on 1000-query batches, kernel route and
               plain route, and the kernel alone against the plain chain:
               the serving path's launch on the cached Q(H), which the
               kernels line reports, and the launch on raw H (CUDA events,
               median of 7 samples; the profiler's device time)
  6. train-kernels — the qmatvec and attention-read kernels against their
               plain versions on the card, at the flagship training shape
               (B=32, M=10, I=29, D=60, EN_MQ formats; the 2K embeddings
               take B*M rows), the eval chunk (B=1024) and the wide layout
               (M=50, I=114); both at each of the four rounding modes (the
               kernels fix the mode at compile time), qmatvec with binary
               fmt_w and binary fmt_x too; the last samples of each batch
               have no live memory row, as the padded samples of a partial
               batch
  7. train   — train_task on cuda:0 (use_pallas=True) for 2 epochs on a
               synthetic_task of 1000/100/100 qa1-shaped stories
               (1000 = 31*32 + 8: a last partial batch); 10 qmatvec and 3
               attention-read launches per training step and per eval
               chunk; every cost finite; one SGD step from the same weights
               on the kernel route and the plain route (a full batch and
               the partial one) agrees; prints both routes' histories
  8. train-times — one training step (forward + backward + SGD) at B=32 on
               each route, qmatvec and its plain version at B=32 and B=1024
               (the 10240-row eval chunk), the read and its plain version
               at B=32, B=1024 and the wide layout (CUDA events, median of
               7), and the profiler's device busy time and idle share of a
               step
Attention mode 3 (the Hamming attention):
  9. mode3-kernels — the Hamming score kernel against its plain version at
               B=32 and B=1024 (M=10, D=60) and the wide layout (M=50), at
               iwl 0/1/5/31 and each of the four rounding modes in its
               weighted, weight_para -1 and unweighted variants, on inputs
               that hold the encode's edge list, and its largest
               difference from the plain row sum at num_bit 20..32
               (printed, not gated: those sums may round); the read kernel
               in mode 3 at iwl 1 at the training, eval-chunk and wide
               shapes with padded samples, at each rounding mode; the
               chain kernel in mode 3 at iwl 5, B=1000, flagship and wide,
               at each of the four rounding modes
 10. mode3-serve — an engine at iwl 5 with use_fused_chain answers ~100
               requests through the chain kernel; an engine at iwl 1 with
               use_pallas leaves the exact route and runs 10 qmatvec and 3
               mode-3 read launches per wave; both give the plain route's
               answers
 11. mode3-train — train_task at iwl 1, mode 3, use_pallas=True for 2 epochs
               on the same synthetic_task (10 qmatvec and 3 read launches
               per step and eval chunk, costs finite); one SGD step equal
               across the kernel and plain routes (a full and the partial
               batch), a non-zero gradient on A; one step under
               use_pallas_hamming launches the Hamming kernel 3 times and
               equals the plain step
 12. mode3-times — the Hamming kernel and the mode-3 read alone at B=32,
               B=1024 and the wide layout, the mode-3 chain at B=1000
               (cached Q(H) and raw H, as phase 5), forward_prepared at
               B=1000 on both routes and one train step on both routes
               (CUDA events, median of 7; the profiler's device time, busy
               time and idle share)
The lattice past its whole-row limit, and the command-line run:
 13. lattice — qmatvec tiled over I (O*I + I > 12288 floats) against its
               plain version, bit for bit, at the joint block's memory
               embedding (O=60, I = 192 + 64 = 256; 32*64 and 1024*64 rows)
               and at I=1024 (32*64 rows), at each rounding mode and with
               binary fmt_w and binary fmt_x; its device and event times
               and bounds beside the 320- and 10240-row times of phase 8
 14. cli     — seeded qa1-shaped stories written in the bAbI raw format
               (tasks 1-2 and qa_joint) and the parsed format (task 1);
               python -m qmann_tpu_torch's main() on cuda:0 at the flagship
               widths with --use-pallas: tasks 1-2 for 2 epochs (gates:
               result.csv and result_all.csv with one row per task, 10
               qmatvec and 3 read launches per step and eval chunk, every
               cost finite), its checkpoint reloaded with load_checkpoint
               and served by prepare_inference + forward_prepared through
               the chain kernel (predictions equal to the plain route's
               but in a query whose Q(p, act) flipped, at most one); the
               joint block (--joint --shuffle --dim-forced --max-dict-len
               192 --max-sen-len 64 --use-pallas, 1 epoch: dim_input 256,
               qmatvec launched at I=256, 10 + 3 launches per forward); mode
               3 at iwl 1 with --use-pallas-hamming (1 epoch, 3 Hamming
               launches per forward); bench/qps.py --synthetic (one JSON
               line, four positive numbers); verify_kernels() on the card
               (every entry passes)
The model features (on the unfused hop, as JAX's envelope routes them):
 15. features — at the flagship widths on the same synthetic_task, on
               cuda:0: train_task with linear start (2 epochs without the
               softmax, then 1; gates: 10 lattice and 0 read launches per
               step in the first two, 10 + 3 in the third, costs finite,
               one step without the softmax equal across the routes on a
               full and the partial batch); each feature head (EN_SC_ATT,
               the shift-based and exp_plan softmax, cosine similarity,
               maxout, the score shift and clip) at mode 2 iwl 5: one step
               equal across the routes (full and partial batch), 10
               lattice launches per step and nothing else, every value
               finite; mode 3 iwl 1 with EN_SC_ATT: one epoch at 10 lattice
               + 3 Hamming launches per forward and no read, one step
               equal across the routes; an engine with EN_SC_ATT,
               use_pallas and use_fused_chain answers ~100 requests with
               the plain route's answers, 3 lattice launches per wave (the
               lin maps) and no chain launch.  Each path's step is timed
               on the kernel route (event time, busy time, launches,
               idle share; findings, not gates)
Then one JSON line of kernels (the read's and the Hamming kernel's with
their eval-chunk and wide entries, qmatvec's with its tiled shapes, each
with its launches on phase 15's paths), the card's name and power limit,
and as the last line
{"ok": true, "device": {...}}.

Tolerances.  Chain (as tests/test_torch_chain.py) and mode-2 attention
read: the scores bit-identical (hop 0's, for the chain); p within atol 1e-6
(exp and the softmax sum differ by an ulp between implementations); at
most 1 query per comparison in which a Q(p, act) requant flipped, every
other query bit-identical.  qmatvec: bit-identical (every lattice sum is
exact).  Mode-1 attention read: rtol 1e-5, atol 1e-6 (float sums in
another order).  SGD step: parameters within rtol 1e-5, atol 1e-6.
Hamming score kernel: bit-identical (integer work, and row sums exact at
num_bit <= 19).  Mode-3 read and chain: as mode 2.

bound_ms is the larger of the bytes the call must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (float32 outside the tensor cores; H100 SXM data sheet at
700 W), counting 4 operations per float_quant (scale, convert, rescale,
saturate), 1 per multiply or add and 4 per softmax element.  The Hamming
score's integer work is the least the function needs: one encode of 6
operations per element of m and per element of u (once per query); per
element pair the preprocess of 8, the match of 3 (the match word read as a
fixed-point fraction up to num_bit 25; above that the word would round, so
3 per compared bit), 4 for the sign, the scale and the row sum, and the
term's requant; counted against the int32 rate, half the float32 rate (an
SM has half as many int32 lanes as float32 lanes): 33.5 TOP/s.
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
INT32_OPS_PER_S = F32_OPS_PER_S / 2
Q_OPS = 4     # operations counted per float_quant
HAM_IWLS = (0, 1, 5, 31)
HAM_VARIANTS = ((0, True), (-1, True), (0, False))   # weight_para, weighted
HAM_WORD_MAX_BIT = 25   # the match word is exact as a fraction up to here
ROUND_MODES = (3, 0, 1, 2)   # the config's default (truncation) first
CLI_STORIES = (1000, 200)    # per task: train file (10% valid), test file


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


def _bound(nbytes, nops, int_ops=0):
    """(least ms, what bounds it) for a call moving nbytes and doing nops
    float and int_ops integer operations (the two pipes may overlap)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(nops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
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


def ham_score_ops(B, M, D, num_bit):
    """Integer operations of one Hamming score (module docstring): the
    encodes of m and u; per element pair the preprocess, the match, the
    sign, the scale, the sum and the term's requant; the row sums'
    requant."""
    match = 3 if num_bit <= HAM_WORD_MAX_BIT else 3 * (num_bit - 1)
    pair = 8 + match + 4 + Q_OPS
    return 6 * B * D * (M + 1) + B * M * (D * pair + Q_OPS)


def hamming_bound(m, u, num_bit):
    B, M, D = m.shape
    return _bound(_nbytes(m, u) + 4 * B * M, 0,
                  ham_score_ops(B, M, D, num_bit))


def _read_ops(B, M, D, num_bit=None):
    """(float, integer) operations of one attention read: the score (mode
    2, num_bit None: quantize m and u, the lattice and its requant; mode 3:
    the Hamming score on the raw m and u); the softmax and Q(p); Q(c), the
    weighted-sum lattice and the output requant."""
    wsum = (Q_OPS * B * M * D + B * M * (Q_OPS + 4)
            + B * M * D * (2 + Q_OPS) + B * D * Q_OPS)
    if num_bit is None:
        return (Q_OPS * (B * M * D + B * D) + B * M * D * (2 + Q_OPS)
                + B * M * Q_OPS + wsum, 0)
    return wsum, ham_score_ops(B, M, D, num_bit)


def attention_read_bound(m, c, u, mask, num_bit=None):
    B, M, D = m.shape
    return _bound(_nbytes(m, c, u, mask) + 4 * (B * D + 2 * B * M),
                  *_read_ops(B, M, D, num_bit))


def chain_bound(flat, u, hmats, mask, num_bit=None):
    """Per hop: the requant of the hop's A and C slices, one read, the lin
    map lattice (Q(H) once) and the residual (3 requants per element)."""
    B, M, _ = flat.shape
    K, D = hmats.shape[0], u.shape[1]
    read_f, read_i = _read_ops(B, M, D, num_bit)
    per_hop = (Q_OPS * 2 * B * M * D + read_f
               + Q_OPS * D * D + B * D * D * (2 + Q_OPS) + 3 * Q_OPS * B * D)
    return _bound(_nbytes(flat, u, hmats, mask) + 4 * (B * D + 2 * K * B * M),
                  K * per_hop, K * read_i)


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
    for _ in range(3):   # the profiler now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_iter):
                fn()
            torch.cuda.synchronize()
        # only the device-side kernel events: an aten op also reports its
        # kernels' time as its own self device time
        kernels = {ev.key: (ev.self_device_time_total / n_iter / 1000.0,
                            ev.count / n_iter)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0}
        if kernels:
            break
    return kernels


def per_launch_ms(kernels):
    """device_ms's result for a call that launches one kernel once -> the
    kernel's device time per launch: its time over its records.  Late in
    a long process the profiler keeps only some records (0.55 per call
    in phase 13 of PR 6's runs), so a division by the calls under-reads."""
    return max((ms / n for ms, n in kernels.values() if n > 0),
               default=float("nan"))


def ham_inputs(rng, iwl, B, M, D):
    """Gaussian m [B, M, D], u [B, D] across the range of (iwl, 31-iwl);
    sample 0 pairs the encode's edge list (0, -0.0, +-2^iwl, the next
    float above it, +-1e30, a value whose low half carries under ROUND_UP,
    tiny values) with its negation, shifted by one place per memory row."""
    import numpy as np
    m = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, M, D)).astype(np.float32)
    u = rng.normal(0.0, 0.6 * 2.0 ** iwl, (B, D)).astype(np.float32)
    top = np.float32(2.0 ** iwl)
    above = np.nextafter(top, np.float32(np.inf))
    carry = np.float32(65535.5 * 2.0 ** -(31 - iwl))
    edge = np.array([0.0, -0.0, top, -top, above, -above, 1e30, -1e30,
                     carry, -carry, 1e-7, -3e-9], np.float32)[:D]
    for r in range(min(M, len(edge))):
        m[0, r, :len(edge)] = np.roll(edge, r)
    u[0, :len(edge)] = -edge
    return m, u


def read_inputs(rng, cfg, B, V, M, W, dev):
    """The read's inputs as the training forward makes them, from synthetic
    qa1-shaped stories and seeded weights x4; the last 3 samples have no
    live row, as padded samples.  Returns (dims, params, memory, question,
    mask, (m, c, u))."""
    import torch
    from qmann_tpu_torch.data import synthetic_batch
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.qlinear import qembed_mat_forward, qmatvec_forward
    dims, mem, que, mask = synthetic_batch(rng, B, V, M, W)
    for a in (mem, que, mask):
        a[-3:] = 0
    params = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg, dims, torch.Generator().manual_seed(SEED), device=dev).items()}
    mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                            for a in (mem, que, mask))
    f0 = cfg.fmt_w[0]
    u = qmatvec_forward(params["B"], que_t, f0, f0)
    m = qembed_mat_forward(mem_t, params["A"], f0)
    c = qembed_mat_forward(mem_t, params["C"], f0)
    return dims, params, mem_t, que_t, mask_t, (m, c, u)


def check_read(got, want, fmt_act, quantized):
    """The read's tolerances (module docstring) and the padded samples'
    soundness (the last 3 have no live row: p = 0, o = Q(0), finite).
    Returns (max |diff| per output, flipped queries, good, sound)."""
    import torch
    from qmann_tpu_torch.numerics import float_quant
    diffs = {k: float((a - b).abs().max())
             for k, a, b in zip(("o", "p", "scores"), got, want)}
    o_pad = float_quant(torch.zeros_like(got[0][-3:]), fmt_act) \
        if quantized else torch.zeros_like(got[0][-3:])
    sound = (all(bool(torch.isfinite(t).all()) for t in got)
             and bool((got[1][-3:] == 0).all())
             and torch.equal(got[0][-3:], o_pad))
    if not quantized:
        return diffs, 0, all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
                             for a, b in zip(got, want)), sound
    flipped = (float_quant(got[1], fmt_act)
               != float_quant(want[1], fmt_act)).any(-1)
    good = (torch.equal(got[2], want[2]) and diffs["p"] <= 1e-6
            and torch.equal(got[0][~flipped], want[0][~flipped])
            and int(flipped.sum()) <= 1)
    return diffs, int(flipped.sum()), good, sound


def serve_requests(params, cfg, cfg_plain, dims, dictionary, stories, dev,
                   counters):
    """Answer `stories` with an engine on cfg on the card (the launch counts
    of `counters` set to 0 just before and read just after), and with
    cfg_plain's route wave by wave.  Returns (engine, answers, the plain
    route's answers, launches, whether every logit is finite and of the
    expected shape)."""
    import torch
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.serve import InferenceEngine, Request
    engine = InferenceEngine(params, cfg, dims, dictionary, batch_size=32,
                             device=dev)
    for fn in counters:
        fn.launches = 0
    engine.start()
    try:
        futures = [engine.submit(s, q) for s, q in stories]
        answers = [f.result(timeout=300) for f in futures]
    finally:
        engine.stop()
    launches = [fn.launches for fn in counters]
    plain = InferenceEngine(params, cfg_plain, dims, dictionary,
                            batch_size=32, device=dev)
    want, logits_ok = [], True
    for i in range(0, len(stories), 32):
        reqs = [Request(s, q) for s, q in stories[i:i + 32]]
        batch = plain._vectorize(reqs)
        want.extend(plain.infer(*batch)[:len(reqs)].tolist())
        out = memn2n.forward_prepared(
            engine.prepared, *(torch.from_numpy(a).to(dev) for a in batch),
            cfg)
        logits_ok &= (tuple(out.logits.shape) == (32, dims.dim_input)
                      and bool(torch.isfinite(out.logits).all()))
    return engine, answers, want, launches, logits_ok


def train_route(cfg, data, dev, tag, route):
    """train_task on the card; prints the history; returns the result and
    whether every cost is finite."""
    from qmann_tpu_torch.train import train_task
    res = train_task(cfg, data, device=dev)
    finite = math.isfinite(res.cost_test)
    for e, h in enumerate(res.history):
        print(f"[{tag}] {route} route epoch {e}: cost_train "
              f"{h.cost_train:.6f}, err_train {h.err_train:.4f}, "
              f"cost_valid {h.cost_valid:.6f}, err_valid "
              f"{h.err_valid:.4f}, lr {h.lr}", flush=True)
        finite &= math.isfinite(h.cost_train) and math.isfinite(h.cost_valid)
    print(f"[{tag}] {route} route: test cost {res.cost_test:.6f}, err "
          f"{res.err_test:.4f}; {res.time_train:.3f} s for "
          f"{len(res.history)} epochs", flush=True)
    return res, finite


def n_forwards(cfg, data):
    """Training steps and evaluation chunks of a train_task run."""
    steps = cfg.num_itr * math.ceil(len(data.train) / cfg.size_batch)
    chunks = (cfg.num_itr * math.ceil(len(data.valid) / EVAL_CHUNK)
              + math.ceil(len(data.test) / EVAL_CHUNK))
    return steps, chunks


def sgd_steps_agree(routes, base, batches_np, dev, tag,
                    remove_softmax=False):
    """One SGD step from `base` on a full batch and on the last (partial)
    one, on each route of `routes` (the first is the reference); fails
    unless they agree within rtol 1e-5, atol 1e-6, and unless every
    parameter and cost is finite."""
    import torch
    from qmann_tpu_torch.train import train_step
    lr_t = torch.tensor(routes[0].learning_rate, dtype=torch.float32,
                        device=dev)
    n_batches = batches_np["memory"].shape[0]
    for label, i in (("full batch", 0), ("partial batch", n_batches - 1)):
        batch = {k: torch.as_tensor(v[i]).to(dev)
                 for k, v in batches_np.items()}
        after = []
        for route_cfg in routes:
            stepped = {k: v.clone() for k, v in base.items()}
            cost, _ = train_step(stepped, batch, lr_t, route_cfg,
                                 remove_softmax)
            after.append(stepped)
            if not (bool(torch.isfinite(cost))
                    and all(bool(torch.isfinite(v).all())
                            for v in stepped.values())):
                fail(f"one SGD step gives a value that is not finite "
                     f"({tag}, {label})")
        for other in after[1:]:
            diff = max(float((other[k] - after[0][k]).abs().max())
                       for k in base)
            moved = max(float((other[k] - base[k]).abs().max())
                        for k in base)
            print(f"[{tag}] one SGD step, {label} ({int(batch['size_b'])} "
                  f"live samples, weights x4): max |difference between "
                  f"routes| {diff:.3g}, largest update {moved:.3g}",
                  flush=True)
            if not all(torch.allclose(other[k], after[0][k], rtol=1e-5,
                                      atol=1e-6) for k in base):
                fail(f"one SGD step differs between the routes ({tag}, "
                     f"{label})")


def time_steps(steps, tag, card=None):
    """Event time and device busy time per call of each step; prints the
    busy time, launches and idle share (the rest of the event time is the
    device waiting on the host), after the card's name and power limit
    when given.  Returns {name: event ms}."""
    t_steps = {name: cuda_ms(fn) for name, fn in steps.items()}
    busy = {name: device_ms(fn) for name, fn in steps.items()}
    for name, kernels in busy.items():
        total = sum(ms for ms, _ in kernels.values())
        n_launch = sum(n for _, n in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:4]
        dropped = any(abs(n - round(n)) > 1e-6 for _, n in kernels.values())
        print(f"[{tag}] {name}: " + (f"{card} | " if card else "")
              + f"event {t_steps[name]:.4f} ms (median of 7); "
              + ("the profiler dropped kernel records (a fractional count "
                 "per call): busy and idle share under- and over-read; "
                 if dropped else "")
              + (f"busy {total:.4f} ms over {n_launch:.0f} launches of "
                 f"{len(kernels)} kernels, idle share "
                 f"{1.0 - total / t_steps[name]:.3f}; top "
                 + "; ".join(f"{k[:48]} {v:.4f} ({n:.0f}x)"
                             for k, (v, n) in top)
                 if kernels else
                 "busy not measured (profiler saw no device time)"),
              flush=True)
    return t_steps


def time_kernels(pairs):
    """{key: (kernel fn, plain fn)} -> {key: (kernel event ms, plain event
    ms, kernel device ms)}: event times of the wrapper (its host-side
    launch cost included) and the profiler's device time of the kernel
    itself."""
    import torch
    out = {}
    with torch.inference_mode():
        for key, (kernel_fn, plain_fn) in pairs.items():
            out[key] = (cuda_ms(kernel_fn), cuda_ms(plain_fn),
                        per_launch_ms(device_ms(kernel_fn)))
    return out


class _Tee:
    """Collects what a call prints; echoes the lines that match `keep`."""

    def __init__(self, keep):
        self.keep, self.lines, self._part = keep, [], ""

    def write(self, text):
        self._part += text
        *done, self._part = self._part.split("\n")
        for line in done:
            self.lines.append(line)
            if self.keep.search(line):
                sys.__stdout__.write(f"    | {line}\n")
        return len(text)

    def flush(self):
        sys.__stdout__.flush()


def run_quiet(fn, argv, keep=r"ITR|err_test|Profile|^    \S+ +\d|Joint|Dim"):
    """fn(argv) with its output collected (the lines matching keep echoed,
    indented); returns (fn's result, the output's lines)."""
    import contextlib
    import re
    tee = _Tee(re.compile(keep))
    with contextlib.redirect_stdout(tee):
        rc = fn(argv)
    if tee._part:
        tee.write("\n")
    return rc, tee.lines


def cli_costs(lines):
    """(the number of epoch lines the CLI printed, whether each one's train
    and valid losses are finite)."""
    import re
    pat = re.compile(r"loss: ([^,]+), ([^,]+), ")
    costs = [float(v) for m in map(pat.search, lines) if m
             for v in m.groups()]
    return len(costs) // 2, all(map(math.isfinite, costs))


def csv_rows(path):
    """The task rows of a result CSV (after its header line)."""
    lines = Path(path).read_text().splitlines()
    head = max(i for i, ln in enumerate(lines)
               if ln.startswith("ind_data_set"))
    return [ln.split(",") for ln in lines[head + 1:]]


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
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv

    # 1. device
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)

    # 2. build: one nvcc per source, all started together
    kernel_mods = {"hop_chain": hop_chain, "qmatvec": qmv,
                   "attention_read": ar, "hamming": ham}
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

    def chain_inputs(cfg_c, V, M, W):
        """The chain's inputs as forward_prepared makes them at B=1000."""
        dims, mem, que, mask = synthetic_batch(rng, BATCH, V, M, W)
        scale, _, prep = scaled_prepared(cfg_c, dims, mem, dev)
        mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                for a in (mem, que, mask))
        flat = exact_matmul(mem_t, prep.embed_wt)
        u = float_quant(exact_matmul(que_t, prep.query_wt), cfg_c.fmt_w[0])
        return scale, (flat, u, prep.hmats, mask_t, cfg_c.fmt_w,
                       cfg_c.fmt_att, cfg_c.fmt_bin, cfg_c.fmt_act), prep

    def cached_launch(args, prep, **kw):
        """The serving path's launch: on Q(H) cached by prepare_inference,
        with the kernel's requant skipped."""
        return lambda: hop_chain.fused_hop_chain(
            args[0], args[1], prep.hmats_q, *args[3:], hmats_quantized=True,
            **kw)

    def cached_equal(args, prep, got, **kw):
        """The cached launch equals the launch on raw H."""
        cached = cached_launch(args, prep, **kw)()
        return all(torch.equal(a, b) for a, b in zip(cached, got))

    def time_chain(args, prep, **kw):
        """{"cached": the serving launch, "raw H": the launch on raw H}:
        (kernel event ms, plain event ms, kernel device ms) each."""
        return time_kernels({
            "cached": (cached_launch(args, prep, **kw),
                       lambda: hop_chain.fused_hop_chain_reference(*args,
                                                                   **kw)),
            "raw H": (lambda: hop_chain.fused_hop_chain(*args, **kw),
                      lambda: hop_chain.fused_hop_chain_reference(*args,
                                                                  **kw))})

    max_err, chain_args, chain_prep = 0.0, None, None
    for round_mode in ROUND_MODES:
        cfg_r = cfg.replace(quant_mode=round_mode)
        for name, (V, M, W) in shapes.items():
            scale, args, prep = chain_inputs(cfg_r, V, M, W)
            got = hop_chain.fused_hop_chain(*args)
            want = hop_chain.fused_hop_chain_reference(*args)
            torch.cuda.synchronize()
            diffs, flips, good = compare_chain(cfg_r, got, want)
            good &= cached_equal(args, prep, got)
            print(f"[3 kernel] {name} round {round_mode} B={BATCH} M={M} "
                  f"I={V + M} D={cfg.dim_emb} K={cfg.num_hops} weights "
                  f"x{scale}: max|diff| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
                  + f"; queries with a flipped Q(p, act): {flips}",
                  flush=True)
            if not good:
                fail(f"chain kernel disagrees with the plain version ({name}, "
                     f"round {round_mode})")
            max_err = max(max_err, *diffs.values())
            if name == "flagship" and round_mode == cfg.quant_mode:
                chain_args, chain_prep = args, prep

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
    serve_dims = dims
    scale, params, _ = scaled_prepared(cfg, dims, mem0, dev)
    engine, answers, want, (launches,), logits_ok = serve_requests(
        params, cfg, cfg.replace(use_fused_chain=False), dims, dictionary,
        stories, dev, [hop_chain.fused_hop_chain])
    stats = engine.stats
    if not engine.prepared.fast:
        fail("the engine's prepared forward left the exact route")
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
    print(f"[5 times] {card} | forward_prepared B={BATCH}", flush=True)
    with torch.inference_mode():
        time_steps({"kernel route": lambda: memn2n.forward_prepared(
                        prep_k, *batch, cfg),
                    "plain route": lambda: memn2n.forward_prepared(
                        prep_k, *batch, cfg_plain)}, "5 times")
    t_chain = time_chain(chain_args, chain_prep)
    for launch, (t_k, t_p, t_dev) in t_chain.items():
        print(f"[5 times] chain alone, {launch}: kernel {t_k:.4f} ms (device "
              f"{t_dev:.4f} ms), plain {t_p:.4f} ms", flush=True)

    # 6. the training kernels against their plain versions, on the card
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.numerics import QFormat
    from qmann_tpu_torch.train import (sgd_update, train_step,
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
        dims, params, mem_t, que_t, mask_t, (m, c, u) = read_inputs(
            rng, cfg_t, B, V, M, W, dev)
        rows = mem_t.reshape(-1, dims.dim_input)
        cases = []
        for rm in ROUND_MODES:
            fr = cfg_t.replace(quant_mode=rm).fmt_w
            fb = cfg_t.replace(quant_mode=rm).fmt_bin
            cases += ([(f"query r{rm}", params["B"], que_t, fr[0], fr[0])]
                      + [(f"embed {w}{h} r{rm}", params[w], rows, fr[h], fr[h])
                         for w in "AC" for h in range(K)]
                      + [(f"linmap {h} r{rm}", params["H"], u, fr[h], fb)
                         for h in range(K)]
                      + [(f"binary w r{rm}", params["B"], que_t,
                          QFormat(0, 0, rm), fr[0]),
                         (f"binary x r{rm}", params["H"], u, fr[1],
                          QFormat(0, 0, rm))])
        unequal = []
        for label, w, x, f_w, f_x in cases:
            got = qmv.quantized_matvec(w, x, f_w, f_x)
            want = qmv.quantized_matvec_reference(w, x, f_w, f_x)
            qmv_err = max(qmv_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                unequal.append(label)
        torch.cuda.synchronize()
        print(f"[6 train-kernels] qmatvec {name}: {len(cases)} calls "
              f"(rounding modes {ROUND_MODES}, binary w and x), "
              f"B={B} ({rows.shape[0]} embedding rows), I={dims.dim_input}, "
              f"O={cfg_t.dim_emb}; not bit-identical: "
              f"{', '.join(unequal) or 'none'}", flush=True)
        if unequal:
            fail(f"qmatvec kernel differs from its plain version ({name})")

        mask_f = mask_t.to(torch.float32)
        for mode in (2, 1):
            q = mode == 2
            for rm in ROUND_MODES:
                cfg_r = cfg_t.replace(quant_mode=rm)
                fa = cfg_r.fmt_act[0]
                args = (m, c, u, mask_f, cfg_r.fmt_att[0], cfg_r.fmt_bin, fa,
                        q, q)
                got = ar.fused_read(*args)
                want = ar.fused_read_reference(*args)
                torch.cuda.synchronize()
                diffs, flips, good, sound = check_read(got, want, fa, q)
                ar_err = max(ar_err, *diffs.values())
                print(f"[6 train-kernels] attention_read {name} mode {mode} "
                      f"round {rm}: B={B} M={M} D={cfg_t.dim_emb}: max|diff| "
                      + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
                      + f"; flipped Q(p, act) queries {flips}; padded "
                      f"samples p=0, o=Q(0), finite: {sound}", flush=True)
                if not (good and sound):
                    fail(f"attention_read kernel disagrees with its plain "
                         f"version ({name}, mode {mode}, round {rm})")
        read_args[name] = (m, c, u, mask_f, cfg_t.fmt_att[0], cfg_t.fmt_bin,
                           fmt_act)
        if name != "wide":
            qmv_args[name] = (params["A"], rows, fw[0], fw[0])

    # 7. the training path: train_task on cuda:0, kernel route and plain
    data = synthetic_task(np.random.default_rng(SEED), 1000, 100, 100,
                          19, 10, 6)
    cfg7 = QmannConfig(use_pallas=True, num_itr=2, verbose=False)
    cfg7_plain = cfg7.replace(use_pallas=False)
    n_steps, n_chunks = n_forwards(cfg7, data)
    n_calls = n_steps + n_chunks
    qmv.quantized_matvec.launches = 0
    ar.fused_read.launches = 0
    _, finite = train_route(cfg7, data, dev, "7 train", "kernel")
    qmv_launches = qmv.quantized_matvec.launches
    ar_launches = ar.fused_read.launches
    _, finite_p = train_route(cfg7_plain, data, dev, "7 train", "plain")
    print(f"[7 train] {n_calls} forwards ({n_steps} steps + {n_chunks} eval "
          f"chunks): qmatvec launches {qmv_launches} (want {10 * n_calls}), "
          f"attention_read launches {ar_launches} (want {3 * n_calls})",
          flush=True)
    if qmv_launches != 10 * n_calls or ar_launches != 3 * n_calls:
        fail("the training path did not launch each kernel as expected")
    if not (finite and finite_p):
        fail("a training or evaluation cost is not finite")

    batches_np = _batched_arrays(data.train, cfg7.size_batch)
    base = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg7, data.dims, torch.Generator().manual_seed(SEED),
        device=dev).items()}
    sgd_steps_agree((cfg7_plain, cfg7), base, batches_np, dev, "7 train")

    # 8. training times at B=32, and each kernel alone
    lr_t = torch.tensor(cfg7.learning_rate, dtype=torch.float32, device=dev)
    batch0 = {k: torch.as_tensor(v[0]).to(dev) for k, v in batches_np.items()}

    def step_fns(cfg_k, cfg_p, base):
        p_k = {k: v.clone() for k, v in base.items()}
        p_p = {k: v.clone() for k, v in base.items()}
        return {"kernel route": lambda: train_step(p_k, batch0, lr_t, cfg_k),
                "plain route": lambda: train_step(p_p, batch0, lr_t, cfg_p)}

    print(f"[8 train-times] {card} | train step B={TRAIN_BATCH}", flush=True)
    time_steps(step_fns(cfg7, cfg7_plain, base), "8 train-times")
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
    k_times = time_kernels(
        {**{("qmatvec", shape): (lambda a=a: qmv.quantized_matvec(*a),
                                 lambda a=a: qmv.quantized_matvec_reference(
                                     *a))
            for shape, a in qmv_args.items()},
         **{("attention_read", shape): (
             lambda a=a: ar.fused_read(*a),
             lambda a=a: ar.fused_read_reference(*a))
            for shape, a in read_args.items()}})
    for (kname, shape), (t_k, t_p, t_dev) in k_times.items():
        print(f"[8 train-times] {kname} alone, {shape} shape (B="
              f"{EVAL_CHUNK if shape == 'eval' else TRAIN_BATCH}): kernel "
              f"{t_k:.4f} ms (device {t_dev:.4f} ms), plain {t_p:.4f} ms",
              flush=True)
    print("[8 library] no single PyTorch call computes qmatvec, the "
          "attention read or the chain: each product is requantized before "
          "the sum, so library_ms is null", flush=True)

    # 9. attention mode 3: the Hamming kernel, and the mode-3 branches of
    # the read and chain kernels, against their plain versions on the card
    ham_err, ham_args = 0.0, {}
    ham_shapes = {"train": (TRAIN_BATCH, 10, 60), "eval": (EVAL_CHUNK, 10, 60),
                  "wide": (TRAIN_BATCH, 50, 60)}
    for name, (B, M, D) in ham_shapes.items():
        unequal, n_cmp = [], 0
        for iwl in HAM_IWLS:
            m, u = (torch.from_numpy(a).to(dev)
                    for a in ham_inputs(rng, iwl, B, M, D))
            for round_mode in ROUND_MODES:
                for para, weighted in HAM_VARIANTS:
                    args = (m, u, iwl, 8, -3, round_mode, para, weighted)
                    got = ham.hamming_score_kernel(*args)
                    want = ham.hamming_score_reference(*args)
                    ham_err = max(ham_err, float((got - want).abs().max()))
                    n_cmp += 1
                    if not torch.equal(got, want):
                        unequal.append(f"iwl {iwl} round {round_mode} para "
                                       f"{para} weighted {weighted}")
        torch.cuda.synchronize()
        print(f"[9 mode3-kernels] hamming {name} B={B} M={M} D={D}: "
              f"{n_cmp} calls (iwl {HAM_IWLS}, edge list in sample 0); not "
              f"bit-identical: {', '.join(unequal) or 'none'}", flush=True)
        if unequal:
            fail(f"hamming kernel differs from its plain version ({name})")
    # from num_bit 20 on a weighted row sum may round, in another order than
    # the plain sum's: the largest difference, written down, not gated
    m, u = (torch.from_numpy(a).to(dev)
            for a in ham_inputs(rng, 1, TRAIN_BATCH, 10, 60))
    above = {nb: max(float((ham.hamming_score_kernel(m, u, 1, nb, -3, 3, para)
                            - ham.hamming_score_reference(
                                m, u, 1, nb, -3, 3, para)).abs().max())
                     for para in (0, -1))
             for nb in range(20, 33)}
    print("[9 mode3-kernels] hamming B=32 iwl 1, num_bit 20..32: max "
          "|kernel - plain| " + ", ".join(f"{nb}: {d:.3g}"
                                         for nb, d in above.items()),
          flush=True)

    cfg3 = QmannConfig(iwl=1, attention_mode=3, use_pallas=True,
                       verbose=False)
    fmt3 = cfg3.fmt_act[0]
    nb3 = cfg3.num_bits_attention
    ar3_err, read3_args = 0.0, {}
    for name, (B, V, M, W) in train_shapes.items():
        _, _, _, _, mask_t, (m, c, u) = read_inputs(rng, cfg3, B, V, M, W,
                                                    dev)
        for rm in ROUND_MODES:
            cfg_r = cfg3.replace(quant_mode=rm)
            fa = cfg_r.fmt_act[0]
            args = (m, c, u, mask_t.to(torch.float32), cfg_r.fmt_att[0],
                    cfg_r.fmt_bin, fa, False, True, 3, nb3)
            got = ar.fused_read(*args)
            want = ar.fused_read_reference(*args)
            torch.cuda.synchronize()
            diffs, flips, good, sound = check_read(got, want, fa, True)
            ar3_err = max(ar3_err, *diffs.values())
            print(f"[9 mode3-kernels] attention_read {name} mode 3 iwl 1 "
                  f"round {rm}: B={B} M={M} D={cfg3.dim_emb}: max|diff| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
                  + f"; flipped Q(p, act) queries {flips}; padded samples "
                  f"p=0, o=Q(0), finite: {sound}", flush=True)
            if not (good and sound):
                fail(f"attention_read kernel disagrees with its plain "
                     f"version ({name}, mode 3, round {rm})")
            if rm == cfg3.quant_mode:
                read3_args[name] = args
        ham_args[name] = (m, u, cfg3.fmt_att[0].iwl, nb3, -3,
                          cfg3.fmt_att[0].mode)

    cfg_c3 = QmannConfig(use_fused_chain=True, attention_mode=3)
    ham_kw = dict(attention_mode=3, ham_num_bit=cfg_c3.num_bits_attention)
    chain3_err, chain3_args, chain3_prep = 0.0, None, None
    for round_mode in ROUND_MODES:
        cfg_r = cfg_c3.replace(quant_mode=round_mode)
        for name, (V, M, W) in shapes.items():
            scale, args, prep = chain_inputs(cfg_r, V, M, W)
            got = hop_chain.fused_hop_chain(*args, **ham_kw)
            want = hop_chain.fused_hop_chain_reference(*args, **ham_kw)
            torch.cuda.synchronize()
            diffs, flips, good = compare_chain(cfg_r, got, want)
            good &= cached_equal(args, prep, got, **ham_kw)
            print(f"[9 mode3-kernels] chain {name} mode 3 iwl 5 round "
                  f"{round_mode} B={BATCH} M={M} I={V + M} weights x{scale}: "
                  "max|diff| "
                  + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
                  + f"; queries with a flipped Q(p, act): {flips}",
                  flush=True)
            if not good:
                fail(f"chain kernel disagrees with the plain version ({name}, "
                     f"mode 3, round {round_mode})")
            chain3_err = max(chain3_err, *diffs.values())
            if name == "flagship" and round_mode == cfg_c3.quant_mode:
                chain3_args, chain3_prep = args, prep

    # 10. mode-3 serving: the chain at iwl 5; the forward at iwl 1
    _, params_c3, _ = scaled_prepared(cfg_c3, serve_dims, mem0, dev)
    engine3, answers, want, (chain3_launches,), logits_ok = serve_requests(
        params_c3, cfg_c3, cfg_c3.replace(use_fused_chain=False), serve_dims,
        dictionary, stories, dev, [hop_chain.fused_hop_chain])
    st = engine3.stats
    print(f"[10 mode3-serve] iwl 5, use_fused_chain: {len(answers)} answers "
          f"over {st.waves} waves, failed_waves {st.failed_waves}, exact "
          f"route {engine3.prepared.fast}, chain launches {chain3_launches}, "
          f"distinct answers {len(set(answers))}, equal to plain route: "
          f"{answers == want}", flush=True)
    if (st.failed_waves or st.requests != len(stories)
            or not engine3.prepared.fast or chain3_launches < 1):
        fail("the mode-3 engine at iwl 5 failed waves, left the exact route "
             "or never launched the chain kernel")
    if answers != want or not logits_ok:
        fail("mode-3 engine answers (iwl 5) differ from the plain route")

    cfg_s1 = QmannConfig(iwl=1, attention_mode=3, use_pallas=True,
                         use_fused_chain=True, verbose=False)
    params_s1 = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg_s1, serve_dims, torch.Generator().manual_seed(SEED),
        device=dev).items()}
    engine1, answers, want, (l_qmv, l_ar), logits_ok = serve_requests(
        params_s1, cfg_s1, cfg_s1.replace(use_pallas=False), serve_dims,
        dictionary, stories, dev, [qmv.quantized_matvec, ar.fused_read])
    st = engine1.stats
    print(f"[10 mode3-serve] iwl 1, use_pallas: {len(answers)} answers over "
          f"{st.waves} waves, failed_waves {st.failed_waves}, exact route "
          f"{engine1.prepared.fast}, qmatvec launches {l_qmv} (want "
          f"{10 * st.waves}), attention_read launches {l_ar} (want "
          f"{3 * st.waves}), distinct answers {len(set(answers))}, equal to "
          f"plain route: {answers == want}", flush=True)
    if (st.failed_waves or st.requests != len(stories)
            or engine1.prepared.fast
            or (l_qmv, l_ar) != (10 * st.waves, 3 * st.waves)):
        fail("the mode-3 engine at iwl 1 failed waves, kept the exact route "
             "or did not launch each kernel per wave")
    if answers != want or not logits_ok:
        fail("mode-3 engine answers (iwl 1) differ from the plain route")

    # 11. mode-3 training at iwl 1 on the kernel route
    cfg11 = cfg3.replace(num_itr=2)
    cfg11_plain = cfg11.replace(use_pallas=False)
    qmv.quantized_matvec.launches = 0
    ar.fused_read.launches = 0
    _, finite = train_route(cfg11, data, dev, "11 mode3-train", "kernel")
    qmv3_launches = qmv.quantized_matvec.launches
    ar3_launches = ar.fused_read.launches
    print(f"[11 mode3-train] {n_calls} forwards: qmatvec launches "
          f"{qmv3_launches} (want {10 * n_calls}), attention_read launches "
          f"{ar3_launches} (want {3 * n_calls})", flush=True)
    if qmv3_launches != 10 * n_calls or ar3_launches != 3 * n_calls:
        fail("mode-3 training did not launch each kernel as expected")
    if not finite:
        fail("a mode-3 training or evaluation cost is not finite")
    base3 = {k: 4.0 * v for k, v in memn2n.init_params(
        cfg11, data.dims, torch.Generator().manual_seed(SEED),
        device=dev).items()}
    cfg11_ham = cfg11_plain.replace(use_pallas_hamming=True)
    sgd_steps_agree((cfg11_plain, cfg11), base3, batches_np, dev,
                    "11 mode3-train")
    leaves = {k: v.clone().requires_grad_() for k, v in base3.items()}
    loss, _ = memn2n.loss_and_metrics(
        leaves, batch0["memory"], batch0["question"], batch0["answer"],
        batch0["mask"], batch0["sample_mask"], cfg11)
    g_a = torch.autograd.grad(loss, [leaves["A"]])[0]
    print(f"[11 mode3-train] kernel route: max |d loss / d A| "
          f"{float(g_a.abs().max()):.6g} (A is reached only through the "
          "Hamming surrogate)", flush=True)
    if not float(g_a.abs().max()) > 0:
        fail("mode-3 training gives A no gradient")
    ham.hamming_score_kernel.launches = 0
    sgd_steps_agree((cfg11_plain, cfg11_ham), base3, batches_np, dev,
                    "11 mode3-train use_pallas_hamming")
    ham_launches = ham.hamming_score_kernel.launches
    print(f"[11 mode3-train] use_pallas_hamming: Hamming kernel launches "
          f"{ham_launches} in 2 steps (want 6)", flush=True)
    if ham_launches != 6:
        fail("the use_pallas_hamming step did not launch the Hamming kernel "
             "3 times per step")

    # 12. mode-3 times
    prep_c3 = memn2n.prepare_inference(
        params_c3, cfg_c3, max_count=float(serve_dims.max_word + 1),
        max_rowsum=float(serve_dims.max_word + 1))
    cfg_c3_plain = cfg_c3.replace(use_fused_chain=False)
    with torch.inference_mode():
        fp3 = {"kernel route": lambda: memn2n.forward_prepared(
                   prep_c3, *batch, cfg_c3),
               "plain route": lambda: memn2n.forward_prepared(
                   prep_c3, *batch, cfg_c3_plain)}
        print(f"[12 mode3-times] {card} | forward_prepared B={BATCH}, mode 3 "
              "iwl 5", flush=True)
        time_steps(fp3, "12 mode3-times forward_prepared")
    print(f"[12 mode3-times] train step B={TRAIN_BATCH}, mode 3 iwl 1",
          flush=True)
    t3_steps = time_steps(step_fns(cfg11, cfg11_plain, base3),
                          "12 mode3-times train step")
    k3 = time_kernels(
        {**{("hamming", shape): (
            lambda a=a: ham.hamming_score_kernel(*a),
            lambda a=a: ham.hamming_score_reference(*a))
            for shape, a in ham_args.items()},
         **{("attention_read", shape): (
             lambda a=a: ar.fused_read(*a),
             lambda a=a: ar.fused_read_reference(*a))
            for shape, a in read3_args.items()}})
    k3.update({("hop_chain", launch): t for launch, t in time_chain(
        chain3_args, chain3_prep, **ham_kw).items()})
    for (kname, shape), (t_k, t_p, t_dev) in k3.items():
        print(f"[12 mode3-times] {kname} mode 3 alone, {shape}: kernel "
              f"{t_k:.4f} ms (device {t_dev:.4f} ms), plain {t_p:.4f} ms",
              flush=True)
    print("[12 library] no single PyTorch call computes the Hamming score "
          "(bit-level matches of sign-magnitude words): library_ms is null",
          flush=True)
    print(f"[12 mode3-times] train step event times: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t3_steps.items()),
          flush=True)


    # 13. the lattice past the whole-row limit (O*I + I > 12288 floats):
    # the kernel tiled over I, at the joint block's memory embedding (O=60,
    # I = 192 + 64 = 256; B*M = 32*64 training rows, 1024*64 in an eval
    # chunk) and at I=1024, bit for bit
    cfg_j = QmannConfig(use_pallas=True, verbose=False)
    tiled_shapes = {"joint_train": (TRAIN_BATCH, 192, 64, 7),
                    "joint_eval": (EVAL_CHUNK, 192, 64, 7),
                    "i1024": (TRAIN_BATCH, 960, 64, 7)}
    tiled_args, tiled_err = {}, 0.0
    for name, (B, V, M, W) in tiled_shapes.items():
        dims, mem, _, _ = synthetic_batch(rng, B, V, M, W)
        params = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg_j, dims, torch.Generator().manual_seed(SEED),
            device=dev).items()}
        rows = torch.from_numpy(mem).to(dev).reshape(-1, dims.dim_input)
        geo = qmv.qmatvec_geometry(rows.shape[0], cfg_j.dim_emb,
                                   dims.dim_input)
        unequal = []
        for rm in ROUND_MODES:
            f = cfg_j.replace(quant_mode=rm).fmt_w[0]
            for label, f_w, f_x in (("", f, f),
                                    ("binary w", QFormat(0, 0, rm), f),
                                    ("binary x", f, QFormat(0, 0, rm))):
                got = qmv.quantized_matvec(params["A"], rows, f_w, f_x)
                want = qmv.quantized_matvec_reference(params["A"], rows,
                                                      f_w, f_x)
                tiled_err = max(tiled_err, float((got - want).abs().max()))
                if not torch.equal(got, want):
                    unequal.append(f"round {rm} {label}".strip())
                del got, want
        torch.cuda.synchronize()
        print(f"[13 lattice] qmatvec {name}: {rows.shape[0]} rows, "
              f"I={dims.dim_input}, O={cfg_j.dim_emb}, tiles: "
              f"{geo.rows_per_block} rows x {geo.o_tile} outputs x I by "
              f"{geo.i_tile}, {geo.blocks} blocks; 12 calls (rounding modes {ROUND_MODES}, binary w "
              f"and x); not bit-identical: {', '.join(unequal) or 'none'}",
              flush=True)
        if unequal:
            fail(f"the tiled qmatvec differs from its plain version ({name})")
        if (geo.o_tile, geo.i_tile) == (cfg_j.dim_emb, dims.dim_input):
            fail(f"qmatvec {name} did not take the tiled kernel")
        tiled_args[name] = (params["A"], rows, cfg_j.fmt_w[0],
                            cfg_j.fmt_w[0])
    t_tiled = {}
    with torch.inference_mode():
        for name, a in tiled_args.items():
            big = name == "joint_eval"     # the plain lattice is 4 GB there
            busy = device_ms(lambda a=a: qmv.quantized_matvec(*a))
            t_tiled[name] = (
                cuda_ms(lambda a=a: qmv.quantized_matvec(*a)),
                cuda_ms(lambda a=a: qmv.quantized_matvec_reference(*a),
                        n_iter=2 if big else 20, samples=3 if big else 7),
                per_launch_ms(busy))
            print(f"[13 lattice] profiler records for {name}: "
                  + ", ".join(f"{k[:40]} {ms:.4f} ms per call, {n:.2f} "
                              "records per call" for k, (ms, n)
                              in busy.items()), flush=True)
    b_tiled = {name: qmatvec_bound(*a[:2]) for name, a in tiled_args.items()}
    print(f"[13 lattice] {card} | qmatvec device ms (event ms, bound ms): "
          + "; ".join(f"{label} {t[2]:.4f} ({t[0]:.4f}, {b[0]:.4f} {b[1]})"
                      for label, t, b in (
                          ("320 rows I=29", k_times["qmatvec", "train"],
                           qmatvec_bound(*qmv_args["train"][:2])),
                          ("10240 rows I=29", k_times["qmatvec", "eval"],
                           qmatvec_bound(*qmv_args["eval"][:2])),
                          *((f"{tiled_args[n][1].shape[0]} rows I="
                             f"{tiled_args[n][1].shape[1]}", t_tiled[n],
                             b_tiled[n]) for n in tiled_args)))
          + "; plain ms: " + ", ".join(f"{n} {t[1]:.4f}"
                                       for n, t in t_tiled.items()),
          flush=True)

    # 14. the command-line run: python -m qmann_tpu_torch's main() on
    # seeded qa1-shaped stories in the bAbI raw format (tasks 1-2 and
    # qa_joint) and the parsed format (task 1), at the flagship widths
    import tempfile
    from qmann_tpu_torch import cli
    from qmann_tpu_torch.bench import qps
    from qmann_tpu_torch.data import (DataDims, load_test_split,
                                      write_synthetic_corpus)
    from qmann_tpu_torch.ops.losses import argmax_last
    from qmann_tpu_torch.utils import load_checkpoint
    from qmann_tpu_torch.utils.verification import verify_kernels

    def forwards(epochs, n_file, n_test, extra_chunks=0):
        """Training steps and eval chunks of a CLI task run: the train
        file's last 10% is the validation split; the CLI's batch of 32."""
        n_va, batch = int(n_file * 0.1), QmannConfig().size_batch
        return (epochs * (math.ceil((n_file - n_va) / batch)
                          + math.ceil(n_va / EVAL_CHUNK))
                + math.ceil(n_test / EVAL_CHUNK) + extra_chunks)

    n_file, n_test = CLI_STORIES
    tmp = tempfile.TemporaryDirectory(prefix="qmann_cli_")
    root = Path(tmp.name)
    data_path, raw_path = write_synthetic_corpus(
        str(root), np.random.default_rng(SEED), [1, 2], n_file, n_test,
        parsed=[1])
    files = ["--data-path", data_path, "--raw-data-path", raw_path,
             "--device", str(dev)]
    out = root / "run"
    for fn in (qmv.quantized_matvec, ar.fused_read):
        fn.launches = 0
    t0 = time.perf_counter()
    rc, lines = run_quiet(cli.main, [
        "1", "1", "2", "5", "--epochs", "2", "--use-pallas",
        "--checkpoint-dir", str(out), "--out-dir", str(out), "--profile",
        *files])
    t_cli = time.perf_counter() - t0
    cli_qmv, cli_ar = qmv.quantized_matvec.launches, ar.fused_read.launches
    n_cli = 2 * forwards(2, n_file, n_test)
    n_epochs, finite = cli_costs(lines)
    rows = {n: csv_rows(out / n) for n in ("result.csv", "result_all.csv")}
    print(f"[14 cli] tasks 1-2, 2 epochs, use_pallas, flagship widths: rc "
          f"{rc}, {t_cli:.2f} s; result.csv tasks "
          f"{[r[0] for r in rows['result.csv']]}, result_all.csv tasks "
          f"{[r[0] for r in rows['result_all.csv']]}; {n_epochs} epoch "
          f"lines, every cost finite: {finite}; {n_cli} forwards: "
          f"qmatvec launches {cli_qmv} (want {10 * n_cli}), attention_read "
          f"launches {cli_ar} (want {3 * n_cli})", flush=True)
    if rc != 0 or any([r[0] for r in v] != ["1", "2"] for v in rows.values()):
        fail("the CLI run did not write one result row per task")
    if n_epochs != 4 or not finite:
        fail("a CLI training or validation cost is not finite")
    if (cli_qmv, cli_ar) != (10 * n_cli, 3 * n_cli):
        fail("the CLI run did not launch the training kernels per forward")

    # the checkpoint reloaded and served: the chain kernel against the
    # plain route on task 1's test split
    c_params, c_cfg, c_dims = load_checkpoint(
        str(out / "qa1_single-supporting-fact_loop0"))
    words = json.loads((out / "qa1_single-supporting-fact_loop0" /
                        "dictionary.json").read_text())
    c_dict = Dictionary()
    for w in words[1:]:
        c_dict.add(w)
    c_dims = DataDims(**c_dims)
    test = load_test_split("qa1_single-supporting-fact", data_path, c_dict,
                           c_dims, raw_path=raw_path)
    prep = memn2n.prepare_inference(
        memn2n.params_from_jax(c_params, c_cfg, device=dev), c_cfg,
        max_count=float(c_dims.max_word + 1),
        max_rowsum=float(c_dims.max_word + 1))
    batch_t = tuple(torch.from_numpy(a).to(dev) for a in (
        test.memory, test.question, test.mask))
    hop_chain.fused_hop_chain.launches = 0
    with torch.inference_mode():
        served = memn2n.forward_prepared(
            prep, *batch_t, c_cfg.replace(use_fused_chain=True))
        chain_served = hop_chain.fused_hop_chain.launches
        plain = memn2n.forward_prepared(
            prep, *batch_t, c_cfg.replace(use_fused_chain=False,
                                          use_pallas=False))
    flipped = torch.zeros(len(test), dtype=torch.bool, device=dev)
    for h, fmt in enumerate(c_cfg.fmt_act):
        flipped |= (float_quant(served.attention[h], fmt)
                    != float_quant(plain.attention[h], fmt)).any(-1)
    pred_s, pred_p = (argmax_last(o.logits) for o in (served, plain))
    same = bool(torch.equal(pred_s[~flipped], pred_p[~flipped]))
    print(f"[14 cli] checkpoint reloaded ({len(c_params)} weights, dims "
          f"{c_dims.dim_input}, exact route {prep.fast}); {len(test)} test "
          f"queries served: chain launches {chain_served}, predictions equal "
          f"to the plain route's: {same} (queries with a flipped Q(p, act): "
          f"{int(flipped.sum())}, prediction differences there "
          f"{int((pred_s != pred_p).sum())}), accuracy "
          f"{float((pred_s.cpu().numpy() == test.answer_index).mean()):.3f}",
          flush=True)
    if not prep.fast or chain_served < 1:
        fail("the reloaded checkpoint did not serve through the chain kernel")
    if not same or int(flipped.sum()) > 1:
        fail("the chain's predictions on the reloaded checkpoint differ from "
             "the plain route's")

    # the joint block: dim_input 192 + 64 = 256, the tiled lattice.  A spy
    # in the module's place records the lattice's I; the wrapper counts
    # its launches on whatever the module's name holds meanwhile (the spy),
    # so the launches are the two counts' sum
    seen_i = set()
    qmv_kernel = qmv.quantized_matvec

    def qmv_spy(w, x, fmt_w, fmt_x):
        seen_i.add(int(x.shape[-1]))
        return qmv_kernel(w, x, fmt_w, fmt_x)

    qmv_spy.launches = qmv_kernel.launches = 0
    ar.fused_read.launches = 0
    qmv.quantized_matvec = qmv_spy
    t0 = time.perf_counter()
    try:
        rc, lines = run_quiet(cli.main, [
            "1", "1", "2", "5", "--joint", "--shuffle", "--dim-forced",
            "--max-dict-len", "192", "--max-sen-len", "64", "--use-pallas",
            "--epochs", "1", "--checkpoint-dir", str(out / "joint"),
            "--out-dir", str(out / "joint"), *files])
    finally:
        qmv.quantized_matvec = qmv_kernel
    t_joint = time.perf_counter() - t0
    joint_qmv = qmv_spy.launches + qmv_kernel.launches
    joint_ar = ar.fused_read.launches
    _, _, j_dims = load_checkpoint(str(out / "joint" / "qa_joint_loop0"))
    n_joint = forwards(1, 2 * n_file, n_test, extra_chunks=2)
    j_epochs, j_finite = cli_costs(lines)
    j_finite &= j_epochs == 1
    print(f"[14 cli] joint block (--joint --shuffle --dim-forced "
          f"--max-dict-len 192 --max-sen-len 64 --use-pallas), 1 epoch: rc "
          f"{rc}, {t_joint:.2f} s; dim_input {j_dims['dim_input']}; qmatvec "
          f"at I = {sorted(seen_i)}, launches {joint_qmv} (want "
          f"{10 * n_joint}), attention_read launches {joint_ar} (want "
          f"{3 * n_joint}); costs finite: {j_finite}", flush=True)
    if rc != 0 or j_dims["dim_input"] != 256 or 256 not in seen_i:
        fail("the joint block did not train at dim_input 256")
    if (joint_qmv, joint_ar) != (10 * n_joint, 3 * n_joint):
        fail("the joint block did not launch the training kernels per "
             "forward")
    if not j_finite:
        fail("a joint-block cost is not finite")

    # attention mode 3 at iwl 1, the score through the Hamming kernel
    ham.hamming_score_kernel.launches = 0
    rc, lines = run_quiet(cli.main, [
        "1", "1", "1", "1", "--attention-mode", "3", "--use-pallas-hamming",
        "--epochs", "1", "--out-dir", str(out / "mode3"), *files])
    ham_cli = ham.hamming_score_kernel.launches
    n_m3 = forwards(1, n_file, n_test)
    m3_epochs, m3_finite = cli_costs(lines)
    m3_finite &= m3_epochs == 1
    print(f"[14 cli] mode 3, iwl 1, --use-pallas-hamming, 1 epoch: rc {rc}; "
          f"Hamming kernel launches {ham_cli} (want {3 * n_m3}); costs "
          f"finite: {m3_finite}", flush=True)
    if rc != 0 or ham_cli != 3 * n_m3:
        fail("the mode-3 CLI run did not launch the Hamming kernel per hop")
    if not m3_finite:
        fail("a mode-3 CLI cost is not finite")

    # the throughput tool
    rc, lines = run_quiet(qps.main, [
        "--synthetic", "--use-pallas", "--use-fused-chain", "--iters", "5",
        "--train-iters", "1", "--requests", "512", "--max-samples", "2000",
        "--device", str(dev)],
        keep=r"^\{")
    qps_line = next((json.loads(ln) for ln in reversed(lines)
                     if ln.startswith("{")), {})
    qps_keys = ("inference_qps", "serving_engine_qps",
                "train_samples_per_sec", "epoch_seconds")
    if rc != 0 or not all(qps_line.get(k, 0) > 0 for k in qps_keys):
        fail("bench/qps.py did not print its four positive numbers")

    # every hand kernel against its plain version, through the utility
    checks = verify_kernels(device=dev)
    for r in checks:
        print(f"[14 verify] {r}", flush=True)
    if not all(r.ok for r in checks):
        fail("verify_kernels found a kernel that disagrees with its plain "
             "version")
    tmp.cleanup()

    # 15. the model features on the unfused hop (JAX's envelope keeps
    # them out of the fused read and the chain): linear start, each
    # feature head, mode 3 with EN_SC_ATT, and an engine with EN_SC_ATT;
    # the lattice (and in mode 3 the Hamming kernel) carries them, the read
    # and the chain do not launch
    from qmann_tpu_torch.train import trainer as trainer_mod
    counters = {"qmatvec": qmv.quantized_matvec, "attention_read":
                ar.fused_read, "hamming_score": ham.hamming_score_kernel,
                "hop_chain": hop_chain.fused_hop_chain}

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def want_counts(qmatvec=0, attention_read=0, hamming_score=0):
        return {"qmatvec": qmatvec, "attention_read": attention_read,
                "hamming_score": hamming_score, "hop_chain": 0}

    def feature_base(cfg_f):
        return {k: 4.0 * v for k, v in memn2n.init_params(
            cfg_f, data.dims, torch.Generator().manual_seed(SEED),
            device=dev).items()}

    feature_launches = {}
    n_steps_epoch = math.ceil(len(data.train) / TRAIN_BATCH)
    cfg15 = QmannConfig(use_pallas=True, verbose=False)

    # (a) linear start: 2 epochs without the softmax, then 1 with it; a spy
    # in train_epoch's place reads the counts around each epoch
    cfg_ls = cfg15.replace(en_linear_start=True, num_itr_linear_start=2,
                           num_itr=1)
    per_epoch, epoch_real = [], trainer_mod.train_epoch

    def epoch_spy(params, batches, lr, cfg, remove_softmax=False):
        before = counts()
        out = epoch_real(params, batches, lr, cfg, remove_softmax)
        per_epoch.append((remove_softmax, {k: v - before[k]
                                           for k, v in counts().items()}))
        return out

    trainer_mod.train_epoch = epoch_spy
    zero_counts()
    try:
        _, finite = train_route(cfg_ls, data, dev, "15 features",
                                "linear start, kernel")
    finally:
        trainer_mod.train_epoch = epoch_real
    ls_total = counts()
    n_chunks_ls = (3 * math.ceil(len(data.valid) / EVAL_CHUNK)
                   + math.ceil(len(data.test) / EVAL_CHUNK))
    want_total = want_counts(
        qmatvec=10 * (3 * n_steps_epoch + n_chunks_ls),
        attention_read=3 * (n_steps_epoch + n_chunks_ls))
    print(f"[15 features] linear start: epochs (softmax removed, launches "
          f"per step) "
          + "; ".join(f"{rm}: " + ", ".join(
              f"{k} {v / n_steps_epoch:g}" for k, v in c.items())
              for rm, c in per_epoch)
          + f"; whole run {ls_total} (want {want_total})", flush=True)
    if [rm for rm, _ in per_epoch] != [True, True, False]:
        fail("linear start did not run 2 epochs without the softmax, then 1")
    for rm, c in per_epoch:
        want = want_counts(qmatvec=10 * n_steps_epoch, attention_read=(
            0 if rm else 3 * n_steps_epoch))
        if c != want:
            fail(f"a linear-start epoch (softmax removed: {rm}) launched "
                 f"{c}, want {want}")
    if ls_total != want_total or not finite:
        fail("the linear-start run launched other counts than expected or "
             "gave a cost that is not finite")
    feature_launches["linear_start"] = ls_total
    base_ls = feature_base(cfg_ls)
    zero_counts()
    sgd_steps_agree((cfg_ls.replace(use_pallas=False), cfg_ls), base_ls,
                    batches_np, dev, "15 features linear start",
                    remove_softmax=True)
    if counts() != want_counts(qmatvec=20):
        fail(f"the linear-start steps launched {counts()}, want 10 lattice "
             "launches per step and nothing else")

    # (b) each feature head, mode 2 iwl 5: one step on each route (a full
    # and the partial batch), 10 lattice launches per step, nothing else
    heads = {"sc_att": dict(en_sc_att=True),
             "shift_sm": dict(en_shift_based_sm=True),
             "exp_plan": dict(en_exp_table_based=True),
             "cosine": dict(en_cosine_sim=True),
             "maxout": dict(test_maxout=True),
             "att_shift": dict(en_att_shift=True),
             "att_clip": dict(en_att_clip=True)}
    step_cfgs = {"linear start": (cfg_ls, base_ls, True)}
    for name, kw in heads.items():
        cfg_f = cfg15.replace(**kw)
        base_f = feature_base(cfg_f)
        zero_counts()
        sgd_steps_agree((cfg_f.replace(use_pallas=False), cfg_f), base_f,
                        batches_np, dev, f"15 features {name}")
        got = counts()
        feature_launches[name] = got
        print(f"[15 features] {name}: launches in 2 kernel-route steps "
              f"{got}", flush=True)
        if got != want_counts(qmatvec=20):
            fail(f"the {name} steps launched {got}, want 10 lattice launches "
                 "per step and nothing else")
        step_cfgs[name] = (cfg_f, base_f, False)

    # (c) mode 3 at iwl 1 with EN_SC_ATT: one epoch, the score on the
    # Hamming kernel
    cfg_m3 = QmannConfig(iwl=1, attention_mode=3, use_pallas=True,
                         en_sc_att=True, num_itr=1, verbose=False)
    zero_counts()
    _, finite = train_route(cfg_m3, data, dev, "15 features",
                            "mode 3 sc_att, kernel")
    m3_steps, m3_chunks = n_forwards(cfg_m3, data)
    n_m3 = m3_steps + m3_chunks
    got = counts()
    feature_launches["mode3_sc_att"] = got
    want = want_counts(qmatvec=10 * n_m3, hamming_score=3 * n_m3)
    print(f"[15 features] mode 3 sc_att iwl 1: {n_m3} forwards, launches "
          f"{got} (want {want})", flush=True)
    if got != want or not finite:
        fail("the mode-3 EN_SC_ATT epoch launched other counts than "
             "expected or gave a cost that is not finite")
    base_m3 = feature_base(cfg_m3)
    sgd_steps_agree((cfg_m3.replace(use_pallas=False), cfg_m3), base_m3,
                    batches_np, dev, "15 features mode 3 sc_att")
    step_cfgs["mode 3 sc_att"] = (cfg_m3, base_m3, False)

    # (d) serving with EN_SC_ATT: the chain's envelope excludes it, the
    # embeddings take the exact GEMM and the lattice only the lin maps
    cfg_sv = QmannConfig(en_sc_att=True, use_pallas=True,
                         use_fused_chain=True)
    _, params_sv, _ = scaled_prepared(cfg_sv, serve_dims, mem0, dev)
    engine_sv, answers, want_sv, launched, logits_ok = serve_requests(
        params_sv, cfg_sv, cfg_sv.replace(use_pallas=False,
                                          use_fused_chain=False),
        serve_dims, dictionary, stories, dev, list(counters.values()))
    st = engine_sv.stats
    got = dict(zip(counters, launched))
    feature_launches["serve_sc_att"] = got
    want = want_counts(qmatvec=3 * st.waves)
    print(f"[15 features] engine, sc_att, use_pallas + use_fused_chain: "
          f"{len(answers)} answers over {st.waves} waves, failed_waves "
          f"{st.failed_waves}, exact route {engine_sv.prepared.fast}, "
          f"launches {got} (want {want}), equal to plain route: "
          f"{answers == want_sv}", flush=True)
    if (st.failed_waves or st.requests != len(stories)
            or not engine_sv.prepared.fast or got != want):
        fail("the EN_SC_ATT engine failed waves, left the exact route or "
             "launched other kernels than the lattice for its lin maps")
    if answers != want_sv or not logits_ok:
        fail("EN_SC_ATT engine answers differ from the plain route")

    # the step of each feature path, timed on the kernel route
    lr_t = torch.tensor(cfg15.learning_rate, dtype=torch.float32, device=dev)
    feature_steps = {}
    for name, (cfg_f, base_f, rm) in step_cfgs.items():
        p_f = {k: v.clone() for k, v in base_f.items()}
        feature_steps[name] = (lambda p=p_f, c=cfg_f, r=rm: train_step(
            p, batch0, lr_t, c, r))
    time_steps(feature_steps, "15 features step", card=card)

    b_chain = chain_bound(*chain_args[:4])
    b_chain3 = chain_bound(*chain3_args[:4], num_bit=cfg_c3.num_bits_attention)
    b_qmv = qmatvec_bound(*qmv_args["train"][:2])
    b_qmv_eval = qmatvec_bound(*qmv_args["eval"][:2])
    b_read = attention_read_bound(*read_args["train"][:4])
    b_read3 = attention_read_bound(*read3_args["train"][:4], num_bit=nb3)
    b_ham = hamming_bound(*ham_args["train"][:2], num_bit=nb3)

    def at_shapes(times, kname, args, bound, shapes=("eval", "wide")):
        """The kernels-line entries of kname beyond the training shape:
        times, and the bound computed from that shape's inputs."""
        out = {}
        for shape in shapes:
            t_k, t_p, t_dev = times[kname, shape]
            b = bound(args[shape])
            out[shape] = {"batch": int(args[shape][0].shape[0]),
                          "rows": int(args[shape][0].shape[1]),
                          "ms": t_k, "plain_ms": t_p, "device_ms": t_dev,
                          "bound_ms": b[0], "bound_by": b[1]}
        return out
    print(json.dumps({"kernels": [
        {"name": "hop_chain", "route": "cuda", "redesigned_in": 4,
         "source": "qmann_tpu_torch/csrc/hop_chain.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:358",
         "launches": launches, "max_abs_err": max(max_err, chain3_err),
         "ms": t_chain["cached"][0], "plain_ms": t_chain["cached"][1],
         "device_ms": t_chain["cached"][2],
         "bound_ms": b_chain[0],
         "bound_by": b_chain[1], "library_ms": None,
         "raw_h": {"ms": t_chain["raw H"][0],
                   "device_ms": t_chain["raw H"][2]},
         "features": {"serve_sc_att":
                      feature_launches["serve_sc_att"]["hop_chain"]},
         "mode3": {"launches": chain3_launches, "max_abs_err": chain3_err,
                   "ms": k3["hop_chain", "cached"][0],
                   "plain_ms": k3["hop_chain", "cached"][1],
                   "device_ms": k3["hop_chain", "cached"][2],
                   "bound_ms": b_chain3[0], "bound_by": b_chain3[1],
                   "raw_h": {"ms": k3["hop_chain", "raw H"][0],
                             "device_ms": k3["hop_chain", "raw H"][2]}}},
        {"name": "qmatvec", "route": "cuda", "redesigned_in": 4,
         "source": "qmann_tpu_torch/csrc/qmatvec.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:88",
         "launches": qmv_launches, "max_abs_err": qmv_err,
         "ms": k_times["qmatvec", "train"][0],
         "plain_ms": k_times["qmatvec", "train"][1],
         "device_ms": k_times["qmatvec", "train"][2],
         "bound_ms": b_qmv[0], "bound_by": b_qmv[1], "library_ms": None,
         "eval": {"rows": qmv_args["eval"][1].shape[0],
                  "ms": k_times["qmatvec", "eval"][0],
                  "plain_ms": k_times["qmatvec", "eval"][1],
                  "device_ms": k_times["qmatvec", "eval"][2],
                  "bound_ms": b_qmv_eval[0], "bound_by": b_qmv_eval[1]},
         "mode3": {"launches": qmv3_launches},
         "features": {k: v["qmatvec"] for k, v in feature_launches.items()},
         "tiled_in": 6, "tiled_max_abs_err": tiled_err,
         "cli_launches": cli_qmv, "joint_launches": joint_qmv,
         **{name: {"rows": int(a[1].shape[0]),
                   "dim_input": int(a[1].shape[1]), "ms": t_tiled[name][0],
                   "plain_ms": t_tiled[name][1],
                   "device_ms": t_tiled[name][2],
                   "bound_ms": b_tiled[name][0],
                   "bound_by": b_tiled[name][1]}
            for name, a in tiled_args.items()}},
        {"name": "attention_read", "route": "cuda",
         "source": "qmann_tpu_torch/csrc/attention_read.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:435",
         "launches": ar_launches, "max_abs_err": max(ar_err, ar3_err),
         "ms": k_times["attention_read", "train"][0],
         "plain_ms": k_times["attention_read", "train"][1],
         "device_ms": k_times["attention_read", "train"][2],
         "bound_ms": b_read[0], "bound_by": b_read[1], "library_ms": None,
         "redesigned_in": 5,
         "features": {k: v["attention_read"]
                      for k, v in feature_launches.items()},
         **at_shapes(k_times, "attention_read", read_args,
                     lambda a: attention_read_bound(*a[:4])),
         "mode3": {"launches": ar3_launches, "max_abs_err": ar3_err,
                   "ms": k3["attention_read", "train"][0],
                   "plain_ms": k3["attention_read", "train"][1],
                   "device_ms": k3["attention_read", "train"][2],
                   "bound_ms": b_read3[0], "bound_by": b_read3[1],
                   **at_shapes(k3, "attention_read", read3_args,
                               lambda a: attention_read_bound(
                                   *a[:4], num_bit=nb3))}},
        {"name": "hamming_score", "route": "cuda",
         "source": "qmann_tpu_torch/csrc/hamming.cu",
         "replaces": "qmann_tpu/ops/pallas/qkernels.py:171",
         "launches": ham_launches, "max_abs_err": ham_err,
         "ms": k3["hamming", "train"][0],
         "plain_ms": k3["hamming", "train"][1],
         "device_ms": k3["hamming", "train"][2],
         "bound_ms": b_ham[0], "bound_by": b_ham[1], "library_ms": None,
         "redesigned_in": 5,
         "features": {"mode3_sc_att":
                      feature_launches["mode3_sc_att"]["hamming_score"]},
         **at_shapes(k3, "hamming", ham_args,
                     lambda a: hamming_bound(*a[:2], num_bit=nb3))},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
