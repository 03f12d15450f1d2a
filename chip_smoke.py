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
The family trainer (train/multi.py), at the flagship widths and
megasweep's padded layout (V=64, M=50: dim_input 114), use_pallas:
 16. family  — the run.sh family, 20 synthetic qa1-shaped tasks (train
               sizes 905..1000, valid and test 100) x 10 seeds = 200 runs,
               weights x4: the R-axis lattice at the family's memory
               embedding (200 x 1600 rows) bit-identical to its stacked
               plain version at each rounding mode and binary fmt_w /
               fmt_x; 2 epochs of train_tasks_multi with a spy on
               family_step (gates: 10 lattice + 3 read launches in every
               family step, as one run's, and per eval chunk; costs
               finite); one family step against train_step of 3 sampled
               runs (the first, the last, one of the shortest task) on the
               first and the last batch (an all-padding batch leaves its
               run's weights untouched); the sampled runs' 2-epoch
               histories and err_test against train_task (errors equal,
               costs within rtol 2e-4); the sweep_fixed.sh family (mode 3,
               iwl 1, 20 tasks x 2 seeds, 1 epoch) on use_pallas (10 + 3
               read launches per forward) and use_pallas_hamming (3
               Hamming launches per forward); megasweep.main() at its
               default route (integer fast path, no use_pallas; R = 200, 1
               epoch, no kernel launch; how many (weight, run) pairs took
               the slow branch, read by a spy on the fast path's
               decisions).  Each kernel at the shapes the family's path
               gives it, against its plain version: the lattice at an eval
               chunk (200 x 6400 rows, each hop's format; bit-identical),
               the mode-2 read at the folded training batch (200 x 32) and
               eval chunk (200 x 128 = 25,600 queries), and the mode-3
               read and the Hamming kernel at the sweep_fixed family's
               folded batches (40 x 32 = 1280 and 40 x 128 = 5120 queries,
               M=50, D=60; on its initial weights, and for the Hamming
               kernel also on phase 9's edge inputs; bit-identical).
               Findings: the family's epoch against R single-run epochs,
               the family step's event and busy time, and each of those
               kernels and the one-run 1600-row lattice against their
               plain versions and bounds
The packet server and the serving bench tools:
 17. serve   — seeded bAbI-format files (task 1), the test split through
               samples_from_split plus 5 edge samples (NULL, indices past
               the dictionary and in the temporal columns, stories past
               max_line, temporal indices out of range or missing, empty
               sentences and question): serve(engine, port=0) on cuda:0
               with use_fused_chain at the flagship widths, mode 2 and mode
               3 at iwl 5 (weights scaled as in phase 4), answering
               PacketClient over TCP (gates: every answer equal to the
               plain route's for the same sample, one chain launch per
               wave, no failed wave); the unprepared engine (prepare=False,
               use_pallas: 10 lattice + 3 read launches per wave, the plain
               route's answers); the checkpoint of the mode-2 model served
               by python -m qmann_tpu_torch.serve.server --port 0 as a
               process, queried by python -m qmann_tpu_torch.serve.client
               --task 1 --limit 150 (gate: its err_test equals the plain
               route's on the same 150; the server killed and gone on every
               path); then bench/engine_bench.py (prepared on the chain
               against unprepared on the lattice and read, 3 passes: equal
               answers, no failed wave), bench/backend_ab.py in mode 2
               (unfused, chain, read) and mode 3 at iwl 5 (unfused,
               hamming, read, chain) at --synthetic 19,10,6,60 and weights
               x4 (identical predictions; the 30-batch loop under torch's
               sync debug mode "error", so no host sync), probe_dispatch
               and trace_forward on the chain (gate: the chain kernel's
               records carry a Python path and land in a named bucket);
               each tool's JSON lines printed (with the card's name and
               power limit)
The device mesh (parallel/), at the flagship widths:
 18. mesh    — (2, 2): 4 ranks spawned on cuda:0 over gloo (ranks share the
               card, so NCCL cannot serve them): the sharded and the
               explicit step at batch 32 on use_pallas (mode 2 iwl 5, mode
               3 iwl 1, mode 3 iwl 1 on use_pallas_hamming; qa1-shaped
               M=10 split over the model axis) against one single-device
               train_step on the card on the plain route (parameters rtol
               2e-5, atol 2e-6; cost rtol 1e-4; matches equal) and every
               rank's parameters bitwise equal after 3 steps; the
               distributed read (modes 2 and 3, B=32, wide M=50, its
               local Hamming scores on the kernel) against the read's
               plain version (p atol 1e-6, o within one 2^-frac step, the
               queries whose o differs counted); the sharded prepared
               infer (modes 2 and 3, B=1000) against the single-device
               prepared forward (predictions equal, cost rtol 1e-6);
               eval_split(mesh=) on use_pallas against the plain
               eval_split (predictions and error equal); the engine over
               the mesh answering 200 requests as the plain route, no
               failed wave.  (1, 1): one rank over NCCL, one step equal
               to the single-device plain step.  The ranks keep the
               lattice's, the Hamming kernel's and the read's inputs at
               every signature they launch them at; each kernel is then
               run on those inputs against its plain version on the card
               (the lattice and the Hamming kernel bit for bit, the read
               within its tolerances).  The launches summed
               over ranks (gates: the lattice at both, the Hamming kernel
               at (2, 2), the read at (1, 1), where the memory is whole;
               the chain none, the mesh pins the plain prepared forward);
               the sharded step's event time at (1, 1) and (2, 2).  Then
               python -m torch.distributed.run --nproc-per-node 2 -m
               qmann_tpu_torch 1 1 1 5 --mesh 2,1 --use-pallas --epochs 2
               on phase 14's files (gates: it finishes, rank 0 alone
               prints the loop line and writes result.csv; its err_test
               printed beside phase 14's), bench/scaling.py --devices 1
               (one JSON line) and --devices 2 (exit 2 on one card), and
               bench/diagnose.py and bench/scatt_study.py for 2 epochs on
               phase 14's task-1 files (records present and finite)
JAX's compiled programs as CUDA graphs (graphs.py):
 19. graphs  — at the flagship widths on phase 7's data: 2 epochs of
               train_epoch as replays of the step's captured graph against
               the eager train_step loop, in mode 2 iwl 5 and mode 3 iwl 1
               on use_pallas and mode 3 iwl 1 on use_pallas_hamming
               (gates: parameters and costs bit-identical, or else within
               rtol 1e-4, atol 1e-6 with the differing elements counted;
               the launches of the graphed epochs those of the eager
               steps, the launches per replay those of one eager step);
               the event time per step, graphed against eager, in 5
               strictly alternating pairs of 10 steps, with the profiler's
               busy time and idle share; bench.py's program
               (dependent_batches, B=1000, K=30) on the chain in modes 2
               and 3 at iwl 5, graphed against eager (predictions equal,
               90 chain launches in 3 programs; ms per batch); an engine
               with use_fused_chain answering 200 requests in waves of 64
               (answers equal to the eager forward's, one chain launch per
               wave; wave p50 and p99 of the graphed and the eager
               forward on the vectorized waves, host clock); phase 16's
               R = 200 family for 2 epochs through multi_epoch, graphed
               and eager (parameters bit-identical; epoch seconds)
Then one JSON line of kernels (the read's and the Hamming kernel's with
their eval-chunk and wide entries, qmatvec's with its tiled shapes, each
with its launches on phase 15's paths, each one's family entry, the
chain's launches on the server path and the lattice's and read's on the
unprepared engine, each one's mesh entry: its launches summed over the
ranks of phase 18's (2, 2) and (1, 1) paths, its shapes there and its
largest difference from its plain version at them, and its launches on
each graphed path of phase 19), the card's name and power limit, and as
the last line
{"ok": true, "device": {...}}.

Phase 17 runs mode 3 in backend_ab at iwl 5, JAX's default: at iwl 1
prepare_inference is not exact (a count of 1 exceeds Q0.7's 0.992), and
the tool refuses a route that is not, as JAX's asserts.

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
FAMILY_TASKS, FAMILY_SEEDS = 20, 10     # run.sh: 20 tasks x 10 loops
FAMILY_LAYOUT = (64, 50, 6)             # megasweep's pad_dict, pad_line
FAMILY_VALID = FAMILY_TEST = 100


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
    an add; requant each output (per run of a family w [R, O, I])."""
    (B, I), O = x.shape[-2:], w.shape[-2]
    R = w.shape[0] if w.dim() == 3 else 1
    ops = R * (Q_OPS * (O * I + B * I + B * O) + B * O * I * (2 + Q_OPS))
    return _bound(_nbytes(w, x) + 4 * R * B * O, ops)


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


def recorded_ms(fn):
    """per_launch_ms of fn, profiled again (with more calls) while the
    profiler keeps no record of its kernel; None if it never does."""
    for n_iter in (5, 20, 50):
        ms = per_launch_ms(device_ms(fn, n_iter=n_iter))
        if math.isfinite(ms):
            return ms
    return None


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


def family_tasks(rng, pool, sizes):
    """{task index: TaskData}: each task a different random subset of the
    pool's stories, of its own train size, with FAMILY_VALID and
    FAMILY_TEST stories of the pool's other splits."""
    import dataclasses
    import numpy as np
    from qmann_tpu_torch.data.babi import TaskData, VectorizedSplit

    def subset(split, n):
        idx = np.sort(rng.permutation(len(split))[:n])
        return VectorizedSplit(*(getattr(split, f.name)[idx]
                                 for f in dataclasses.fields(split)))

    return {t + 1: TaskData(subset(pool.train, n),
                            subset(pool.valid, FAMILY_VALID),
                            subset(pool.test, FAMILY_TEST), pool.dims,
                            pool.dictionary)
            for t, n in enumerate(sizes)}


def family_batch(tasks, run_task, i, batch, dev, split="train"):
    """Batch i of the family's grid over a split (no shuffle), built here
    from the tasks' arrays: each run's samples i*batch... of its task,
    padding past its count (sample 0, masked out), as train_tasks_multi
    lays them out.  Returns the [R, batch, ...] device batch and the runs
    whose batch is all padding."""
    import numpy as np
    import torch
    split = [getattr(tasks[t], split) for t in run_task]
    rows = np.arange(i * batch, (i + 1) * batch)
    n = np.array([len(s) for s in split])
    idx = np.where(rows[None] < n[:, None], rows[None], 0)
    out = {"memory": np.stack([s.memory[j] for s, j in zip(split, idx)]),
           "question": np.stack([s.question[j] for s, j in zip(split, idx)]),
           "answer": np.stack([s.answer[j] for s, j in zip(split, idx)]),
           "mask": np.stack([s.mask[j] for s, j in zip(split, idx)]),
           "sample_mask": (rows[None] < n[:, None]).astype(np.float32)}
    out["size_b"] = out["sample_mask"].sum(-1)
    return ({k: torch.from_numpy(v).to(dev) for k, v in out.items()},
            np.flatnonzero(out["size_b"] == 0))


def family_read_inputs(params, cfg, batch):
    """Hop 0's read operands from a family batch on the kernel route, the
    run axis folded into the queries as the model folds it: (m, c
    [R*B, M, D], u [R*B, D], the float mask [R*B, M])."""
    import torch
    from qmann_tpu_torch.ops.qlinear import qembed_mat_forward, qmatvec_forward
    f0 = cfg.fmt_w[0]
    with torch.inference_mode():
        u = qmatvec_forward(params["B"], batch["question"], f0, f0,
                            backend="kernel")
        m, c = (qembed_mat_forward(batch["memory"], params[w], f0,
                                   backend="kernel") for w in "AC")
    M, D = m.shape[-2:]
    return (m.reshape(-1, M, D), c.reshape(-1, M, D), u.reshape(-1, D),
            batch["mask"].reshape(-1, M).to(torch.float32))


def fast_path_tally(memn2n):
    """Put a spy in memn2n._integer_fast_decisions' place that tallies the
    integer fast path's (weight, run) decisions: returns (the tally
    {"gemm", "lattice"}, a function that puts the real one back)."""
    import numpy as np
    tally, real = {"gemm": 0, "lattice": 0}, memn2n._integer_fast_decisions

    def spy(*args):
        fast_q, fast_m = real(*args)
        for f in ([] if fast_q is None else [fast_q]) + list(fast_m or []):
            f = np.asarray(f, bool)
            tally["gemm"] += int(f.sum())
            tally["lattice"] += f.size - int(f.sum())
        return fast_q, fast_m

    memn2n._integer_fast_decisions = spy
    return tally, lambda: setattr(memn2n, "_integer_fast_decisions", real)


def run_family(multi, cfg, tasks, seeds, dev, counts, params=None):
    """train_tasks_multi on the card with a spy in family_step's place and
    one on the replays of the family step's graph: returns (result,
    launches per family step that ran, launches of the whole run).  The
    spy records the step's eager run (the graph's warm-up); the call made
    while the graph is captured runs no kernel and is not a step (the
    graph takes its counts back); each replay is one step, and adds what
    the capture counted."""
    import torch
    from qmann_tpu_torch import graphs
    per_step, real, replay = [], multi.family_step, graphs.Graph.replay

    def spy(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            return real(*args, **kw)
        before = counts()
        out = real(*args, **kw)
        per_step.append({k: v - before[k] for k, v in counts().items()})
        return out

    def replay_spy(self):
        before = counts()
        replay(self)
        if self.key[0] == "family_step":
            per_step.append({k: v - before[k] for k, v in counts().items()})

    multi.family_step, graphs.Graph.replay = spy, replay_spy
    try:
        res = multi.train_tasks_multi(cfg, tasks, seeds, params=params,
                                      device=dev)
    finally:
        multi.family_step, graphs.Graph.replay = real, replay
    return res, per_step, counts()


def family_finite(res):
    import numpy as np
    return (all(np.isfinite(h[k]).all() for h in res.history
                for k in ("cost_train", "cost_valid"))
            and np.isfinite(res.cost_test).all())



def read_line(proc, timeout):
    """The next line of proc's stdout, or None after `timeout` seconds."""
    import threading
    box = []
    t = threading.Thread(target=lambda: box.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(timeout)
    return box[0] if box else None


def serve_edge_samples(dims, n_dict):
    """Packet-stream samples at the edges of the engine's index path: NULL
    (index 0) counted, indices past the dictionary and in the temporal
    columns dropped before the truncation to the row's words, stories past
    max_line, transmitted temporal indices out of range, in a word column
    or missing, empty sentences and an empty question."""
    from qmann_tpu_torch.serve.packet import IndexedSample
    d = dims
    drop = [n_dict, d.dim_dict - 1, d.dim_dict, d.dim_input - 1, 4095]
    words = [i % (n_dict - 1) + 1 for i in range(3 * d.max_word)]
    return [
        IndexedSample([[0, 0, 1], drop + words], [d.dim_dict, d.dim_dict + 1],
                      [0] + drop + [2, 3], [1]),
        IndexedSample([words[i:i + 3] for i in range(d.max_line + 3)],
                      [d.dim_dict + (i % d.max_line)
                       for i in range(d.max_line + 3)], words[:3], [1]),
        IndexedSample([[1, 2], [3], words, [4]], [d.dim_input, 2], [5, 6],
                      [2]),
        IndexedSample([[], [1], []], [d.dim_dict + 2, 4095, d.dim_dict], [],
                      [3]),
        IndexedSample([drop], [d.dim_dict], drop + words[:2], [1]),
    ]


def phase_serve(card, dev, counters, ckpt_dir, data_path, raw_path,
                tag="17 serve"):
    """Phase 17: the packet server and client in front of the chain kernel,
    in process and as the two command lines, and the serving bench tools,
    on phase 14's task-1 model (mode 2; ckpt_dir) and its files; mode 3
    with fresh weights scaled as in phase 4.  Returns the launches and the
    tools' rows for the kernels line."""
    import re
    import tempfile
    from qmann_tpu_torch.bench import (backend_ab, engine_bench,
                                       probe_dispatch, trace_forward)
    from qmann_tpu_torch.data import DataDims, Dictionary, load_test_split
    from qmann_tpu_torch.data.native import load_task_native
    from qmann_tpu_torch.models.memn2n import params_from_jax
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.serve.client import PacketClient, samples_from_split
    from qmann_tpu_torch.serve.server import serve
    from qmann_tpu_torch.utils import load_checkpoint, save_checkpoint

    def zero_counts():
        for fn in counters.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in counters.items()}

    def answers_of(params, cfg, samples, **kw):
        engine = InferenceEngine(params, cfg, dims, dictionary,
                                 batch_size=64, device=dev, **kw).start()
        try:
            return engine, [f.result(timeout=300) for f in
                            [engine.submit_indexed(x) for x in samples]]
        finally:
            engine.stop()

    task = "qa1_single-supporting-fact"
    c_params, c_cfg, c_dims = load_checkpoint(str(ckpt_dir))
    dims = DataDims(**c_dims)
    dictionary = Dictionary()
    for w in json.loads((Path(ckpt_dir) / "dictionary.json").read_text())[1:]:
        dictionary.add(w)
    test = load_test_split(task, data_path, dictionary, dims,
                           raw_path=raw_path)
    samples = (samples_from_split(test, dims)
               + serve_edge_samples(dims, len(dictionary)))
    tmp = tempfile.TemporaryDirectory(prefix="qmann_serve_")
    root = Path(tmp.name)
    out = {}

    # (a) in process: the server on an engine with use_fused_chain, mode 2
    # (phase 14's model) and mode 3 at iwl 5, against the plain route's
    # answers; mode 2 also against the unprepared engine on the lattice
    # and read kernels
    cfg2 = c_cfg.replace(use_fused_chain=True)
    for mode in (2, 3):
        if mode == 2:
            cfg, scale = cfg2, 1.0
            params = params_from_jax(c_params, cfg, device=dev)
        else:
            cfg = cfg2.replace(attention_mode=3, use_pallas=False)
            scale, params, _ = scaled_prepared(cfg, dims, test.memory, dev)
        engine = InferenceEngine(params, cfg, dims, dictionary,
                                 batch_size=64, device=dev).start()
        server = serve(engine, port=0)
        host, port = server.server_address[:2]
        zero_counts()
        try:
            with PacketClient(host, port, timeout=300) as client:
                answers = client.query_samples(samples)
            served = counts()
        finally:
            server.shutdown()
            server.server_close()
            engine.stop()
        st = engine.stats.snapshot()
        _, want = answers_of(params, cfg.replace(use_fused_chain=False,
                                                 use_pallas=False), samples)
        print(f"[{tag}] {card} | mode {mode} iwl {cfg.iwl}, use_fused_chain, "
              + ("phase 14's model" if mode == 2 else
                 f"weights x{scale}")
              + f": {len(answers)} answers over TCP ({len(test)} test "
              f"stories of seeded bAbI-format files, 5 edge samples) in "
              f"{st['waves']} waves, failed_waves {st['failed_waves']}, "
              f"launches {served}; equal to the plain route's: "
              f"{answers == want}; distinct answers {len(set(answers))}",
              flush=True)
        if (not engine.prepared.fast or st["failed_waves"]
                or st["requests"] != len(samples)):
            fail(f"the served engine (mode {mode}) left the exact route, "
                 "failed a wave or lost a request")
        if served["hop_chain"] != st["waves"] or served["hop_chain"] < 1:
            fail(f"the server path (mode {mode}) did not launch the chain "
                 "kernel once per wave")
        if answers != want:
            fail(f"answers over TCP (mode {mode}) differ from the plain "
                 "route's")
        out[f"serve_mode{mode}"] = {"launches": served["hop_chain"],
                                    "waves": st["waves"],
                                    "requests": st["requests"]}
        if mode == 2:
            params2, want2 = params, want

    # the unprepared engine (use_pallas: the lattice and the read kernels)
    zero_counts()
    engine, got = answers_of(params2, cfg2.replace(use_pallas=True), samples,
                             prepare=False)
    unprepared = counts()
    waves = engine.stats.waves
    print(f"[{tag}] unprepared engine, mode 2, use_pallas: {waves} waves, "
          f"launches {unprepared} (want 10 lattice + 3 read per wave); "
          f"answers equal to the plain route's: {got == want2}", flush=True)
    if got != want2:
        fail("the unprepared engine's answers differ from the plain route's")
    if engine.prepared is not None or unprepared != {
            "qmatvec": 10 * waves, "attention_read": 3 * waves,
            "hamming_score": 0, "hop_chain": 0}:
        fail("the unprepared engine did not run the lattice and read kernels "
             "once per wave and hop")
    out["unprepared"] = {"qmatvec": unprepared["qmatvec"],
                         "attention_read": unprepared["attention_read"],
                         "waves": waves}

    # (b) the entry points: the server and the client as processes, on the
    # checkpoint saved with use_fused_chain
    n_test = 150
    ckpt = save_checkpoint(str(root / "ckpt"), c_params, cfg2, dims,
                           tag="served", dictionary=dictionary)
    test_n = load_task_native(task, data_path, raw_path=raw_path,
                              limit_test=n_test).test
    _, plain_n = answers_of(params2, cfg2.replace(use_fused_chain=False,
                                                  use_pallas=False),
                            samples_from_split(test_n, dims))
    err_plain = 1.0 - sum(int(a == int(test_n.answer_index[i]))
                          for i, a in enumerate(plain_n)) / len(plain_n)
    srv = subprocess.Popen(
        [sys.executable, "-m", "qmann_tpu_torch.serve.server",
         "--checkpoint", ckpt, "--port", "0", "--device", str(dev)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = read_line(srv, 300) or ""
        m = re.match(r"serving on (\S+):(\d+)", line)
        if m is None:
            fail(f"the server process did not report its port: {line!r}")
        cli = subprocess.run(
            [sys.executable, "-m", "qmann_tpu_torch.serve.client",
             "--host", m.group(1), "--port", m.group(2), "--task", "1",
             "--limit", str(n_test), "--data-path", data_path,
             "--raw-data-path", raw_path], cwd=REPO, capture_output=True,
            text=True, timeout=300)
    finally:
        srv.kill()
        srv.wait(timeout=60)
    if srv.poll() is None:
        fail("the server process is still running")
    m_err = re.search(r"streamed (\d+) samples; err_test = (\S+)", cli.stdout)
    print(f"[{tag}] python -m qmann_tpu_torch.serve.server (checkpoint with "
          f"use_fused_chain, dictionary.json) and .client --task 1 --limit "
          f"{n_test}: rc {cli.returncode}, {cli.stdout.strip()!r}; the plain "
          f"route's err_test {err_plain:f}; server process ended "
          f"(rc {srv.returncode})", flush=True)
    if cli.returncode != 0 or m_err is None or int(m_err.group(1)) != n_test:
        fail(f"the client process failed: {cli.stderr[-2000:]}")
    if m_err.group(2) != f"{err_plain:f}":
        fail("the client's err_test differs from the plain route's")
    out["cli_err_test"] = float(m_err.group(2))

    # (c) the serving bench tools, their JSON lines echoed
    files = ["--data-path", data_path, "--raw-data-path", raw_path]
    rows = {}
    for name, fn, argv in (
            ("engine_bench", engine_bench.main,
             ["--batch", "64", "--passes", "3", "--requests", "200",
              "--use-fused-chain", "--use-pallas", *files]),
            ("backend_ab mode 2", backend_ab.main,
             ["--variants", "unfused,chain,read", "--synthetic",
              "19,10,6,60", "--weight-scale", "4"]),
            ("backend_ab mode 3", backend_ab.main,
             ["--attention-mode", "3", "--variants",
              "unfused,hamming,read,chain", "--synthetic", "19,10,6,60",
              "--weight-scale", "4"]),
            ("probe_dispatch", probe_dispatch.main,
             ["--synthetic", "--use-fused-chain"]),
            ("trace_forward", trace_forward.main,
             ["--synthetic", "--use-fused-chain", "--iters", "1", "--top",
              "10", "--out", str(root / "trace")])):
        zero_counts()
        rc, lines = run_quiet(fn, [*argv, "--device", str(dev)], keep=r"(?!)")
        rows[name] = [json.loads(ln) for ln in lines if ln.startswith("{")]
        if rc != 0 or not rows[name]:
            fail(f"{name} failed")
        print(f"[{tag}] {name} ({' '.join(argv[:8])} ...): launches "
              f"{counts()}; its JSON lines:", flush=True)
        for row in rows[name]:
            print(json.dumps(row), flush=True)
    eb = rows["engine_bench"]
    if not (eb[2]["answers_identical"]
            and all(r["failed_waves"] == 0 for r in eb[:2])):
        fail("engine_bench: failed waves or unequal answers")
    for name in ("backend_ab mode 2", "backend_ab mode 3"):
        ab = rows[name][:-1]
        syncs = 0 if dev.type == "cuda" else None   # None: not checked
        if not all(r["outputs_identical"]
                   and r["host_syncs_in_loop"] == syncs for r in ab):
            fail(f"{name}: predictions differ or the loop synced")
    tf = rows["trace_forward"][-1]
    chain = tf["hand_kernels"]["hop_chain"]
    print(f"[{tag}] trace_forward: the chain kernel {chain}; buckets "
          + ", ".join(f"{k} {v['ms']:.4f} ms" for k, v in
                      tf["buckets"].items()), flush=True)
    if dev.type == "cuda" and (chain["records"] < 1
                               or chain["records_without_path"]
                               or chain["buckets"] != ["attention score"]):
        fail("trace_forward did not put the chain kernel's time in a named "
             "bucket")
    out["tools"] = rows
    tmp.cleanup()
    return out


# ---------------------------------------------------------------------------
# 18. the device mesh (parallel/): ranks spawned on the card
# ---------------------------------------------------------------------------

MESH_STEPS = (("mode 2 iwl 5", dict(use_pallas=True)),
              ("mode 3 iwl 1", dict(attention_mode=3, iwl=1,
                                    use_pallas=True)),
              ("mode 3 iwl 1 hamming", dict(attention_mode=3, iwl=1,
                                            use_pallas_hamming=True)))
MESH_LR = 0.3


def kernel_counters():
    """The four wrappers whose .launches count their kernel's launches."""
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    return {"qmatvec": qmv.quantized_matvec, "attention_read": ar.fused_read,
            "hamming_score": ham.hamming_score_kernel,
            "hop_chain": hop_chain.fused_hop_chain}


# the wrappers whose calls phase 18 records on the ranks: (module, name in
# it through which the mesh path calls the wrapper, kernel's key in the
# kernels line).  The lattice and the Hamming wrappers are looked up on
# their own modules at each call; the read is called through ops/fused.py
MESH_RECORDED = (("qmann_tpu_torch.ops.cuda.qmatvec", "quantized_matvec",
                  "qmatvec"),
                 ("qmann_tpu_torch.ops.cuda.hamming", "hamming_score_kernel",
                  "hamming_score"),
                 ("qmann_tpu_torch.ops.fused", "fused_read",
                  "attention_read"))


def record_calls(module, name, key, calls):
    """Put a spy in `name`'s place in `module`: it keeps, in `calls`, the
    inputs (as numpy) of the first call at each signature (the tensors'
    shapes and the other arguments) and calls the wrapper.  A wrapper
    counts its launches on the name in its own module, so the lattice's
    and the Hamming kernel's count on the spy while it is there; the
    caller sums the two.  Returns (spy, a function that puts the wrapper
    back)."""
    import torch
    wrapper = getattr(module, name)

    def spy(*args):
        sig = (key,) + tuple(tuple(a.shape) if isinstance(a, torch.Tensor)
                             else repr(a) for a in args)
        if sig not in calls:
            calls[sig] = (key, tuple(a.detach().cpu().numpy()
                                     if isinstance(a, torch.Tensor) else a
                                     for a in args))
        return wrapper(*args)

    spy.launches = 0
    setattr(module, name, spy)
    return spy, lambda: setattr(module, name, wrapper)


def mesh_rank(n, model, dev_type, inputs, full):
    """Phase 18 on one spawned rank of an (n // model, model) mesh: the
    sharded and explicit steps (full) or the sharded mode-2 step alone,
    and (full) the distributed read, the sharded prepared infer,
    eval_split(mesh=) and the engine over the mesh; then the sharded
    mode-2 step's event time.  The launch counts are set to 0 once the
    mesh is up and read at the end: everything here is the mesh's path.
    The lattice's, the Hamming kernel's and the read's inputs are kept at
    each signature the rank launches them at (record_calls).  Returns
    numpy results."""
    import importlib

    import numpy as np
    import torch
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import DataDims, Dictionary
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.parallel import (
        make_explicit_train_step, make_mesh, make_sharded_prepared_infer,
        make_sharded_train_step, memory_sharded_attention_read)
    from qmann_tpu_torch.parallel.sharding import put_infer_inputs
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.train import eval_split

    mesh = make_mesh(n, model, device=dev_type)
    dev = mesh.device
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    calls = {}
    spies = [(key, *record_calls(importlib.import_module(mod), name, key,
                                 calls))
             for mod, name, key in MESH_RECORDED]
    out = {"backend": mesh.backend, "index": (mesh.data_idx, mesh.model_idx)}

    def host(params):
        return {k: v.cpu().numpy().copy() for k, v in params.items()}

    batch = {k: torch.tensor(v, device=dev)
             for k, v in inputs["batch"].items()}
    size_b = float(inputs["batch"]["sample_mask"].sum())
    makers = [("sharded", make_sharded_train_step)]
    if full:
        makers.append(("explicit", make_explicit_train_step))
    out["steps"] = {}
    for name, kw in MESH_STEPS[:3 if full else 1]:
        cfg = QmannConfig(**kw)
        for kind, make in makers:
            params = {k: torch.tensor(v, device=dev)
                      for k, v in inputs["params"][name].items()}
            step = make(cfg, mesh)
            _, cost, matches = step(params, batch, MESH_LR, size_b)
            first = host(params)
            for _ in range(2):
                step(params, batch, MESH_LR, size_b)
            out["steps"][name, kind] = dict(
                params=first, cost=float(cost), matches=int(matches),
                after3=host(params), layout=tuple(step.layout(
                    batch["question"].shape[0], batch["mask"].shape[-1])))
            if name == MESH_STEPS[0][0] and kind == "sharded":
                timed = step, params
    if full:
        specs = {"m": ("data", "model", None), "c": ("data", "model", None),
                 "u": ("data", None), "mask": ("data", "model")}
        out["read"] = {}
        for name, (kw, arrays) in inputs["read"].items():
            lb = put_infer_inputs(mesh, specs, **arrays)
            with torch.no_grad():
                o, p = memory_sharded_attention_read(
                    mesh, lb["m"], lb["c"], lb["u"], lb["mask"],
                    QmannConfig(**kw))
            out["read"][name] = (o.cpu().numpy(), p.cpu().numpy())
        sb = inputs["serve_batch"]
        out["prepared"] = {}
        for mode, raw in inputs["serve_params"].items():
            cfg = QmannConfig(attention_mode=mode, use_fused_chain=True)
            params = {k: torch.tensor(v, device=dev) for k, v in raw.items()}
            prep = memn2n.prepare_inference(params, cfg, **inputs["bounds"])
            cost, matches, pred = make_sharded_prepared_infer(
                prep, cfg, mesh)(sb["memory"], sb["question"], sb["answer"],
                                 sb["mask"])
            out["prepared"][mode] = (float(cost), int(matches),
                                     pred.cpu().numpy(), prep.fast)
        cfg = QmannConfig(use_pallas=True)
        out["eval"] = eval_split(
            {k: torch.tensor(v, device=dev) for k, v in
             inputs["params"][MESH_STEPS[0][0]].items()},
            inputs["eval_split"], cfg, mesh=mesh)
        dictionary = Dictionary()
        for w in inputs["words"]:
            dictionary.add(w)
        engine = InferenceEngine(
            {k: torch.tensor(v) for k, v in
             inputs["serve_params"][2].items()},
            QmannConfig(use_fused_chain=True), DataDims(**inputs["dims"]),
            dictionary, batch_size=32, mesh=mesh).start()
        answers = None
        try:
            if mesh.rank == 0:
                answers = [f.result(timeout=300) for f in
                           [engine.submit(s, q) for s, q in
                            inputs["stories"]]]
        finally:
            engine.stop()
        out["engine"] = (answers, engine.stats.failed_waves,
                         engine.cfg.use_fused_chain)
    for _, _, restore in spies:
        restore()
    step, params = timed
    out["step_ms"] = (cuda_ms(lambda: step(params, batch, MESH_LR, size_b),
                              n_iter=5, samples=5)
                      if dev.type == "cuda" else None)
    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    for key, spy, _ in spies:
        out["launches"][key] += spy.launches
    out["calls"] = calls
    return out


def check_recorded_calls(results, dev, tag):
    """Each kernel on the inputs the mesh's ranks gave it, at every
    signature they launched it at (record_calls), against its plain
    version on the card: the lattice and the Hamming kernel bit for bit,
    the read within its tolerances (check_read).  Returns {kernel key:
    {"max_abs_err", "shapes"}}; fails on a disagreement."""
    import numpy as np
    import torch
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    pairs = {"qmatvec": (qmv.quantized_matvec,
                         qmv.quantized_matvec_reference),
             "hamming_score": (ham.hamming_score_kernel,
                               ham.hamming_score_reference),
             "attention_read": (ar.fused_read, ar.fused_read_reference)}
    calls = {}
    for r in results:
        calls.update(r["calls"])
    found = {}
    for key, args in calls.values():
        args = tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                     else a for a in args)
        kernel, plain = pairs[key]
        with torch.no_grad():
            got, want = kernel(*args), plain(*args)
        if key == "attention_read":
            diffs, flips, good, _ = check_read(got, want, args[6], args[8])
            err = max(diffs.values())
        else:
            err = float((got - want).abs().max())
            good = torch.equal(got, want)
        entry = found.setdefault(key, {"max_abs_err": 0.0, "shapes": [],
                                       "signatures": 0, "unequal": []})
        shapes = [list(a.shape) for a in args if isinstance(a, torch.Tensor)]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["signatures"] += 1
        if shapes not in entry["shapes"]:
            entry["shapes"].append(shapes)
        if not good:
            entry["unequal"].append(shapes)
    bad = []
    for key, entry in found.items():
        unequal = entry.pop("unequal")
        print(f"[{tag}] {key} on the ranks' inputs at {entry['signatures']} "
              f"signatures (shapes {entry['shapes']}): max |kernel - plain| "
              f"{entry['max_abs_err']:.3g}; disagreeing at "
              f"{unequal or 'none'}", flush=True)
        if unequal:
            bad.append(key)
    if bad:
        fail(f"{', '.join(bad)} disagree with their plain versions at the "
             "mesh path's shapes")
    return found


def phase_mesh(card, dev, data_path, raw_path, single_err):
    """Phase 18: the mesh on the card at the flagship widths.  (2, 2) is 4
    ranks on cuda:0 over gloo (ranks share the card), (1, 1) one rank over
    NCCL; then python -m qmann_tpu_torch --mesh 2,1 under torchrun on phase
    14's files and the training-study tools.  Returns the mesh's launches
    per kernel for the kernels line."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from qmann_tpu_torch.bench import diagnose, scatt_study
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_batch, synthetic_task
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.losses import cross_entropy
    from qmann_tpu_torch.parallel.launch import run_ranks
    from qmann_tpu_torch.serve import InferenceEngine
    from qmann_tpu_torch.train import eval_split, trainer

    tag = "18 mesh"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 18)
    V, M, W = 19, 10, 6

    def with_answers(B, mem, que, mask, dims):
        ans = np.zeros((B, dims.dim_input), np.float32)
        ans[np.arange(B), rng.integers(1, V, B)] = 1.0
        return {"memory": mem, "question": que, "answer": ans, "mask": mask,
                "sample_mask": np.ones(B, np.float32)}

    dims, *arrays = synthetic_batch(rng, TRAIN_BATCH, V, M, W)
    batch = with_answers(TRAIN_BATCH, *arrays, dims)
    params = {name: {k: 4.0 * v.numpy() for k, v in memn2n.init_params(
        QmannConfig(**kw), dims, torch.Generator().manual_seed(SEED),
        device="cpu").items()} for name, kw in MESH_STEPS}

    # the single-device references on the card, on the plain route: the
    # mesh's runs launch the kernels at their ranks' local shapes, and are
    # held against the plain versions there (the lattice and the Hamming
    # kernel are exact, so the tolerances fail a wrong kernel)
    plain = dict(use_pallas=False, use_pallas_hamming=False)

    def single_step(name):
        cfg = QmannConfig(**{**dict(MESH_STEPS)[name], **plain})
        p = {k: torch.tensor(v, device=dev) for k, v in params[name].items()}
        b = {k: torch.tensor(v, device=dev) for k, v in batch.items()}
        b["size_b"] = b["sample_mask"].sum()
        cost, matches = trainer.train_step(
            p, b, torch.tensor(MESH_LR, device=dev), cfg)
        return {k: v.cpu().numpy() for k, v in p.items()}, float(cost), \
            int(matches)

    refs = {name: single_step(name) for name, _ in MESH_STEPS}
    read_in, read_want = {}, {}
    for name, kw in (("mode 2", {}), ("mode 3", dict(attention_mode=3,
                                                     iwl=1))):
        cfg = QmannConfig(use_pallas=True, **kw)
        *_, mask_t, (m, c, u) = read_inputs(rng, cfg, TRAIN_BATCH, 64, 50, 7,
                                            dev)
        read_in[name] = (dict(use_pallas=True, **kw), {
            "m": m.cpu().numpy(), "c": c.cpu().numpy(),
            "u": u.cpu().numpy(), "mask": mask_t.cpu().numpy()})
        with torch.no_grad():
            read_want[name] = ar.fused_read_reference(
                m, c, u, mask_t.to(torch.float32), cfg.fmt_att[0],
                cfg.fmt_bin, cfg.fmt_act[0],
                score_quantized=cfg.attention_mode == 2,
                sum_quantized=cfg.wsum_quantized,
                attention_mode=cfg.attention_mode,
                ham_num_bit=cfg.num_bits_attention,
                ham_const_scale=cfg.attention_const_scale)
    sdims, *sarrays = synthetic_batch(rng, BATCH, V, M, W)
    serve_batch = with_answers(BATCH, *sarrays, sdims)
    bounds = dict(max_count=float(sdims.max_word + 1),
                  max_rowsum=float(sdims.max_word + 1))
    serve_params, prepared_want = {}, {}
    for mode in (2, 3):
        cfg = QmannConfig(attention_mode=mode)
        _, p, prep = scaled_prepared(cfg, sdims, serve_batch["memory"], dev)
        serve_params[mode] = {k: v.cpu().numpy() for k, v in p.items()}
        with torch.no_grad():
            out = memn2n.forward_prepared(prep, *(
                torch.from_numpy(serve_batch[k]).to(dev)
                for k in ("memory", "question", "mask")), cfg)
            met = cross_entropy(out.logits, torch.from_numpy(
                serve_batch["answer"]).to(dev))
        prepared_want[mode] = (float(met.cost), int(met.matches),
                               met.pred.cpu().numpy())
    split = synthetic_task(rng, 64, 16, BATCH, V, M, W).test
    eval_want = eval_split({k: torch.tensor(v, device=dev) for k, v in
                            params[MESH_STEPS[0][0]].items()}, split,
                           QmannConfig(), device=dev)
    from qmann_tpu_torch.data import Dictionary
    dictionary = Dictionary()
    for i in range(1, V):
        dictionary.add(f"w{i}")
    words = dictionary.words[1:]
    stories = [([[words[i] for i in rng.integers(0, len(words),
                                                 rng.integers(1, W + 1))]
                 for _ in range(rng.integers(1, M + 3))],
                [words[i] for i in rng.integers(0, len(words), 4)])
               for _ in range(200)]
    plain_engine = InferenceEngine(
        {k: torch.tensor(v) for k, v in serve_params[2].items()},
        QmannConfig(), sdims, dictionary, batch_size=32, device=dev).start()
    try:
        engine_want = [f.result(timeout=300) for f in
                       [plain_engine.submit(s, q) for s, q in stories]]
    finally:
        plain_engine.stop()
    inputs = dict(batch=batch, params=params, read=read_in,
                  serve_batch=serve_batch, serve_params=serve_params,
                  bounds=bounds, eval_split=split, words=words,
                  stories=stories, dims=dataclasses.asdict(sdims))

    def check_steps(results, names, kinds):
        """Each step against the single-device one; the ranks' parameters
        bitwise equal after 3 steps."""
        for name in names:
            ref_p, ref_cost, ref_matches = refs[name]
            for kind in kinds:
                got = results[0]["steps"][name, kind]
                err = max(float(np.max(np.abs(got["params"][k] - ref_p[k])))
                          for k in ref_p)
                close = all(np.allclose(got["params"][k], ref_p[k],
                                        rtol=2e-5, atol=2e-6) for k in ref_p)
                same = all(all(np.array_equal(r["steps"][name, kind][
                    "after3"][k], got["after3"][k]) for k in ref_p)
                    for r in results)
                print(f"[{tag}] {kind} step, {name}, layout "
                      f"{got['layout']}: max |param - single-device plain| "
                      f"{err:.3g}, cost {got['cost']:.6f} (single "
                      f"{ref_cost:.6f}), matches {got['matches']} (single "
                      f"{ref_matches}); {len(results)} ranks' params "
                      f"bitwise equal after 3 steps: {same}", flush=True)
                if not (close and same and got["matches"] == ref_matches
                        and math.isclose(got["cost"], ref_cost,
                                         rel_tol=1e-4)):
                    fail(f"the {kind} step ({name}) differs from the "
                         "single-device step or the ranks disagree")

    def summed(results):
        return {k: sum(r["launches"][k] for r in results)
                for k in results[0]["launches"]}

    # (2, 2): 4 ranks on the card over gloo
    t0 = time.perf_counter()
    r22 = run_ranks(mesh_rank, 4, (4, 2, dev.type, inputs, True),
                    device=dev.type, timeout=600)
    t22 = time.perf_counter() - t0
    print(f"[{tag}] (2, 2): 4 ranks on {dev}, backend {r22[0]['backend']}, "
          f"{t22:.1f} s with start-up", flush=True)
    check_steps(r22, [n for n, _ in MESH_STEPS], ("sharded", "explicit"))
    for name, (want_o, want_p, _) in read_want.items():
        B, D = want_o.shape
        o = np.zeros((B, D), np.float32)
        p = np.zeros(want_p.shape, np.float32)
        for r in r22:
            d, j = r["index"]
            ro, rp = r["read"][name]
            o[d * ro.shape[0]:(d + 1) * ro.shape[0]] = ro
            p[d * rp.shape[0]:(d + 1) * rp.shape[0],
              j * rp.shape[1]:(j + 1) * rp.shape[1]] = rp
        cfg = QmannConfig(**read_in[name][0])
        step_act = 2.0 ** -cfg.fmt_act[0].frac
        do = np.abs(o - want_o.cpu().numpy())
        dp = float(np.max(np.abs(p - want_p.cpu().numpy())))
        flips = int((do.max(-1) > 0).sum())
        print(f"[{tag}] distributed read, {name}, B={B} M=50 D={D} over "
              f"(2, 2): max |p - plain read| {dp:.3g}, max |o - plain "
              f"read| {float(do.max()):.3g} (one step {step_act}), "
              f"queries whose o differs: {flips}", flush=True)
        if dp > 1e-6 or do.max() > step_act:
            fail(f"the distributed read ({name}) disagrees with the read's "
                 "plain version")
    for mode, (cost, matches, pred) in prepared_want.items():
        ok = all(r["prepared"][mode][3] and np.array_equal(
            r["prepared"][mode][2], pred) and r["prepared"][mode][1] ==
            matches and math.isclose(r["prepared"][mode][0], cost,
                                     rel_tol=1e-6) for r in r22)
        print(f"[{tag}] sharded prepared infer, mode {mode}, B={BATCH}: cost "
              f"{r22[0]['prepared'][mode][0]:.6f} (single {cost:.6f}), "
              f"matches {r22[0]['prepared'][mode][1]} (single {matches}), "
              f"predictions equal on every rank: {ok}; distinct "
              f"{len(set(pred.tolist()))}", flush=True)
        if not ok:
            fail(f"the sharded prepared infer (mode {mode}) differs from the "
                 "single-device prepared forward")
    ok = all(np.array_equal(r["eval"][2], eval_want[2])
             and r["eval"][1] == eval_want[1]
             and math.isclose(r["eval"][0], eval_want[0], rel_tol=1e-6)
             for r in r22)
    print(f"[{tag}] eval_split(mesh=) on {len(split)} samples: err "
          f"{r22[0]['eval'][1]:.4f} (single {eval_want[1]:.4f}), cost "
          f"{r22[0]['eval'][0]:.6f} (single {eval_want[0]:.6f}), "
          f"predictions equal: {ok}", flush=True)
    if not ok:
        fail("eval_split(mesh=) differs from the single-device eval_split")
    answers, failed, chain = r22[0]["engine"]
    print(f"[{tag}] engine over the mesh: {len(answers)} answers, failed "
          f"waves {failed}, chain pinned off: {not chain}, equal to the "
          f"plain route: {answers == engine_want}, distinct "
          f"{len(set(answers))}", flush=True)
    if answers != engine_want or failed or chain:
        fail("the engine over the mesh differs from the plain route")
    n22 = summed(r22)

    # (1, 1): one rank over NCCL
    r11 = run_ranks(mesh_rank, 1, (1, 1, dev.type, inputs, False),
                    device=dev.type, timeout=300)
    print(f"[{tag}] (1, 1): backend {r11[0]['backend']}", flush=True)
    check_steps(r11, [MESH_STEPS[0][0]], ("sharded",))
    if dev.type == "cuda" and r11[0]["backend"] != "nccl":
        fail("a mesh of one rank with a card of its own is not on NCCL")
    n11 = summed(r11)
    at_mesh = check_recorded_calls(r22 + r11, dev, tag)
    print(f"[{tag}] launches, summed over ranks: (2, 2) {n22}; (1, 1) "
          f"{n11}.  The memory split runs the distributed read (no read "
          f"kernel); the mesh pins the plain prepared forward (no chain)",
          flush=True)
    if (n22["qmatvec"] < 1 or n22["hamming_score"] < 1 or n22["hop_chain"]
            or n11["qmatvec"] < 1 or n11["attention_read"] < 1):
        fail("the mesh path did not launch the lattice, the Hamming kernel "
             "or the read where it routes them")
    if any(n22[k] + n11[k] and k not in at_mesh for k in n22):
        fail("a kernel launched on the mesh path was not checked at its "
             "shapes there")
    print(f"[{tag}] {card} | sharded step, mode 2 iwl 5, B={TRAIN_BATCH}, "
          f"use_pallas: (1, 1) NCCL {r11[0]['step_ms']} ms, (2, 2) gloo on "
          f"one card {r22[0]['step_ms']} ms (CUDA events, median of 5 x 5 "
          f"steps; the 4 ranks share the card: not a scaling figure)",
          flush=True)

    # python -m qmann_tpu_torch --mesh 2,1 under torchrun
    tmp = tempfile.TemporaryDirectory(prefix="qmann_mesh_")
    out_dir = Path(tmp.name) / "cli"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "qmann_tpu_torch", "1", "1", "1",
           "5", "--mesh", "2,1", "--use-pallas", "--epochs", "2",
           "--data-path", data_path, "--raw-data-path", raw_path,
           "--out-dir", str(out_dir), "--device", dev.type]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    t_cli = time.perf_counter() - t0
    loops = [ln for ln in proc.stdout.splitlines() if "loop 0: err_test" in ln]
    rows = (csv_rows(out_dir / "result.csv")
            if (out_dir / "result.csv").exists() else [])
    banner = [ln for ln in proc.stdout.splitlines() if "< Mesh" in ln]
    print(f"[{tag}] torchrun --nproc-per-node 2 -m qmann_tpu_torch 1 1 1 5 "
          f"--mesh 2,1 --use-pallas --epochs 2: rc {proc.returncode}, "
          f"{t_cli:.1f} s; {banner}; result.csv tasks "
          f"{[r[0] for r in rows]}, loop lines {len(loops)} (rank 0 "
          f"alone); err_test {rows[0][10] if rows else None} beside the "
          f"single-process run's {single_err} (no gate: gradient sums in "
          f"another order can flip a requant over an epoch)", flush=True)
    if proc.returncode != 0 or [r[0] for r in rows] != ["1"] or \
            len(loops) != 1:
        print(proc.stdout[-3000:], proc.stderr[-3000:], flush=True)
        fail("the torchrun run of the CLI on a mesh failed")

    # the training-study tools
    env = {**__import__("os").environ, "PYTHONPATH": str(REPO)}
    scal = [sys.executable, "-m", "qmann_tpu_torch.bench.scaling",
            "--iters", "5", "--device", dev.type]
    one = subprocess.run([*scal, "--devices", "1"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    lines = [json.loads(ln) for ln in one.stdout.splitlines()
             if ln.startswith("{")]
    two = subprocess.run([*scal, "--devices", "2"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    print(f"[{tag}] bench.scaling --devices 1: rc {one.returncode}, "
          f"{lines}; --devices 2: rc {two.returncode} "
          f"({two.stderr.strip()[-120:]})", flush=True)
    want_two = 2 if torch.cuda.device_count() < 2 else 0
    if (one.returncode != 0 or len(lines) != 1
            or not lines[0]["train_samples_per_sec"] > 0
            or two.returncode != want_two):
        fail("bench.scaling failed")
    files = ["--data-path", data_path, "--raw-data-path", raw_path,
             "--device", str(dev)]
    rc_d, dlines = run_quiet(diagnose.main, ["--epochs", "2", *files],
                             keep=r"^\{")
    drecs = [json.loads(ln) for ln in dlines if ln.startswith("{")]
    rc_s, slines = run_quiet(scatt_study.main, [
        "--epochs", "2", "--seeds", "1", "--out-dir",
        str(Path(tmp.name) / "scatt"), *files], keep=r"^\{")
    srecs = [json.loads(ln) for ln in slines if ln.startswith("{")]
    finite = all(math.isfinite(v) for r in drecs + srecs
                 for v in r.values() if isinstance(v, float))
    print(f"[{tag}] bench.diagnose 2 epochs: rc {rc_d}, {len(drecs)} "
          f"records; bench.scatt_study 2 epochs x 1 seed: rc {rc_s}, "
          f"{len(srecs)} rows; every number finite: {finite}", flush=True)
    if (rc_d != 0 or len(drecs) != 2 or rc_s != 0
            or len(srecs) != len(scatt_study.MITIGATIONS) or not finite):
        fail("bench.diagnose or bench.scatt_study failed")
    tmp.cleanup()
    print(f"[{tag}] phase time {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {k: {"launches": n22[k], "ranks": 4, "mesh": [2, 2],
                "nccl_1x1": {"launches": n11[k], "ranks": 1,
                             "mesh": [1, 1]},
                **at_mesh.get(k, {"max_abs_err": None, "shapes": [],
                                  "signatures": 0})}
            for k in n22}


# ---------------------------------------------------------------------------
# 19. the captured programs (graphs.py) against the eager route
# ---------------------------------------------------------------------------

GRAPH_STEPS = (("mode 2 iwl 5, use_pallas", dict(use_pallas=True)),
               ("mode 3 iwl 1, use_pallas", dict(attention_mode=3, iwl=1,
                                                 use_pallas=True)),
               ("mode 3 iwl 1, use_pallas_hamming",
                dict(attention_mode=3, iwl=1, use_pallas_hamming=True)))
GRAPH_PAIRS = 5            # strictly alternating (eager, graphed) samples
GRAPH_TIMED_STEPS = 10     # steps per timing sample
GRAPH_ENGINE_REQUESTS, GRAPH_WAVE = 200, 64
KERNEL_KEYS = ("qmatvec", "attention_read", "hamming_score", "hop_chain")


def event_ms(fn):
    """CUDA-event ms of one fn() call, from an idle card."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def paired_ms(eager, graphed, per=1):
    """GRAPH_PAIRS strictly alternating samples of the two calls (eager
    first in even pairs, graphed first in odd), each over ``per`` units:
    {"eager": [ms per unit], "graphed": [...]}."""
    out = {"eager": [], "graphed": []}
    for i in range(GRAPH_PAIRS):
        order = (("eager", eager), ("graphed", graphed))
        for side, fn in (order if i % 2 == 0 else order[::-1]):
            out[side].append(event_ms(fn) / per)
    return out


def same_values(tag, what, got, want):
    """Graphed against eager: prints whether the values are bit-identical,
    and if not how many elements differ and by how much at most; fails
    unless they hold the parity contract's float32 tolerance for a
    multi-step run (rtol 1e-4, atol 1e-6).  got, want: tensors or dicts of
    tensors."""
    import torch
    pairs = ([(k, got[k], want[k]) for k in want] if isinstance(want, dict)
             else [(what, got, want)])
    n_diff = sum(int((g != w).sum()) for _, g, w in pairs)
    worst = max(float((g.double() - w.double()).abs().max()) if g.numel()
                else 0.0 for _, g, w in pairs)
    print(f"[19 graphs] {tag}: {what} bit-identical: {n_diff == 0}"
          + ("" if n_diff == 0 else f" ({n_diff} elements differ, largest "
             f"|difference| {worst:.3g})"), flush=True)
    if not all(torch.allclose(g.double(), w.double(), rtol=1e-4, atol=1e-6)
               for _, g, w in pairs):
        fail(f"the graphed {what} differ from the eager route's ({tag})")
    return n_diff


def phase_graphs(card, dev, data, serve_dims, dictionary, family):
    """Phase 19: train_epoch, dependent_batches, the engine's wave and
    multi_epoch as replayed CUDA graphs against the eager route.  Returns
    {kernel: {path: launches}} of the graphed paths."""
    import numpy as np
    import torch
    from qmann_tpu_torch import graphs as graphs_mod
    from qmann_tpu_torch.bench.common import dependent_batches
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_batch
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.serve import InferenceEngine, Request
    from qmann_tpu_torch.train import multi, train_epoch, train_step
    from qmann_tpu_torch.train.trainer import _batched_arrays
    tag = "19 graphs"
    t_phase = time.perf_counter()
    launches = {k: {} for k in KERNEL_KEYS}

    def ran(before):
        return dict(zip(KERNEL_KEYS, (a - b for a, b in zip(
            graphs_mod.launch_counts(), before))))

    def record(path, got):
        for k, v in got.items():
            launches[k][path] = v

    def per_call_busy(fn, per):
        kernels = device_ms(fn, n_iter=2)
        return (sum(ms for ms, _ in kernels.values()) / per,
                sum(n for _, n in kernels.values()) / per)

    # (a) train_epoch: two graphed epochs against the eager step loop
    batches = {k: torch.from_numpy(v).to(dev) for k, v in
               _batched_arrays(data.train, TRAIN_BATCH).items()}
    nb = batches["memory"].shape[0]
    timed = {k: v[:GRAPH_TIMED_STEPS].contiguous()
             for k, v in batches.items()}
    print(f"[{tag}] {card} | train epochs of {nb} steps at B={TRAIN_BATCH} "
          f"on phase 7's data", flush=True)
    for name, kw in GRAPH_STEPS:
        cfg = QmannConfig(verbose=False, **kw)
        lr = torch.tensor(cfg.learning_rate, device=dev)
        base = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg, data.dims, torch.Generator().manual_seed(SEED),
            device=dev).items()}
        p_e = {k: v.clone() for k, v in base.items()}
        cost_e = []
        before = graphs_mod.launch_counts()
        for _ in range(2):
            cost_e.append(torch.stack([train_step(
                p_e, {k: v[i] for k, v in batches.items()}, lr, cfg)[0]
                for i in range(nb)]).sum())
        torch.cuda.synchronize()
        eager_ran = ran(before)
        p_g = {k: v.clone() for k, v in base.items()}
        g = graphs_mod.Graphs(dev)
        before = graphs_mod.launch_counts()
        cost_g = [train_epoch(p_g, batches, lr, cfg, graphs=g)[1]
                  for _ in range(2)]
        torch.cuda.synchronize()
        graph_ran = ran(before)
        record(f"train {name}", graph_ran)
        (captured,) = g.graphs.values()
        per_replay = dict(zip(KERNEL_KEYS, captured.launches))
        per_step = {k: v / (2 * nb) for k, v in eager_ran.items()}
        print(f"[{tag}] {name}: launches in 2 epochs, graphed {graph_ran}, "
              f"eager {eager_ran}; per replay {per_replay} ({captured.replays}"
              f" replays, want {2 * nb - 1})", flush=True)
        if (graph_ran != eager_ran or per_replay != per_step
                or captured.replays != 2 * nb - 1):
            fail(f"the graphed epochs launched other kernels than the eager "
                 f"steps ({name})")
        same_values(name, "parameters after 2 epochs", p_g, p_e)
        same_values(name, "epoch costs", torch.stack(cost_g),
                    torch.stack(cost_e))
        # times: GRAPH_TIMED_STEPS steps per sample, pairs alternating
        p_te = {k: v.clone() for k, v in base.items()}
        p_tg = {k: v.clone() for k, v in base.items()}
        g_t = graphs_mod.Graphs(dev)

        def eager_steps():
            for i in range(GRAPH_TIMED_STEPS):
                train_step(p_te, {k: v[i] for k, v in timed.items()}, lr,
                           cfg)

        def graphed_steps():
            train_epoch(p_tg, timed, lr, cfg, graphs=g_t)

        eager_steps()
        graphed_steps()   # warm-up and capture
        t = paired_ms(eager_steps, graphed_steps, GRAPH_TIMED_STEPS)
        busy = {"eager": per_call_busy(eager_steps, GRAPH_TIMED_STEPS),
                "graphed": per_call_busy(graphed_steps, GRAPH_TIMED_STEPS)}
        print(f"[{tag}] {card} | train step, {name}: event ms per step "
              f"(median of {GRAPH_PAIRS} alternating pairs) eager "
              f"{statistics.median(t['eager']):.4f} "
              f"{[round(x, 4) for x in t['eager']]}, graphed "
              f"{statistics.median(t['graphed']):.4f} "
              f"{[round(x, 4) for x in t['graphed']]}; "
              + "; ".join(f"{side} busy {b:.4f} ms over {n:.1f} kernel "
                          f"records, idle share "
                          f"{1 - b / statistics.median(t[side]):.3f}"
                          for side, (b, n) in busy.items()), flush=True)

    # (b) bench.py's program: 30 dependent B=1000 batches on the chain
    V, M, W = 19, 10, 6   # qa1's shape, as phases 4 and 7
    for name, cfg in (("mode 2 iwl 5", QmannConfig(use_fused_chain=True)),
                      ("mode 3 iwl 5", QmannConfig(attention_mode=3,
                                                   use_fused_chain=True))):
        dims, mem, que, mask = synthetic_batch(np.random.default_rng(SEED),
                                               BATCH, V, M, W)
        _, _, prep = scaled_prepared(cfg, dims, mem, dev)
        args = [torch.from_numpy(a).to(dev) for a in (mem, que, mask)]

        def forward(m, q, k, prep=prep, cfg=cfg):
            return memn2n.forward_prepared(prep, m, q, k, cfg)

        want = dependent_batches(forward, *args, 30)
        g = graphs_mod.Graphs(dev)
        before = graphs_mod.launch_counts()
        got = [dependent_batches(forward, *args, 30, g) for _ in range(3)]
        torch.cuda.synchronize()
        graph_ran = ran(before)
        record(f"dependent_batches {name}", graph_ran)
        equal = all(torch.equal(x, want) for x in got)
        t = paired_ms(lambda: dependent_batches(forward, *args, 30),
                      lambda: dependent_batches(forward, *args, 30, g), 30)
        print(f"[{tag}] {card} | dependent_batches B={BATCH} K=30, {name}, "
              f"chain: predictions equal to the eager loop's: {equal}; "
              f"chain launches {graph_ran['hop_chain']} in 3 programs (want "
              f"90); ms per batch (median of {GRAPH_PAIRS} alternating "
              f"pairs) eager {statistics.median(t['eager']):.4f}, graphed "
              f"{statistics.median(t['graphed']):.4f}", flush=True)
        if not equal or graph_ran["hop_chain"] != 90:
            fail(f"the graphed dependent batches differ from the eager "
                 f"loop ({name})")

    # (c) the engine: waves of 64, the wave a replayed graph
    rng = np.random.default_rng(SEED)
    words = dictionary.words[1:]
    stories = [([[words[i] for i in rng.integers(0, len(words),
                                                 rng.integers(1, W + 1))]
                 for _ in range(rng.integers(1, M + 3))],
                [words[i] for i in rng.integers(0, len(words), 4)])
               for _ in range(GRAPH_ENGINE_REQUESTS)]
    cfg = QmannConfig(use_fused_chain=True)
    _, mem0, _, _ = synthetic_batch(rng, 8, V, M, W)
    _, params, _ = scaled_prepared(cfg, serve_dims, mem0, dev)
    eng = InferenceEngine(params, cfg, serve_dims, dictionary,
                          batch_size=GRAPH_WAVE, device=dev)
    before = graphs_mod.launch_counts()
    eng.start()
    try:
        answers = [f.result(timeout=300) for f in
                   [eng.submit(s, q) for s, q in stories]]
    finally:
        eng.stop()
    graph_ran = ran(before)
    record("engine", graph_ran)
    waves = [eng._vectorize([Request(s, q) for s, q in
                             stories[i:i + GRAPH_WAVE]])
             for i in range(0, len(stories), GRAPH_WAVE)]

    def eager_wave(wave):
        return eng._predict(*(torch.from_numpy(a).to(dev)
                              for a in wave)).cpu().numpy()

    want = [int(p) for i, w in enumerate(waves) for p in eager_wave(w)[
        :len(stories[i * GRAPH_WAVE:(i + 1) * GRAPH_WAVE])]]
    lat = {"eager": [], "graphed": []}
    for i in range(40):
        order = (("eager", eager_wave), ("graphed",
                                         lambda w: eng.infer(*w)))
        for side, fn in (order if i % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            fn(waves[i % len(waves)])
            lat[side].append(1e3 * (time.perf_counter() - t0))
    print(f"[{tag}] {card} | engine, {len(stories)} requests in waves of "
          f"{GRAPH_WAVE}: {eng.stats.waves} waves, failed "
          f"{eng.stats.failed_waves}, chain launches "
          f"{graph_ran['hop_chain']}; answers equal to the eager forward's: "
          f"{answers == want}; wave ms (host clock, to the predictions on "
          f"the host, 40 waves each, alternating) eager p50 "
          f"{np.percentile(lat['eager'], 50):.4f} p99 "
          f"{np.percentile(lat['eager'], 99):.4f}, graphed p50 "
          f"{np.percentile(lat['graphed'], 50):.4f} p99 "
          f"{np.percentile(lat['graphed'], 99):.4f}", flush=True)
    if (answers != want or eng.stats.failed_waves
            or graph_ran["hop_chain"] != eng.stats.waves):
        fail("the graphed engine's answers or launches differ from the "
             "eager route's")

    # (d) the R = 200 family through multi_epoch, graphed and eager
    fam, seeds, stacked, cfg16 = family
    epoch_s = {"graphed": [], "eager": []}
    res = {}
    real_epoch, real_runner = multi.multi_epoch, multi._runner
    for side in ("graphed", "eager"):
        def timed_epoch(*a, **kw):
            t0 = time.perf_counter()
            out = real_epoch(*a, **kw)
            torch.cuda.synchronize()
            epoch_s[side].append(time.perf_counter() - t0)
            return out

        multi.multi_epoch = timed_epoch
        if side == "eager":
            multi._runner = lambda graphs, cfg: multi._eager
        before = graphs_mod.launch_counts()
        try:
            res[side] = multi.train_tasks_multi(cfg16, fam, seeds,
                                                params=stacked, device=dev)
        finally:
            multi.multi_epoch, multi._runner = real_epoch, real_runner
        if side == "graphed":
            record("family", ran(before))
    same_values(f"family R={stacked['A'].shape[0]}", "parameters after "
                f"{cfg16.num_itr} epochs", res["graphed"].params,
                res["eager"].params)
    hist_equal = all(np.array_equal(a[k], b[k]) for a, b in zip(
        res["graphed"].history, res["eager"].history)
        for k in ("cost_train", "err_train", "cost_valid", "err_valid"))
    print(f"[{tag}] {card} | family R={stacked['A'].shape[0]} epoch seconds "
          f"(host clock, validation included; the first graphed epoch "
          f"warms up and captures): graphed "
          f"{[round(x, 4) for x in epoch_s['graphed']]}, eager "
          f"{[round(x, 4) for x in epoch_s['eager']]}; histories "
          f"bit-identical: {hist_equal}", flush=True)
    print(f"[{tag}] {time.perf_counter() - t_phase:.1f} s", flush=True)
    return launches


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
    serve_src = (out / "qa1_single-supporting-fact_loop0", data_path,
                 raw_path)   # phase 17 serves this model on these files

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

    def epoch_spy(params, batches, lr, cfg, remove_softmax=False, **kw):
        before = counts()
        out = epoch_real(params, batches, lr, cfg, remove_softmax, **kw)
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

    # 16. the family trainer: R = (tasks x seeds) runs as one stacked step
    # (train/multi.py) at the flagship widths and megasweep's padded layout
    import tempfile
    from qmann_tpu_torch.bench import megasweep
    from qmann_tpu_torch.train import multi, train_task

    V16, M16, W16 = FAMILY_LAYOUT
    rng16 = np.random.default_rng(SEED + 16)
    t0 = time.perf_counter()
    pool = synthetic_task(rng16, 2000, 4 * FAMILY_VALID, 4 * FAMILY_TEST,
                          V16, M16, W16)
    # train sizes 905..1000 in a shuffled order: the shortest task sits
    # mid-family, and the shorter tasks meet all-padding batches
    sizes = [1000 - 5 * ((7 * t) % FAMILY_TASKS)
             for t in range(FAMILY_TASKS)]
    fam = family_tasks(rng16, pool, sizes)
    seeds16 = list(range(FAMILY_SEEDS))
    run_task = [t for t in fam for _ in seeds16]
    run_seed = [s for _ in fam for s in seeds16]
    R16 = len(run_task)
    dims16 = pool.dims
    cfg16 = QmannConfig(use_pallas=True, num_itr=2, verbose=False)
    fw16 = cfg16.fmt_w
    inits = [memn2n.init_params(cfg16, dims16,
                                torch.Generator().manual_seed(s), device=dev)
             for s in run_seed]
    stacked = {k: torch.stack([4.0 * p[k] for p in inits]) for k in inits[0]}
    nb16 = math.ceil(max(sizes) / TRAIN_BATCH)
    shortest = sizes.index(min(sizes)) + 1
    sampled = [0, R16 - 1,
               run_task.index(shortest) + min(3, FAMILY_SEEDS - 1)]
    print(f"[16 family] {card} | run.sh family: {FAMILY_TASKS} tasks x "
          f"{FAMILY_SEEDS} seeds = {R16} runs, train sizes {min(sizes)}.."
          f"{max(sizes)} ({nb16} batches of {TRAIN_BATCH}), valid and test "
          f"{FAMILY_VALID} each, V={V16} M={M16} (dim_input "
          f"{dims16.dim_input}), weights x4; sampled runs {sampled} (task "
          f"{[run_task[r] for r in sampled]}); data made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # (a) the R-axis lattice at the family's memory embedding against its
    # stacked plain version, each rounding mode and the binary formats
    lr16 = torch.tensor(cfg16.learning_rate, dtype=torch.float32,
                        device=dev)
    batch16, _ = family_batch(fam, run_task, 0, TRAIN_BATCH, dev)
    rows16 = batch16["memory"].reshape(R16, -1, dims16.dim_input)
    f0 = fw16[0]
    fam_cases = ([(f"round {rm}", QFormat(f0.iwl, f0.frac, rm),
                   QFormat(f0.iwl, f0.frac, rm)) for rm in ROUND_MODES]
                 + [("binary w", QFormat(0, 0, f0.mode), f0),
                    ("binary x", f0, QFormat(0, 0, f0.mode))])
    fam_err, unequal = 0.0, []
    for label, f_w, f_x in fam_cases:
        got = qmv.quantized_matvec(stacked["A"], rows16, f_w, f_x)
        want = qmv.quantized_matvec_reference(stacked["A"], rows16, f_w, f_x)
        fam_err = max(fam_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            unequal.append(label)
        del got, want
    torch.cuda.synchronize()
    print(f"[16 family] R-axis lattice w {tuple(stacked['A'].shape)} x "
          f"{tuple(rows16.shape)}: {len(fam_cases)} calls (rounding modes "
          f"{ROUND_MODES}, binary w and x); not bit-identical: "
          f"{', '.join(unequal) or 'none'}", flush=True)
    if unequal:
        fail("the family's lattice differs from its stacked plain version")

    # (b) the family's 2 epochs; a spy in family_step's place reads the
    # launch counts around each step
    zero_counts()
    res16, steps16, total16 = run_family(multi, cfg16, fam, seeds16, dev,
                                         counts, params=stacked)
    n_chunks16 = (cfg16.num_itr * math.ceil(FAMILY_VALID / 128)
                  + math.ceil(FAMILY_TEST / 128))
    n_fwd16 = cfg16.num_itr * nb16 + n_chunks16
    step_want = want_counts(qmatvec=10, attention_read=3)
    want16 = want_counts(qmatvec=10 * n_fwd16, attention_read=3 * n_fwd16)
    odd = [i for i, c in enumerate(steps16) if c != step_want]
    print(f"[16 family] train_tasks_multi, {cfg16.num_itr} epochs: "
          f"{len(steps16)} family steps (want {cfg16.num_itr * nb16}), "
          f"steps launching other than {step_want}: {odd or 'none'}; whole "
          f"run {total16} (want {want16}, eval chunks of 128 included); "
          f"train {res16.time_train:.3f} s, test {res16.time_test:.3f} s; "
          f"mean err_test {float(res16.err_test.mean()):.4f}", flush=True)
    if len(steps16) != cfg16.num_itr * nb16 or odd or total16 != want16:
        fail("a family step launched other kernels than one run's step")
    if not family_finite(res16):
        fail("the family gave a cost that is not finite")

    # (c) one family SGD step against the single-run step of the sampled
    # runs, on the first batch and on the last (a partial batch for the
    # longest task, all padding for the shorter ones)
    for i in (0, nb16 - 1):
        fb, padding = family_batch(fam, run_task, i, TRAIN_BATCH, dev)
        p_fam = {k: v.clone() for k, v in stacked.items()}
        multi.family_step(p_fam, fb, lr16, cfg16, padding_runs=padding)
        for r in sampled:
            if r in padding:
                same = all(torch.equal(p_fam[k][r], v[r])
                           for k, v in stacked.items())
                print(f"[16 family] batch {i}, run {r}: all padding, "
                      f"weights untouched: {same}", flush=True)
                if not same:
                    fail("an all-padding batch changed its run's weights")
                continue
            p_r = {k: v[r].clone() for k, v in stacked.items()}
            train_step(p_r, {k: v[r] for k, v in fb.items()}, lr16, cfg16)
            diff = max(float((p_fam[k][r] - v).abs().max())
                       for k, v in p_r.items())
            print(f"[16 family] batch {i}, run {r} "
                  f"({int(fb['size_b'][r])} live samples): family step "
                  f"against train_step, max |difference| {diff:.3g}",
                  flush=True)
            if not all(torch.allclose(p_fam[k][r], v, rtol=1e-5, atol=1e-6)
                       for k, v in p_r.items()):
                fail("a family step differs from the single-run step")

    # (d) the sampled runs' 2-epoch histories against train_task
    single_epoch_s = []
    for r in sampled:
        ref = train_task(cfg16.replace(seed=run_seed[r]), fam[run_task[r]],
                         params={k: v[r] for k, v in stacked.items()},
                         device=dev)
        single_epoch_s.append(ref.time_train / len(ref.history))
        got = [[h[k][r] for k in ("err_train", "err_valid", "cost_train",
                                  "cost_valid")] for h in res16.history]
        want = [[h.err_train, h.err_valid, h.cost_train, h.cost_valid]
                for h in ref.history]
        errs_equal = (np.allclose(np.array(got)[:, :2], np.array(want)[:, :2],
                                  rtol=0, atol=1e-6)
                      and abs(res16.err_test[r] - ref.err_test) <= 1e-6)
        cost_diff = float(np.max(np.abs(np.array(got)[:, 2:]
                                        - np.array(want)[:, 2:])
                                 / np.abs(np.array(want)[:, 2:])))
        print(f"[16 family] run {r} (task {run_task[r]}, seed "
              f"{run_seed[r]}): family (err_train, err_valid, cost_train, "
              f"cost_valid) per epoch {np.array(got).round(6).tolist()}, "
              f"err_test {res16.err_test[r]:.4f}; train_task "
              f"{np.array(want).round(6).tolist()}, err_test "
              f"{ref.err_test:.4f}; errors equal {errs_equal}, largest cost "
              f"rel. difference {cost_diff:.3g}", flush=True)
        if not (errs_equal and cost_diff <= 2e-4):
            fail("a sampled run's history differs from its train_task")

    # (e) findings: the family's epoch against R single-run epochs, the
    # step's event and busy time, and the kernels at the family's shapes
    fam_epoch = res16.time_train / len(res16.history)
    one_epoch = statistics.median(single_epoch_s)
    print(f"[16 family] {card} | epoch seconds (host clock, validation "
          f"included): family {fam_epoch:.3f} s for {R16} runs; single run "
          f"{one_epoch:.3f} s (median of {len(sampled)}) x {R16} = "
          f"{one_epoch * R16:.2f} s: {one_epoch * R16 / fam_epoch:.1f}x",
          flush=True)
    p_t = {k: v.clone() for k, v in stacked.items()}
    p_s = {k: v[0].clone() for k, v in stacked.items()}
    b_one = {k: v[0] for k, v in batch16.items()}
    time_steps({f"family step R={R16}": lambda: multi.family_step(
                    p_t, batch16, lr16, cfg16),
                "single-run step": lambda: train_step(p_s, b_one, lr16,
                                                      cfg16)},
               "16 family", card=card)
    # the kernels at the shapes the family's path gives them: the lattice
    # and the read at a training batch (R x 32 queries) and at an eval
    # chunk (R x 128), each held against its plain version
    fam_args = (stacked["A"], rows16, f0, f0)
    wide_args = (stacked["A"][0].contiguous(), rows16[0].contiguous(), f0, f0)
    ev16, _ = family_batch(fam, run_task, 0, 128, dev, split="valid")
    rows_ev16 = ev16["memory"].reshape(R16, -1, dims16.dim_input)
    ev_args = (stacked["A"], rows_ev16, f0, f0)
    ev_err, unequal = 0.0, []
    for f_h in sorted(set(fw16[:cfg16.num_hops]), key=str):
        got = qmv.quantized_matvec(stacked["A"], rows_ev16, f_h, f_h)
        want = qmv.quantized_matvec_reference(stacked["A"], rows_ev16, f_h,
                                              f_h)
        ev_err = max(ev_err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            unequal.append(str(f_h))
        del got, want
    print(f"[16 family] R-axis lattice at an eval chunk, w "
          f"{tuple(stacked['A'].shape)} x {tuple(rows_ev16.shape)}, each hop "
          f"format: max|diff| {ev_err:.3g}; not bit-identical: "
          f"{', '.join(unequal) or 'none'}", flush=True)
    if unequal:
        fail("the family's lattice differs from its stacked plain version "
             "at an eval chunk")
    read_fmts = (cfg16.fmt_att[0], cfg16.fmt_bin, cfg16.fmt_act[0])
    read16 = family_read_inputs(stacked, cfg16, batch16) + read_fmts
    read_ev16 = family_read_inputs(stacked, cfg16, ev16) + read_fmts
    read16_err = {}
    for label, args in (("training batch", read16), ("eval chunk", read_ev16)):
        diffs, flips, good, _ = check_read(ar.fused_read(*args),
                                           ar.fused_read_reference(*args),
                                           cfg16.fmt_act[0], True)
        read16_err[label] = max(diffs.values())
        print(f"[16 family] the read at the folded {label}, B={R16}x"
              f"{args[0].shape[0] // R16}={args[0].shape[0]}: max|diff| "
              + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
              + f"; flipped Q(p, act) queries {flips}", flush=True)
        if not good:
            fail(f"the read kernel disagrees with its plain version at the "
                 f"family's {label}")
    with torch.inference_mode():
        t16 = {name: (cuda_ms(fn, n_iter=n), cuda_ms(plain, n_iter=n_p,
                                                     samples=s_p),
                      recorded_ms(fn))
               for name, (fn, plain, n, n_p, s_p) in {
                   "family": (lambda: qmv.quantized_matvec(*fam_args),
                              lambda: qmv.quantized_matvec_reference(
                                  *fam_args), 5, 1, 3),
                   "family eval": (lambda: qmv.quantized_matvec(*ev_args),
                                   lambda: qmv.quantized_matvec_reference(
                                       *ev_args), 5, 1, 3),
                   "wide": (lambda: qmv.quantized_matvec(*wide_args),
                            lambda: qmv.quantized_matvec_reference(
                                *wide_args), 20, 20, 7),
                   "read": (lambda: ar.fused_read(*read16),
                            lambda: ar.fused_read_reference(*read16),
                            20, 20, 7),
                   "read eval": (lambda: ar.fused_read(*read_ev16),
                                 lambda: ar.fused_read_reference(
                                     *read_ev16), 20, 5, 7)}.items()}
    b16 = {"family": qmatvec_bound(*fam_args[:2]),
           "family eval": qmatvec_bound(*ev_args[:2]),
           "wide": qmatvec_bound(*wide_args[:2]),
           "read": attention_read_bound(*read16[:4]),
           "read eval": attention_read_bound(*read_ev16[:4])}
    for name, desc in (
            ("family", f"lattice R={R16} x {rows16.shape[1]} rows, "
                       f"I={dims16.dim_input}"),
            ("family eval", f"lattice R={R16} x {rows_ev16.shape[1]} rows, "
                            f"I={dims16.dim_input}"),
            ("wide", f"lattice {rows16.shape[1]} rows (one run), "
                     f"I={dims16.dim_input}"),
            ("read", f"read B={read16[0].shape[0]}, M={M16}"),
            ("read eval", f"read B={read_ev16[0].shape[0]}, M={M16}")):
        (t_k, t_p, t_dev), b = t16[name], b16[name]
        dev_txt = ("not measured (the profiler kept no record)"
                   if t_dev is None else
                   f"{t_dev:.4f} ms, {b[0] / t_dev:.1%} of the bound")
        print(f"[16 family] {card} | {desc}: kernel {t_k:.4f} ms (device "
              f"{dev_txt}), plain {t_p:.4f} ms, bound {b[0]:.4f} ms "
              f"({b[1]})", flush=True)

    # (f) the sweep_fixed.sh family: mode 3 at iwl 1, 20 tasks x 2 seeds,
    # 1 epoch, on the mode-3 read and on the Hamming kernel
    fam3_launches = {}
    for label, kw, step_want in (
            ("use_pallas", dict(use_pallas=True),
             want_counts(qmatvec=10, attention_read=3)),
            ("use_pallas_hamming", dict(use_pallas_hamming=True),
             want_counts(hamming_score=3))):
        cfg_f3 = QmannConfig(iwl=1, attention_mode=3, num_itr=1,
                             verbose=False, **kw)
        zero_counts()
        tally3, restore = fast_path_tally(memn2n)
        try:
            res3, steps3, total3 = run_family(multi, cfg_f3, fam, [0, 1],
                                              dev, counts)
        finally:
            restore()
        n_fwd3 = nb16 + math.ceil(FAMILY_VALID / 128) + math.ceil(
            FAMILY_TEST / 128)
        want3 = {k: v * n_fwd3 for k, v in step_want.items()}
        odd3 = [i for i, c in enumerate(steps3) if c != step_want]
        fam3_launches[label] = total3
        print(f"[16 family] sweep_fixed family, mode 3 iwl 1, {label}: "
              f"{len(res3.err_test)} runs, {len(steps3)} steps, odd steps "
              f"{odd3 or 'none'}, launches {total3} (want {want3}); fast "
              f"path (weight, run) pairs {tally3}; train "
              f"{res3.time_train:.3f} s; mean err_test "
              f"{float(res3.err_test.mean()):.4f}", flush=True)
        if odd3 or total3 != want3 or not family_finite(res3):
            fail(f"the mode-3 family ({label}) launched other counts than "
                 "expected or gave a cost that is not finite")

    # the mode-3 read and the Hamming kernel at the sweep_fixed family's
    # folded batches (R x 32 queries at training, R x 128 at an eval
    # chunk), on the family's initial weights and, for the Hamming kernel,
    # also on the edge inputs of phase 9, against their plain versions
    cfg_f3 = QmannConfig(iwl=1, attention_mode=3, verbose=False)
    run_task3 = [t for t in fam for _ in (0, 1)]
    p3 = multi._initial_params(cfg_f3, dims16,
                               [s for _ in fam for s in (0, 1)], None, dev)
    fa3 = cfg_f3.fmt_att[0]
    ham_kw3 = (cfg_f3.num_bits_attention, cfg_f3.attention_const_scale,
               cfg_f3.hamming_weight_para, cfg_f3.hamming_weighted)
    read3_err, ham3_err, fam3_args = 0.0, 0.0, {}
    for label, bs, split in (("train", TRAIN_BATCH, "train"),
                             ("eval", 128, "valid")):
        b3, _ = family_batch(fam, run_task3, 0, bs, dev, split=split)
        m3, c3, u3, mask3 = family_read_inputs(p3, cfg_f3, b3)
        r_args = (m3, c3, u3, mask3, fa3, cfg_f3.fmt_bin, cfg_f3.fmt_act[0],
                  False, cfg_f3.wsum_quantized, 3, *ham_kw3)
        diffs, flips, good, _ = check_read(ar.fused_read(*r_args),
                                           ar.fused_read_reference(*r_args),
                                           cfg_f3.fmt_act[0], True)
        read3_err = max(read3_err, *diffs.values())
        h_cases = {"family": (m3, u3)}
        h_cases["edge"] = tuple(torch.from_numpy(a).to(dev) for a in
                                ham_inputs(rng16, fa3.iwl, *m3.shape))
        unequal = []
        for name, (m, u) in h_cases.items():
            h_args = (m, u, fa3.iwl, ham_kw3[0], ham_kw3[1], fa3.mode,
                      *ham_kw3[2:])
            got = ham.hamming_score_kernel(*h_args)
            want = ham.hamming_score_reference(*h_args)
            ham3_err = max(ham3_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                unequal.append(name)
        fam3_args[label] = (r_args, (m3, u3) + h_args[2:])
        print(f"[16 family] sweep_fixed family's folded {label} batch "
              f"B={m3.shape[0]} M={m3.shape[1]} D={m3.shape[2]}: mode-3 read "
              f"max|diff| " + ", ".join(f"{k} {v:.3g}"
                                        for k, v in diffs.items())
              + f", flipped Q(p, act) queries {flips}; Hamming kernel (family "
              f"and edge inputs) not bit-identical: "
              f"{', '.join(unequal) or 'none'}", flush=True)
        if not good or unequal:
            fail(f"the mode-3 read or the Hamming kernel disagrees with its "
                 f"plain version at the sweep_fixed family's {label} batch")
    with torch.inference_mode():
        t3 = {(k, label): (cuda_ms(fn, n_iter=20),
                           cuda_ms(plain, n_iter=2, samples=3),
                           recorded_ms(fn))
              for label, (r_args, h_args) in fam3_args.items()
              for k, (fn, plain) in {
                  "read": (lambda a=r_args: ar.fused_read(*a),
                           lambda a=r_args: ar.fused_read_reference(*a)),
                  "hamming": (lambda a=h_args: ham.hamming_score_kernel(*a),
                              lambda a=h_args: ham.hamming_score_reference(
                                  *a))}.items()}
    b3 = {(k, label): (attention_read_bound(*r_args[:4],
                                            num_bit=ham_kw3[0])
                       if k == "read" else
                       hamming_bound(*h_args[:2], num_bit=ham_kw3[0]))
          for label, (r_args, h_args) in fam3_args.items()
          for k in ("read", "hamming")}
    for (k, label), (t_k, t_p, t_dev) in t3.items():
        b = b3[k, label]
        dev_txt = ("not measured (the profiler kept no record)"
                   if t_dev is None else
                   f"{t_dev:.4f} ms, {b[0] / t_dev:.1%} of the bound")
        print(f"[16 family] {card} | mode-3 {k} B="
              f"{fam3_args[label][0][0].shape[0]}, M={M16}: kernel "
              f"{t_k:.4f} ms (device {dev_txt}), plain {t_p:.4f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]})", flush=True)

    # (g) megasweep's main() at its default route (the integer fast path,
    # no use_pallas) on seeded bAbI-format files of the family's tasks
    # (1-20) and seeds (0-9): R = 200
    tmp16 = tempfile.TemporaryDirectory(prefix="qmann_mega_")
    root16 = Path(tmp16.name)
    data16, raw16 = write_synthetic_corpus(
        str(root16), np.random.default_rng(SEED),
        list(range(1, FAMILY_TASKS + 1)), *CLI_STORIES, joint=False)
    zero_counts()
    tally16, restore = fast_path_tally(memn2n)
    t0 = time.perf_counter()
    try:
        rc, _ = run_quiet(megasweep.main, [
            "--tasks", f"1-{FAMILY_TASKS}", "--seeds",
            f"0-{FAMILY_SEEDS - 1}", "--epochs", "1", "--data-path", data16,
            "--raw-data-path", raw16, "--out-dir", str(root16 / "mega"),
            "--device", str(dev)], keep=r"ITR|sweep_mean")
    finally:
        restore()
    wall16 = time.perf_counter() - t0
    mega = root16 / "mega"
    summary16 = json.loads((mega / "summary.json").read_text())
    meta16 = json.loads((mega / "meta.json").read_text())
    hist16 = np.load(mega / "history.npz")
    mega_finite = all(np.isfinite(hist16[f"iwl5_{k}"]).all()
                      for k in ("cost_train", "cost_valid"))
    mega_counts = counts()
    print(f"[16 family] {card} | megasweep.main, default route: rc {rc}, "
          f"{len(summary16)} summary rows of "
          f"{len(summary16[0]['errs']) if summary16 else 0} seeds, "
          f"{meta16['stages'][0]['runs']} runs, train "
          f"{meta16['stages'][0]['time_train']:.3f} s, {wall16:.2f} s in "
          f"all; kernel launches {mega_counts}; the integer fast path's "
          f"(weight, run) pairs: {tally16['gemm']} on the GEMM, "
          f"{tally16['lattice']} on the slow branch; "
          f"costs finite {mega_finite}", flush=True)
    if (rc != 0 or len(summary16) != FAMILY_TASKS
            or any(len(r["errs"]) != FAMILY_SEEDS for r in summary16)
            or meta16["stages"][0]["runs"] != R16 or not mega_finite
            or mega_counts != want_counts()):
        fail("megasweep's default route failed, launched a kernel or gave "
             "a cost that is not finite")
    tmp16.cleanup()

    # 17. the packet server and client in front of the chain kernel, the
    # engine's unprepared route, and the serving bench tools
    serve17 = phase_serve(card, dev, counters, *serve_src)

    # 18. the device mesh: sharded and explicit steps, the distributed
    # read, serving and evaluation over a mesh of ranks on the card, the
    # CLI under torchrun, and the training-study tools
    mesh18 = phase_mesh(card, dev, data_path, raw_path,
                        rows["result.csv"][0][10])
    tmp.cleanup()

    # 19. the captured programs against the eager route
    graphs19 = phase_graphs(card, dev, data, serve_dims, dictionary,
                            (fam, seeds16, stacked, cfg16))

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
    def fam3_shapes(kname):
        """The kernels-line entries of kname at the sweep_fixed family's
        folded batches: times, and the bound from that batch's inputs."""
        return {label: {"batch": int(fam3_args[label][0][0].shape[0]),
                        "ms": t3[kname, label][0],
                        "plain_ms": t3[kname, label][1],
                        "device_ms": t3[kname, label][2],
                        "bound_ms": b3[kname, label][0],
                        "bound_by": b3[kname, label][1]}
                for label in fam3_args}
    kernels_line = [
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
         "serve": {"added_in": 9, **serve17["serve_mode2"],
                   "mode3": serve17["serve_mode3"]},
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
         "serve_unprepared": {"added_in": 9,
                              "launches": serve17["unprepared"]["qmatvec"],
                              "waves": serve17["unprepared"]["waves"]},
         "features": {k: v["qmatvec"] for k, v in feature_launches.items()},
         "tiled_in": 6, "tiled_max_abs_err": tiled_err,
         "cli_launches": cli_qmv, "joint_launches": joint_qmv,
         "family": {"extended_in": 8, "runs": R16,
                    "rows": int(rows16.shape[1]),
                    "dim_input": dims16.dim_input,
                    "launches": total16["qmatvec"],
                    "mode3_launches": fam3_launches["use_pallas"]["qmatvec"],
                    "max_abs_err": max(fam_err, ev_err),
                    "ms": t16["family"][0], "plain_ms": t16["family"][1],
                    "device_ms": t16["family"][2],
                    "bound_ms": b16["family"][0],
                    "bound_by": b16["family"][1], "library_ms": None,
                    "eval": {"rows": int(rows_ev16.shape[1]),
                             "max_abs_err": ev_err,
                             "ms": t16["family eval"][0],
                             "plain_ms": t16["family eval"][1],
                             "device_ms": t16["family eval"][2],
                             "bound_ms": b16["family eval"][0],
                             "bound_by": b16["family eval"][1]}},
         "wide": {"rows": int(wide_args[1].shape[0]),
                  "dim_input": dims16.dim_input, "ms": t16["wide"][0],
                  "plain_ms": t16["wide"][1], "device_ms": t16["wide"][2],
                  "bound_ms": b16["wide"][0], "bound_by": b16["wide"][1]},
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
         "serve_unprepared": {
             "added_in": 9,
             "launches": serve17["unprepared"]["attention_read"],
             "waves": serve17["unprepared"]["waves"]},
         "features": {k: v["attention_read"]
                      for k, v in feature_launches.items()},
         "family": {"batch": int(read16[0].shape[0]),
                    "launches": total16["attention_read"],
                    "max_abs_err": max(read16_err.values()),
                    "ms": t16["read"][0], "plain_ms": t16["read"][1],
                    "device_ms": t16["read"][2], "bound_ms": b16["read"][0],
                    "bound_by": b16["read"][1],
                    "eval": {"batch": int(read_ev16[0].shape[0]),
                             "max_abs_err": read16_err["eval chunk"],
                             "ms": t16["read eval"][0],
                             "plain_ms": t16["read eval"][1],
                             "device_ms": t16["read eval"][2],
                             "bound_ms": b16["read eval"][0],
                             "bound_by": b16["read eval"][1]},
                    "mode3": {"launches": fam3_launches["use_pallas"][
                        "attention_read"], "max_abs_err": read3_err,
                        **fam3_shapes("read")}},
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
         "family": {"launches": fam3_launches["use_pallas_hamming"][
             "hamming_score"], "max_abs_err": ham3_err,
             **fam3_shapes("hamming")},
         **at_shapes(k3, "hamming", ham_args,
                     lambda a: hamming_bound(*a[:2], num_bit=nb3))},
    ]
    for entry in kernels_line:
        entry["mesh"] = {"added_in": 10, **mesh18[entry["name"]]}
        entry["graphs"] = {"added_in": 11,
                           "launches": graphs19[entry["name"]]}
    print(json.dumps({"kernels": kernels_line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
