"""The inputs, checks, timers and bounds that scripts/kernel_times.py and
step_times.py share.  They load this file by its path in this checkout
and import qmann_tpu_torch from the checkout they time, so that two
commits are timed and checked by the same code.  Nothing here runs when
the module is imported.

Tolerances.  Chain (as tests/test_torch_chain.py) and mode-2 attention
read: the scores bit-identical (hop 0's, for the chain); p within atol
1e-6 (exp and the softmax sum differ by an ulp between implementations);
at most 1 query per comparison in which a Q(p, act) requant flipped,
every other query bit-identical.  Mode-1 read: rtol 1e-5, atol 1e-6
(float sums in another order).  Mode-3 read: as mode 2.  Surrogate
backward: dm bit-identical (one product of the same two floats); du
within 2*M*2^-24*sum_r|grad_appx*g| (an M-term float32 sum in another
order).  Weighted-sum backward: dc bit-identical (the same chain of
roundings); dp bit-identical where every partial sum is exact (words of
up to 16 bits at D <= 256, the binary format), elsewhere within
dp_interval.  Its ds entry: dc bit-identical; ds within ds_bound.

bound_ms is the larger of the bytes the call must move (each input read
once, each output written once) over 3.35 TB/s and its operations over
67 TFLOP/s (float32 outside the tensor cores; H100 SXM data sheet at
700 W), counting 4 operations per float_quant (scale, convert, rescale,
saturate), 1 per multiply or add and 4 per softmax element.  The lattice
is counted on the products its inputs need: a multiply, a requant and an
add per nonzero entry of x and output; its dense bound counts every
product of the dense lattice.  The Hamming score's work is the
least the function needs, each operation on the pipe of its type: one
encode of 6 integer operations per element of m and per element of u
(once per query); per element pair the preprocess of 8 integer
operations, the match word's 2 and its conversion to float (the word read
as a fixed-point fraction up to num_bit 25) or popcount (the unweighted
count), 2 for the sign, and 6 float operations: the scale, the row sum
and the term's requant; above num_bit 25 the word would round, so the
match is a loop of 1 integer and 2 float operations per compared bit.
Integer operations count against the int32 rate, 64 results per clock
per SM (the CUDA C++ Programming Guide's throughput table for compute
capability 9.0) at 132 SMs and the 1980 MHz max SM clock: 16.7 TOP/s.
Population counts, leading-zero counts and conversions issue at 16 per
clock per SM (4.18 TOP/s), on a pipe of their own.  The surrogate
backward moves m, u and g once and writes dm and du once; its work is
counted in the kernel's closed form (csrc/hamming_bwd.cu): the two
encodes, per element pair the preprocess of 8 and 15 integer operations,
a popcount and a leading-zero count, and 5 float operations.  The
weighted-sum backward moves c, p, the mask and g once and writes dc and
dp once (and the cotangents of p and the scores once each, when given);
in its quantized instance, per element it does two products, four
requants, the mask multiply and the add, per query the requants of g's
row and p's row, per row dp's Q_fo and mask; each requant is 3 float
operations and one rounding, on the conversion pipe; in its float
instance, per element a product and a multiply-add, per row p*mask and
dp's mask; the softmax epilogue adds per row p*dp, the add into S, the
subtraction, the product and an add per cotangent.
"""
import statistics
import subprocess
import sys

SEED = 0
TRAIN_BATCH = 32
DEVICE = "cuda:0"
PAIRS = 5      # strictly alternating (eager, graphed) samples of paired_ms
HBM_BYTES_PER_S, F32_OPS_PER_S = 3.35e12, 67e12
# integer pipes of an H100 SXM: results per clock per SM from the CUDA C++
# Programming Guide's arithmetic-throughput table for compute capability
# 9.0 (32-bit add, logic, shift, compare, multiply: 64; population count,
# leading-zero count: 16), at 132 SMs and the 1980 MHz max SM clock
SMS, SM_CLOCK_HZ = 132, 1.98e9
INT32_OPS_PER_S = 64 * SMS * SM_CLOCK_HZ      # 16.7 TOP/s
POPC_OPS_PER_S = 16 * SMS * SM_CLOCK_HZ       # 4.18 TOP/s
Q_OPS = 4     # operations counted per float_quant
HAM_WORD_MAX_BIT = 25   # the match word is exact as a fraction up to here
# the run.sh family's layout: 20 tasks, megasweep's pad_dict and pad_line
FAMILY_TASKS = 20
FAMILY_LAYOUT = (64, 50, 6)
FAMILY_VALID = FAMILY_TEST = 100


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    """nvidia-smi's name and power limit of the card."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        fail(f"nvidia-smi: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timers
# ---------------------------------------------------------------------------

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


def plain_ms(fn, big=False):
    """cuda_ms of a kernel's plain version: 3 samples of 2 calls where its
    inputs are big (a call there takes up to a quarter second), else 7 of
    10."""
    return cuda_ms(fn, n_iter=2 if big else 10, samples=3 if big else 7)


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
    in some runs), so a division by the calls under-reads."""
    return max((ms / n for ms, n in kernels.values() if n > 0),
               default=float("nan"))


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
    """PAIRS strictly alternating samples of the two calls (eager first in
    even pairs, graphed first in odd), each over ``per`` units:
    {"eager": [ms per unit], "graphed": [...]}."""
    out = {"eager": [], "graphed": []}
    for i in range(PAIRS):
        order = (("eager", eager), ("graphed", graphed))
        for side, fn in (order if i % 2 == 0 else order[::-1]):
            out[side].append(event_ms(fn) / per)
    return out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def scaled_prepared(cfg, dims, mem, dev):
    """Seeded Gaussian params scaled x6, x5, x4 or x3 — the largest scale
    at which prepare_inference keeps the exact-GEMM route (unscaled N(0,
    0.1) weights quantize almost entirely to 0 or +-0.25 at Q5.2; rows of
    more than 8 words take x3)."""
    import torch
    from qmann_tpu_torch.models import memn2n
    base = memn2n.init_params(cfg, dims, torch.Generator().manual_seed(SEED),
                              device=dev)
    for scale in (6.0, 5.0, 4.0, 3.0):
        params = {k: v * scale for k, v in base.items()}
        prep = memn2n.prepare_inference(
            params, cfg, max_count=float(dims.max_word + 1),
            max_rowsum=float(dims.max_word + 1))
        if prep.fast and float(mem.max()) <= dims.max_word + 1:
            return scale, params, prep
    fail("no weight scale keeps prepare_inference on the exact route")


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
    qa1-shaped stories and seeded weights x4, the embeddings on the
    lattice kernel (bit-identical to its plain version, which would hold a
    [B*M, D, I] lattice); the last 3 samples have no live row, as padded
    samples.  Returns (dims, params, memory, question, mask, (m, c, u))."""
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
    u = qmatvec_forward(params["B"], que_t, f0, f0, backend="kernel")
    m, c = (qembed_mat_forward(mem_t, params[w], f0, backend="kernel")
            for w in "AC")
    return dims, params, mem_t, que_t, mask_t, (m, c, u)


def wsum_inputs(rng, fmt, B, M, D):
    """c [B, M, D], p and mask [B, M], g [B, D] as numpy float32: Gaussian
    c and g at the format's range, p in [0, 1); sample 0 holds an edge list
    in c (+-0.0, +-the bound, beyond it, tiny values, +-3e38; fmt None: the
    float instance's inputs at unit range, without the two values whose
    products overflow); sample 1's upstream row is zero; padded rows in
    every sample with p non-zero on them, so that negative values meet the
    mask's 0."""
    import numpy as np
    from qmann_tpu_torch.numerics import fixed_max_float
    top = (1.0 if fmt is None or fmt.is_binary
           else fixed_max_float(fmt.iwl, fmt.frac))
    c = rng.normal(0.0, 0.6 * top, (B, M, D)).astype(np.float32)
    edge = np.array([0.0, -0.0, top, -top, 1.5 * top, -1.5 * top, 1e-7,
                     -1e-7] + ([] if fmt is None else [3e38, -3e38]),
                    np.float32)[:D]
    c[0, 0, :len(edge)] = edge
    p = rng.uniform(0.0, 1.0, (B, M)).astype(np.float32)
    g = rng.normal(0.0, 0.6 * top, (B, D)).astype(np.float32)
    g[min(1, B - 1)] = 0.0
    mask = (np.arange(M) < rng.integers(1, M + 1, (B, 1))).astype(np.float32)
    return c, p, mask, g


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


# ---------------------------------------------------------------------------
# checks: a kernel's outputs against its plain version's on the same inputs
# ---------------------------------------------------------------------------

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
        flipped |= (float_quant(p_g[h], fmt)
                    != float_quant(p_w[h], fmt)).any(-1)
    ok = ~flipped
    good = (torch.equal(s_g[0], s_w[0]) and diffs["p"] <= 1e-6
            and torch.equal(s_g[:, ok], s_w[:, ok])
            and torch.equal(u_g[ok], u_w[ok]) and int(flipped.sum()) <= 1)
    return diffs, int(flipped.sum()), good


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


def check_backward(got, want, m, u, g, iwl, num_bit, const_scale=-3,
                   round_mode=3):
    """The surrogate backward kernel's (dm, du) against its plain version's
    on the same inputs: dm bit for bit (int32 views: the sign of a zero
    counts); du within 2 * M * 2^-24 * sum_r |grad_appx * g| per element
    (two M-term float32 sums in different orders).  Returns (max |du
    difference|, elements of du that differ, both hold)."""
    import torch
    from qmann_tpu_torch.ops.attention import surrogate_terms
    (dm, du), (want_dm, want_du) = got, want
    _, grad_appx = surrogate_terms(m, u, iwl, num_bit, const_scale,
                                   round_mode)
    M = m.shape[-2]
    slack = 2 * M * 2.0 ** -24 * (grad_appx * g[..., None]).abs().sum(-2)
    diff = (du - want_du).abs()
    dm_equal = torch.equal(dm.view(torch.int32), want_dm.view(torch.int32))
    return (float(diff.max()), int((du != want_du).sum()),
            dm_equal and bool((diff <= slack).all()))


def check_wsum_backward(got, want, c, p, mask, g, fmt):
    """The weighted-sum backward kernel's (dc, dp) against its plain
    version's on the same inputs: dc bit for bit (int32 views: the sign of
    a zero counts); dp bit for bit where every sum is exact (sums_exact),
    elsewhere within dp_interval.  Returns (max |dp difference|, rows of
    dp that differ: the requants that flipped, both hold)."""
    import torch
    from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb
    (dc, dp), (want_dc, want_dp) = got, want
    good = torch.equal(dc.view(torch.int32), want_dc.view(torch.int32))
    if wsb.sums_exact(fmt, c.shape[-1]):
        good &= torch.equal(dp.view(torch.int32), want_dp.view(torch.int32))
    lo, hi = wsb.dp_interval(c, mask, g, fmt)
    good &= bool(((lo <= dp) & (dp <= hi)).all())
    return (float((dp - want_dp).abs().max()), int((dp != want_dp).sum()),
            good)


def wsum_plain(c, p, mask, g, fmt):
    """The weighted-sum backward kernel's plain version."""
    from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward
    return qweighted_sum_backward(c, p, mask, g, fmt, grad_quantized=True)


def check_wsum_softmax(got, want, c, p, mask, g, dp_in, ds_in, fmt,
                       quantized, wsb=None):
    """The ds entry's (dc, ds) against its plain version's on the same
    inputs: dc bit for bit (int32 views), ds within ds_bound of the plain
    ds (dp_error: dp's own difference), both taken from `wsb` (default:
    the imported ops/cuda/qweighted_sum_bwd.py).  Returns (max |ds
    difference|, elements of ds that differ, both hold)."""
    import torch
    from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward
    if wsb is None:
        from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb
    (dc, ds), (want_dc, want_ds) = got, want
    good = torch.equal(dc.view(torch.int32), want_dc.view(torch.int32))
    _, dp = qweighted_sum_backward(c, p, mask, g, fmt,
                                   grad_quantized=quantized)
    if dp_in is not None:
        dp = dp + dp_in
    bound = wsb.ds_bound(p, dp, wsb.dp_error(c, mask, g, fmt, quantized,
                                             dp_in), ds_in)
    diff = (ds.double() - want_ds.double()).abs()
    good &= bool((diff <= bound).all())
    return float(diff.max()), int((ds != want_ds).sum()), good


# ---------------------------------------------------------------------------
# bounds (module docstring): (least ms, "bytes" or "operations")
# ---------------------------------------------------------------------------

def _bound(nbytes, nops, int_ops=0, popc_ops=0):
    """(least ms, what bounds it) for a call moving nbytes and doing nops
    float, int_ops integer and popc_ops population-count, leading-zero or
    conversion operations (the three pipes may overlap)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(nops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S,
                popc_ops / POPC_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def qmatvec_bound(w, x):
    """Quantize w and x once, then a multiply, a requant and an add per
    nonzero entry of x and output; requant each output (per run of a
    family w [R, O, I])."""
    (B, I), O = x.shape[-2:], w.shape[-2]
    R = w.shape[0] if w.dim() == 3 else 1
    nnz = int((x != 0).sum())
    ops = R * Q_OPS * (O * I + B * I + B * O) + nnz * O * (2 + Q_OPS)
    return _bound(_nbytes(w, x) + 4 * R * B * O, ops)


def qmatvec_dense_bound(w, x):
    """qmatvec_bound on every product of the dense lattice, zeros
    included."""
    (B, I), O = x.shape[-2:], w.shape[-2]
    R = w.shape[0] if w.dim() == 3 else 1
    ops = R * (Q_OPS * (O * I + B * I + B * O) + B * O * I * (2 + Q_OPS))
    return _bound(_nbytes(w, x) + 4 * R * B * O, ops)


def ham_score_ops(B, M, D, num_bit):
    """(float, integer, popcount-pipe) operations of one Hamming score
    (module docstring): the encodes of m and u; per element pair the
    preprocess, the match and its conversion or popcount, the sign, the
    scale, the sum and the term's requant; the row sums' requant."""
    pairs = B * M * D
    if num_bit <= HAM_WORD_MAX_BIT:
        match_f, match_i, popc = 0, 2, pairs
    else:
        match_f, match_i, popc = 2 * (num_bit - 1), 2 + (num_bit - 1), 0
    return (pairs * (2 + Q_OPS + match_f) + B * M * Q_OPS,
            6 * B * D * (M + 1) + pairs * (8 + match_i + 2), popc)


def hamming_bound(m, u, num_bit):
    B, M, D = m.shape
    return _bound(_nbytes(m, u) + 4 * B * M,
                  *ham_score_ops(B, M, D, num_bit))


def hamming_backward_bound(m, u, g, num_bit):
    """Bytes: m, u and g read once, dm and du written once.  Operations in
    the kernel's closed form, the same whatever num_bit: the encodes of m
    and u; per element pair the preprocess of 8 and 15, a popcount and a
    leading-zero count, 5 float operations."""
    B, M, D = m.shape
    pairs = B * M * D
    return _bound(_nbytes(m, u, g) + 4 * (B * M * D + B * D), pairs * 5,
                  6 * B * D * (M + 1) + pairs * (8 + 15), pairs * 2)


def wsum_backward_bound(c, p, mask, g, dp_in=None, ds_in=None,
                        quantized=True, softmax=False):
    """Bytes: c, p, mask, g and the given cotangents read once, dc and dp
    (or ds) written once (leading dims folded).  Operations, quantized:
    per element two products, four requants (3 float operations and a
    rounding each), the mask and the add; per query the requants of g and
    p; per row dp's requant and mask.  Float: per element a product and a
    multiply-add, per row p*mask and dp's mask.  The softmax epilogue: per
    row p*dp, the add into S, the subtraction, the product, one add per
    cotangent."""
    M, D = c.shape[-2:]
    B = c.numel() // (M * D)
    extra = [t for t in (dp_in, ds_in) if t is not None]
    q_f = Q_OPS - 1
    if quantized:
        flops = (B * M * D * (4 + 4 * q_f) + B * (D + M) * q_f
                 + B * M * (q_f + 1))
        conv = B * M * D * 4 + B * (D + M) + B * M
    else:
        flops, conv = B * M * D * 3 + B * M * 2, 0
    if softmax:
        flops += B * M * (4 + len(extra))
    return _bound(_nbytes(c, p, mask, g, *extra) + 4 * (B * M * D + B * M),
                  flops, 0, conv)


def _read_ops(B, M, D, num_bit=None):
    """(float, integer, popcount-pipe) operations of one attention read:
    the score (mode 2, num_bit None: quantize m and u, the lattice and its
    requant; mode 3: the Hamming score on the raw m and u); the softmax and
    Q(p); Q(c), the weighted-sum lattice and the output requant."""
    wsum = (Q_OPS * B * M * D + B * M * (Q_OPS + 4)
            + B * M * D * (2 + Q_OPS) + B * D * Q_OPS)
    if num_bit is None:
        return (Q_OPS * (B * M * D + B * D) + B * M * D * (2 + Q_OPS)
                + B * M * Q_OPS + wsum, 0, 0)
    score_f, score_i, popc = ham_score_ops(B, M, D, num_bit)
    return wsum + score_f, score_i, popc


def attention_read_bound(m, c, u, mask, num_bit=None):
    B, M, D = m.shape
    return _bound(_nbytes(m, c, u, mask) + 4 * (B * D + 2 * B * M),
                  *_read_ops(B, M, D, num_bit))


def chain_bound(x, wt, u, hmats, mask, num_bit=None):
    """The chain from the memory x [B, M, I] and Q(A|C) wt: x, wt, u, the
    lin maps and the mask read once, u, p and s written once.  Per hop:
    the embedding of the hop's A and C slices (a multiply and an add per
    nonzero entry of x and column) and their requant, one read, the lin
    map lattice (Q(H) once) and the residual (3 requants per element)."""
    B, M, _ = x.shape
    K, D = hmats.shape[0], u.shape[1]
    read_f, read_i, read_p = _read_ops(B, M, D, num_bit)
    per_hop = (2 * int((x != 0).sum()) * 2 * D + Q_OPS * 2 * B * M * D
               + read_f + Q_OPS * D * D + B * D * D * (2 + Q_OPS)
               + 3 * Q_OPS * B * D)
    return _bound(_nbytes(x, wt, u, hmats, mask)
                  + 4 * (B * D + 2 * K * B * M),
                  K * per_hop, K * read_i, K * read_p)
