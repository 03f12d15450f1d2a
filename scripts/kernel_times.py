#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card.

    python3 scripts/kernel_times.py [--root DIR] [--tag NAME] [--out FILE]
                                    [--only GROUPS]

Imports qmann_tpu_torch from DIR (default: this repository) and takes the
inputs, the checks, the timers and the bounds from this repository's
scripts/card_kit.py, so that an unpacked older commit (`git archive` into
a gitignored directory) is timed by the same code as this one; run the
versions in turns in one call (parent, change, change, parent) to compare
them on one card.  Checks each kernel against its plain version first
(the chain under card_kit.compare_chain, the read under
card_kit.check_read, qmatvec and the Hamming kernel bit for bit) and fails
if one disagrees.  Prints the card's name and power limit, then one JSON
line with, per case, the kernel's device time (torch.profiler, ms per
recorded launch) and event time (CUDA events around the wrapper, median
of 7 samples of 20 calls), and for the kernels the bound of
card_kit.py's docstring (bound_ms, and bound_by: what binds it), for
qmatvec also the dense lattice's (dense_bound_ms); for the chain, qmatvec,
the read, the Hamming kernel and the surrogate backward the plain
version's event time (plain_ms, card_kit.plain_ms); for the read and the
Hamming kernel also the wrapper's host time (host_us: the host clock per
call over 100 calls issued without a wait, median of 7 samples).
Groups (--only takes a comma-separated subset; default all):
  chain    the chain's serving launch at B=1000, attention modes 2 and 3,
           on the flagship (M=10, I=29, D=60, K=3), wide (M=50, I=114;
           the serve cell's shape) and wide W11 (rows of 10 to 12 nonzero
           entries) inputs of card_kit.scaled_prepared, on raw H and, where
           prepare_inference caches it, on Q(H) with the kernel's requant
           skipped ("cached"): fused_hop_chain_from_memory where the
           checkout has it, else the exact GEMM then the chain from flat;
           held against the plain chain (card_kit.compare_chain); event
           ms, the profiler's busy ms and kernel records a call, the
           chain kernel's device ms a launch, and the sha256 of u's, p's
           and s's bytes (equal digests: bit-identical outputs across
           checkouts);
           forward_prepared at B=1000 on the chain route, modes 2 and 3,
           each layout: event time, the profiler's device busy time,
           kernel records a call, the idle share and the sha256 of the
           logits', p's and s's bytes;
  qmatvec  qmatvec on the A embedding at 320 rows (B=32, M=10), 1600 rows
           (the wide layout, B=32, M=50) and 10240 rows (an evaluation
           chunk, B=1024); the question embedding (32 rows of I=19) and a
           hop's linear map (O=I=60, 32 dense rows); the run.sh family's
           memory embedding, R=200 runs' weights against 200 x 1600 rows
           (B=32, M=50, I=114) and an evaluation chunk's 200 x 6400;
           past the whole-row limit, the joint block's (I=256, M=64) at
           2048 and 65536 rows and I=1024 at 2048 rows ("refused" where
           the checkout's kernel does not take them); each with the
           sha256 of its output's bytes (equal digests: bit-identical
           outputs across checkouts);
  read     the attention read in modes 1, 2 and 3 (iwl 1) at B=32, B=1024,
           the wide layout (B=32, M=50) and the family's folded batches
           (M=50: the mode-3 family's 1280 and 5120 queries, the R = 200
           family's 6400 and its evaluation chunk's 25,600), on the
           training forward's inputs with 3 padded samples (bound_ms null
           in mode 1, whose work the bound does not count);
  hamming  the Hamming score at iwl 1 and 5 (num_bit 8, weighted), at
           B=32 and B=1024 (M=10), the wide layout (B=32, M=50) and the
           mode-3 family's folded 1280 and 5120 queries (M=50), D=60, on
           card_kit.ham_inputs (the encode's edge list in sample 0);
  hamming_bwd the surrogate backward at iwl 1, num_bit 8, truncation, at
           B=32 (M=10), the wide layout (B=32, M=50) and the mode-3
           family's folded 1280 and 5120 queries (M=50), D=60, on
           card_kit.ham_inputs and a Gaussian g from one seed per case;
           held against its plain version (card_kit.check_backward);
           device ms per recorded launch, event ms, the bound and the
           sha256 of dm's then du's bytes (equal digests: bit-identical
           outputs across checkouts);
  wsum_bwd the weighted-sum backward at B=32 (M=10), the wide layout
           (B=32, M=50), the mode-3 family's folded 1280 and 5120 queries
           and the R = 200 family's folded 6400 (M=50), D=60, on
           card_kit.wsum_inputs from one seed per case: the dp entry
           (quantized, iwl 1 wl 8, truncation), and the fused read's
           backward hop in the quantized and float instances: the ds
           entry where the checkout has it (one launch), else the hop as
           the checkout runs it (the dp entry or the plain float backward,
           then softmax_backward); each held against its plain version
           (card_kit.check_wsum_backward, check_wsum_softmax); device ms
           per recorded launch (the hop's busy ms per call where it is
           more than one kernel), event ms, the bound, and the sha256 of
           dc's then dp's (or ds's) bytes (equal digests: bit-identical
           outputs across checkouts); the ds cases also give the eager
           composition's event ms and busy ms (plain weighted-sum backward
           and softmax_backward on the card);
  steps    one training step at B=32 (forward, backward, SGD): mode 2 at
           iwl 5 and mode 3 at iwl 1 with use_pallas, mode 3 at iwl 1 with
           use_pallas_hamming; event time, busy time, launches, idle share;
  state    the card's state: the read (modes 2, 3) and the Hamming kernel
           at B=32 timed (device time) after 5 s idle and after 3 s of
           float32 GEMMs, twice in turn, with nvidia-smi's SM and memory
           clocks and power draw before and after each reading.
--out appends the line to FILE too.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH = 1000
GROUPS = ("chain", "qmatvec", "read", "hamming", "hamming_bwd", "wsum_bwd",
          "steps", "state")
STATES = ("idle", "busy", "idle", "busy")
# (V, M, W): the flagship, the wide layout (the serve cell's), and the wide
# layout with rows of 10 to 12 nonzero entries (11 words and the time bit)
CHAIN_SHAPES = {"flagship": (19, 10, 6), "wide": (64, 50, 7),
                "wide W11": (64, 50, 11)}
QMV_SHAPES = {"320": (32, 19, 10, 6), "1600": (32, 64, 50, 7),
              "10240": (1024, 19, 10, 6),
              # past the whole-row limit: the joint block's memory
              # embedding (I = 192 + 64) at B=32 and B=1024, and I=1024
              "2048x256": (32, 192, 64, 7), "65536x256": (1024, 192, 64, 7),
              "2048x1024": (32, 960, 64, 7)}
# the run.sh family's memory embedding: (runs, stories a run, V, M, W)
QMV_FAMILY = {"family 200x1600": (200, 32, 64, 50, 7),
              "family 200x6400": (200, 128, 64, 50, 7)}
# (B, V, M, W): the read's inputs (card_kit.read_inputs)
READ_SHAPES = {"B32": (32, 19, 10, 6), "B1024": (1024, 19, 10, 6),
               "wide": (32, 64, 50, 7), "family 1280": (1280, 64, 50, 6),
               "family 5120": (5120, 64, 50, 6),
               "family 6400": (6400, 64, 50, 6),
               "family 25600": (25600, 64, 50, 6)}
HAM_SHAPES = {"B32": (32, 10, 60), "B1024": (1024, 10, 60),
              "wide": (32, 50, 60), "family 1280": (1280, 50, 60),
              "family 5120": (5120, 50, 60)}
BWD_SHAPES = {"B32": (32, 10, 60), "wide": (32, 50, 60),
              "family 1280": (1280, 50, 60), "family 5120": (5120, 50, 60)}


def time_hamming_bwd(kit, hbwd, dev, times):
    """The hamming_bwd group (module docstring): {case: entry}."""
    import hashlib
    import numpy as np
    import torch
    out = {}
    for i, (name, (B, M, D)) in enumerate(BWD_SHAPES.items()):
        rng = np.random.default_rng(kit.SEED + 140 + i)
        m, u = (torch.from_numpy(a).to(dev)
                for a in kit.ham_inputs(rng, 1, B, M, D))
        g = torch.from_numpy(rng.normal(0.0, 1.0, (B, M)).astype(
            np.float32)).to(dev)
        args = (m, u, g, 1, 8, -3, 3)
        got = hbwd.hamming_backward_kernel(*args)
        err, _, good = kit.check_backward(got, hbwd.hamming_backward(*args),
                                          *args)
        if not good:
            kit.fail(f"the surrogate backward differs from its plain version "
                     f"({name})")
        digest = hashlib.sha256()
        for t in got:
            digest.update(t.cpu().numpy().tobytes())
        bound_ms, bound_by = kit.hamming_backward_bound(m, u, g, 8)
        out[name] = {**times(lambda: hbwd.hamming_backward_kernel(*args),
                           lambda: hbwd.hamming_backward(*args),
                           m.numel() > 1e6),
                     "shape": [B, M, D], "bound_ms": bound_ms,
                     "bound_by": bound_by, "max_abs_err_du": err,
                     "sha256": digest.hexdigest()}
    return out


WSUM_SHAPES = {"B32": (32, 10, 60), "wide": (32, 50, 60),
               "family 1280": (1280, 50, 60), "family 5120": (5120, 50, 60),
               "family 6400": (6400, 50, 60)}


def time_wsum_bwd(kit, dev, times):
    """The wsum_bwd group (module docstring): {case: entry}."""
    import hashlib
    import numpy as np
    import torch
    from qmann_tpu_torch.numerics import QFormat
    from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd as wsb
    from qmann_tpu_torch.ops.qlinear import qweighted_sum_backward
    from qmann_tpu_torch.ops.softmax import softmax_backward
    fused = getattr(wsb, "weighted_sum_softmax_backward_kernel", None)
    fmt = QFormat(1, 6, 3)

    def digest(tensors):
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def hop(c, p, mask, g, quantized):
        """The fused read's backward hop as the checkout runs it."""
        if fused is not None:
            return fused(c, p, mask, g, None, None, fmt, quantized)
        dc, dp = (wsb.qweighted_sum_backward_kernel(c, p, mask, g, fmt)
                  if quantized else
                  qweighted_sum_backward(c, p, mask, g, fmt))
        return dc, softmax_backward(p, dp)

    def plain_hop(c, p, mask, g, dp_in, ds_in, fmt, quantized):
        """The hop's plain composition (no cotangents here)."""
        dc, dp = qweighted_sum_backward(c, p, mask, g, fmt,
                                        grad_quantized=quantized)
        return dc, softmax_backward(p, dp)

    def busy_ms(fn):
        with torch.inference_mode():
            return sum(ms for ms, _ in kit.device_ms(fn).values())

    bounds = load_bounds()

    out = {}
    for i, (name, (B, M, D)) in enumerate(WSUM_SHAPES.items()):
        rng = np.random.default_rng(kit.SEED + 150 + i)
        for inst in ("quantized", "float"):
            c, p, mask, g = (torch.from_numpy(a).to(dev) for a in
                             kit.wsum_inputs(rng, fmt if inst == "quantized"
                                             else None, B, M, D))
            q = inst == "quantized"
            if q:
                args = (c, p, mask, g, fmt)
                got = wsb.qweighted_sum_backward_kernel(*args)
                _, _, good = kit.check_wsum_backward(
                    got, kit.wsum_plain(*args), *args)
                if not good:
                    kit.fail(f"the dp entry differs from its plain version "
                             f"({name})")
                b = kit.wsum_backward_bound(c, p, mask, g)
                out[f"dp {name}"] = {
                    **times(lambda: wsb.qweighted_sum_backward_kernel(*args)),
                    "shape": [B, M, D], "bound_ms": b[0], "bound_by": b[1],
                    "sha256": digest(got)}
            got = hop(c, p, mask, g, q)
            s_args = (c, p, mask, g, None, None, fmt, q)
            err, _, good = kit.check_wsum_softmax(
                got, plain_hop(*s_args), *s_args, wsb=bounds)
            if not good:
                kit.fail(f"the fused read's backward hop differs from its "
                         f"plain version ({inst} {name})")
            b = kit.wsum_backward_bound(c, p, mask, g, quantized=q,
                                        softmax=True)
            entry = {**times(lambda: hop(c, p, mask, g, q)),
                     "launches_per_hop": 1 if fused is not None else None,
                     "busy_ms": busy_ms(lambda: hop(c, p, mask, g, q)),
                     "composition_ms": kit.cuda_ms(
                         lambda: plain_hop(*s_args)),
                     "composition_busy_ms": busy_ms(
                         lambda: plain_hop(*s_args)),
                     "shape": [B, M, D], "bound_ms": b[0], "bound_by": b[1],
                     "max_abs_err_ds": err, "sha256": digest(got)}
            if fused is None:   # several kernels: per_launch_ms misreads
                entry["device_ms"] = entry["busy_ms"]
            out[f"ds {inst} {name}"] = entry
    return out


def load_bounds():
    """This repository's ops/cuda/qweighted_sum_bwd.py (dp_error,
    ds_bound) as a module of its own, on whichever qmann_tpu_torch is
    imported: an older checkout's hop is held to the same bounds."""
    spec = importlib.util.spec_from_file_location(
        "_wsum_bounds", REPO / "qmann_tpu_torch" / "ops" / "cuda"
        / "qweighted_sum_bwd.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_card_kit():
    """This repository's scripts/card_kit.py, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location(
        "card_kit", REPO / "scripts" / "card_kit.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--only", default=",".join(GROUPS))
    args = ap.parse_args()
    groups = set(args.only.split(","))
    if not groups <= set(GROUPS):
        ap.error(f"--only takes a subset of {','.join(GROUPS)}")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    kit = load_card_kit()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        kit.fail("kernel_times.py needs a GPU")
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_batch, synthetic_task
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.numerics import float_quant
    from qmann_tpu_torch.ops import exact_matmul
    from qmann_tpu_torch.ops.cuda import attention_read as ar
    from qmann_tpu_torch.ops.cuda import hamming as ham
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    if not Path(hop_chain.__file__).resolve().is_relative_to(root):
        kit.fail(f"imported {hop_chain.__file__}, not the checkout at {root}")
    for mod in (hop_chain, qmv, ar, ham):
        mod.build()
    dev = torch.device(kit.DEVICE)
    card = kit.card_line()
    print(f"[kernel_times] {args.tag or root.name} | {card}", flush=True)
    rng = np.random.default_rng(kit.SEED)
    out = {"tag": args.tag, "root": str(root), "card": card,
           "chain": {}, "qmatvec": {}, "forward_prepared": {}, "read": {},
           "hamming": {}, "hamming_bwd": {}, "wsum_bwd": {}, "steps": {},
           "state": {}}

    def digest(*tensors):
        import hashlib
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()

    def bound(b):
        return {"bound_ms": b[0], "bound_by": b[1]}

    def times(fn, plain=None, big=False):
        """The kernel's device and event ms; with plain, its plain
        version's event ms (card_kit.plain_ms)."""
        with torch.inference_mode():
            dev_ms = kit.per_launch_ms(kit.device_ms(fn))
            entry = {"device_ms": dev_ms, "ms": kit.cuda_ms(fn)}
            if plain is not None:
                entry["plain_ms"] = kit.plain_ms(plain, big)
            return entry

    def host_us(fn, n_iter=100, samples=7):
        """The host's time per call of fn, issued n_iter times without a
        wait (the launches queue behind one another on the device)."""
        per_call = []
        with torch.inference_mode():
            for _ in range(samples):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n_iter):
                    fn()
                per_call.append((time.perf_counter() - t0) / n_iter * 1e6)
        torch.cuda.synchronize()
        return statistics.median(per_call)

    def busy(fn, entry):
        """Event time, the profiler's device busy time, launches and idle
        share of one call of fn, into entry."""
        entry["ms"] = kit.cuda_ms(fn)
        kernels = kit.device_ms(fn)
        entry["busy_ms"] = sum(ms for ms, _ in kernels.values())
        entry["launches"] = sum(n for _, n in kernels.values())
        entry["idle_share"] = 1.0 - entry["busy_ms"] / entry["ms"]
        return entry

    def report(group, key):
        print(f"[kernel_times] {group} {key}: {out[group][key]}", flush=True)

    def chain_times(fn):
        """Event ms of one call of fn, the profiler's device busy ms a
        call, its kernel records a call and the chain kernel's device ms
        a launch."""
        with torch.inference_mode():
            kernels = kit.device_ms(fn)
            chain = [ms / n for k, (ms, n) in kernels.items()
                     if "hop_chain_kernel" in k and n > 0]
            return {"ms": kit.cuda_ms(fn),
                    "busy_ms": sum(ms for ms, _ in kernels.values()),
                    "launches": sum(n for _, n in kernels.values()),
                    "chain_device_ms": chain[0] if chain else None}

    # the serving launch: from the memory where the checkout has the
    # entry, else the exact GEMM then the chain from flat
    from_memory = getattr(hop_chain, "fused_hop_chain_from_memory", None)
    from_flat = getattr(hop_chain, "fused_hop_chain", None)
    for attention_mode in (2, 3) if "chain" in groups else ():
        cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode)
        kw = dict(attention_mode=attention_mode,
                  ham_num_bit=cfg.num_bits_attention)
        for name, (V, M, W) in CHAIN_SHAPES.items():
            dims, mem, que, mask = synthetic_batch(rng, BATCH, V, M, W)
            _, _, prep = kit.scaled_prepared(cfg, dims, mem, dev)
            mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                    for a in (mem, que, mask))
            u = float_quant(exact_matmul(que_t, prep.query_wt), cfg.fmt_w[0])
            fmts = (mask_t, cfg.fmt_w, cfg.fmt_att, cfg.fmt_bin, cfg.fmt_act)
            key = f"mode{attention_mode} {name}"
            lin_maps = {key: (prep.hmats, False)}
            if getattr(prep, "hmats_q", None) is not None:
                lin_maps[f"{key} cached"] = (prep.hmats_q, True)
            for ck, (hm, q) in lin_maps.items():
                if from_memory is not None:
                    def launch(hm=hm, q=q):
                        return from_memory(mem_t, prep.embed_wt, u, hm,
                                           *fmts, hmats_quantized=q, **kw)
                else:
                    def launch(hm=hm, q=q):
                        return from_flat(exact_matmul(mem_t, prep.embed_wt),
                                         u, hm, *fmts, hmats_quantized=q,
                                         **kw)
                with torch.inference_mode():
                    got = launch()
                def plain():
                    return hop_chain.fused_hop_chain_reference(
                        exact_matmul(mem_t, prep.embed_wt), u, prep.hmats,
                        *fmts, **kw)
                want = plain()
                _, flips, good = kit.compare_chain(cfg, got, want)
                if not good:
                    kit.fail(f"chain disagrees with its plain version ({ck})")
                out["chain"][ck] = {
                    "route": ("from the memory" if from_memory is not None
                              else "exact GEMM, then from flat"),
                    **chain_times(launch), "flipped": flips,
                    "plain_ms": kit.plain_ms(plain, mem_t.numel() > 1e6),
                    **bound(kit.chain_bound(
                        mem_t, prep.embed_wt, u, hm, mask_t,
                        kw["ham_num_bit"] if attention_mode == 3 else None)),
                    "sha256": digest(*got)}
                report("chain", ck)
            batch = (mem_t, que_t, mask_t)
            with torch.inference_mode():
                fp = busy(lambda: memn2n.forward_prepared(prep, *batch, cfg),
                          {})
                res = memn2n.forward_prepared(prep, *batch, cfg)
            fp["sha256"] = digest(res.logits, res.attention, res.scores)
            out["forward_prepared"][key] = fp
            report("forward_prepared", key)

    cfg = QmannConfig(use_pallas=True)
    for key, (B, V, M, W) in QMV_SHAPES.items() if "qmatvec" in groups else ():
        dims, mem, que_np, _ = synthetic_batch(rng, B, V, M, W)
        params = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg, dims, torch.Generator().manual_seed(kit.SEED),
            device=dev).items()}
        rows = torch.from_numpy(mem).to(dev).reshape(-1, dims.dim_input)
        qargs = (params["A"], rows, cfg.fmt_w[0], cfg.fmt_w[0])
        try:
            got = qmv.quantized_matvec(*qargs)
        except ValueError as err:   # a kernel not tiled over I
            out["qmatvec"][key] = {"refused": str(err)}
            report("qmatvec", key)
            continue
        if not torch.equal(got, qmv.quantized_matvec_reference(*qargs)):
            kit.fail(f"qmatvec differs from its plain version ({key} rows)")
        out["qmatvec"][key] = {**times(
            lambda: qmv.quantized_matvec(*qargs),
            lambda: qmv.quantized_matvec_reference(*qargs),
            rows.numel() > 1e6), **bound(kit.qmatvec_bound(*qargs[:2])),
            "dense_bound_ms": kit.qmatvec_dense_bound(*qargs[:2])[0],
            "sha256": digest(got)}
        report("qmatvec", key)
        if key == "320":
            que = torch.from_numpy(que_np).to(dev)
            u = float_quant(torch.from_numpy(rng.normal(
                0.0, 1.5, (B, cfg.dim_emb)).astype(np.float32)).to(dev),
                cfg.fmt_w[0])
            for name, small in (("32 question", (params["B"], que)),
                                ("32 linear map", (params["H"], u))):
                sargs = small + (cfg.fmt_w[0], cfg.fmt_w[0])
                got = qmv.quantized_matvec(*sargs)
                if not torch.equal(got,
                                   qmv.quantized_matvec_reference(*sargs)):
                    kit.fail(f"qmatvec differs from its plain version "
                             f"({name})")
                out["qmatvec"][name] = {
                    **times(lambda: qmv.quantized_matvec(*sargs),
                            lambda: qmv.quantized_matvec_reference(*sargs)),
                    **bound(kit.qmatvec_bound(*sargs[:2])),
                    "dense_bound_ms": kit.qmatvec_dense_bound(
                        *sargs[:2])[0],
                    "sha256": digest(got)}
                report("qmatvec", name)
    for key, (R, B, V, M, W) in (QMV_FAMILY.items() if "qmatvec" in groups
                                 else ()):
        dims, mem, _, _ = synthetic_batch(rng, R * B, V, M, W)
        w = torch.stack([4.0 * memn2n.init_params(
            cfg, dims, torch.Generator().manual_seed(kit.SEED + r),
            device=dev)["A"] for r in range(R)])
        rows = torch.from_numpy(mem).to(dev).reshape(R, B * M, dims.dim_input)
        qargs = (w, rows, cfg.fmt_w[0], cfg.fmt_w[0])
        got = qmv.quantized_matvec(*qargs)
        if not torch.equal(got, qmv.quantized_matvec_reference(*qargs)):
            kit.fail(f"qmatvec differs from its plain version ({key})")
        out["qmatvec"][key] = {**times(
            lambda: qmv.quantized_matvec(*qargs),
            lambda: qmv.quantized_matvec_reference(*qargs),
            rows.numel() > 1e6), **bound(kit.qmatvec_bound(*qargs[:2])),
            "dense_bound_ms": kit.qmatvec_dense_bound(*qargs[:2])[0],
            "sha256": digest(got)}
        report("qmatvec", key)

    # the family cases draw from a generator of their own, so that the
    # other cases keep the inputs of checkouts without them
    fam_rng = np.random.default_rng(kit.SEED + 160)
    read_cfgs = {1: cfg, 2: cfg,
                 3: QmannConfig(iwl=1, attention_mode=3, use_pallas=True)}
    for mode, cfg_r in read_cfgs.items() if "read" in groups else ():
        for name, (B, V, M, W) in READ_SHAPES.items():
            *_, mask_t, (m, c, u) = kit.read_inputs(
                fam_rng if name.startswith("family") else rng, cfg_r, B, V,
                M, W, dev)
            q = mode != 1
            rargs = (m, c, u, mask_t.to(torch.float32), cfg_r.fmt_att[0],
                     cfg_r.fmt_bin, cfg_r.fmt_act[0], mode == 2, q, mode,
                     cfg_r.num_bits_attention)
            _, flips, good, sound = kit.check_read(
                ar.fused_read(*rargs), ar.fused_read_reference(*rargs),
                cfg_r.fmt_act[0], q)
            key = f"mode{mode} {name}"
            if not (good and sound):
                kit.fail(f"the read disagrees with its plain version ({key})")
            b = ((None, None) if mode == 1 else kit.attention_read_bound(
                *rargs[:4], cfg_r.num_bits_attention if mode == 3 else None))
            out["read"][key] = {**times(
                lambda: ar.fused_read(*rargs),
                lambda: ar.fused_read_reference(*rargs), m.numel() > 1e6),
                                "host_us": host_us(
                                    lambda: ar.fused_read(*rargs)),
                                **bound(b), "flipped": flips}
            report("read", key)

    for iwl in (1, 5) if "hamming" in groups else ():
        for name, (B, M, D) in HAM_SHAPES.items():
            m, u = (torch.from_numpy(a).to(dev) for a in kit.ham_inputs(
                fam_rng if name.startswith("family") else rng, iwl, B, M,
                D))
            hargs = (m, u, iwl, 8, -3, 3)
            key = f"iwl{iwl} {name}"
            if not torch.equal(ham.hamming_score_kernel(*hargs),
                               ham.hamming_score_reference(*hargs)):
                kit.fail(f"the Hamming kernel differs from its plain version "
                         f"({key})")
            out["hamming"][key] = {
                **times(lambda: ham.hamming_score_kernel(*hargs),
                        lambda: ham.hamming_score_reference(*hargs),
                        m.numel() > 1e6),
                "host_us": host_us(lambda: ham.hamming_score_kernel(*hargs)),
                **bound(kit.hamming_bound(m, u, 8))}
            report("hamming", key)

    if "hamming_bwd" in groups:
        from qmann_tpu_torch.ops.cuda import hamming_bwd
        out["hamming_bwd"] = time_hamming_bwd(kit, hamming_bwd, dev, times)
        for key in out["hamming_bwd"]:
            report("hamming_bwd", key)

    if "wsum_bwd" in groups:
        from qmann_tpu_torch.ops.cuda import qweighted_sum_bwd
        qweighted_sum_bwd.build()
        out["wsum_bwd"] = time_wsum_bwd(kit, dev, times)
        for key in out["wsum_bwd"]:
            report("wsum_bwd", key)

    if "steps" in groups:
        from qmann_tpu_torch.train import train_step
        from qmann_tpu_torch.train.trainer import _batched_arrays
        data = synthetic_task(np.random.default_rng(kit.SEED), 1000, 100, 100,
                              19, 10, 6)
        batch0 = {k: torch.as_tensor(v[0]).to(dev) for k, v in
                  _batched_arrays(data.train, 32).items()}
        mode3 = QmannConfig(iwl=1, attention_mode=3, verbose=False)
        for key, cfg_s in (
                ("mode2 use_pallas", QmannConfig(use_pallas=True,
                                                 verbose=False)),
                ("mode3 iwl1 use_pallas", mode3.replace(use_pallas=True)),
                ("mode3 iwl1 use_pallas_hamming",
                 mode3.replace(use_pallas_hamming=True))):
            params = {k: 4.0 * v for k, v in memn2n.init_params(
                cfg_s, data.dims, torch.Generator().manual_seed(kit.SEED),
                device=dev).items()}
            lr_t = torch.tensor(cfg_s.learning_rate, dtype=torch.float32,
                                device=dev)
            out["steps"][key] = busy(
                lambda: train_step(params, batch0, lr_t, cfg_s), {})
            report("steps", key)

    if "state" in groups:
        cfg2 = QmannConfig(use_pallas=True)
        cfg3 = QmannConfig(iwl=1, attention_mode=3, use_pallas=True)
        probes = {}
        for mode, cfg_r in ((2, cfg2), (3, cfg3)):
            *_, mask_t, (m, c, u) = kit.read_inputs(rng, cfg_r, 32, 19, 10,
                                                    6, dev)
            rargs = (m, c, u, mask_t.to(torch.float32), cfg_r.fmt_att[0],
                     cfg_r.fmt_bin, cfg_r.fmt_act[0], mode == 2, True, mode,
                     cfg_r.num_bits_attention)
            probes[f"read mode{mode} B32"] = (
                lambda a=rargs: ar.fused_read(*a))
        m, u = (torch.from_numpy(a).to(dev)
                for a in kit.ham_inputs(rng, 1, 32, 10, 60))
        probes["hamming iwl1 B32"] = (
            lambda: ham.hamming_score_kernel(m, u, 1, 8, -3, 3))
        a = torch.randn(8192, 8192, device=dev)

        def clocks():
            return subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True,
                timeout=60).stdout.strip()

        for i, state in enumerate(STATES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < (5 if state == "idle" else 3):
                if state == "busy":
                    a @ a
                    torch.cuda.synchronize()
                else:
                    time.sleep(0.1)
            entry = {"card_before": clocks()}
            with torch.inference_mode():
                for key, fn in probes.items():
                    entry[key] = kit.per_launch_ms(kit.device_ms(fn))
            entry["card_after"] = clocks()
            out["state"][f"{i} after {state}"] = entry
            report("state", f"{i} after {state}")

    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
