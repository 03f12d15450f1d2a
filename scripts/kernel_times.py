#!/usr/bin/env python3
"""Time the port's chain and lattice kernels of one checkout on the card.

    python3 scripts/kernel_times.py [--root DIR] [--tag NAME] [--out FILE]

Imports qmann_tpu_torch from DIR (default: this repository) and takes the
inputs, the checks and the timers from this repository's chip_smoke.py, so
that an unpacked older commit (`git archive` into a gitignored directory)
is timed by the same code as this one; run the versions in turns in one
call (parent, change, change, parent) to compare them on one card.  Checks
each kernel against its plain version first (the chain under
chip_smoke.compare_chain, qmatvec bit for bit) and fails if one disagrees.
Prints the card's name and power limit, then one JSON line with, per case,
the kernel's device time (torch.profiler, ms per call) and event time (CUDA
events around the wrapper, median of 7 samples of 20 calls):
  - the chain at B=1000, attention modes 2 and 3, on the flagship (M=10,
    I=29, D=60, K=3) and wide (M=50, I=114) inputs chip_smoke.py makes,
    on raw H and, where prepare_inference caches it, on Q(H) with the
    kernel's requant skipped ("cached": the serving path's launch);
  - qmatvec on the A embedding at 320 rows (B=32, M=10), 1600 rows (the
    wide layout, B=32, M=50) and 10240 rows (an evaluation chunk, B=1024);
  - forward_prepared at B=1000 on the kernel route, modes 2 and 3: event
    time, the profiler's device busy time and the idle share.
--out appends the line to FILE too.
"""
import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BATCH = 1000
CHAIN_SHAPES = {"flagship": (19, 10, 6), "wide": (64, 50, 7)}
QMV_SHAPES = {"320": (32, 19, 10, 6), "1600": (32, 64, 50, 7),
              "10240": (1024, 19, 10, 6)}


def load_chip_smoke():
    """This repository's chip_smoke.py, whatever DIR holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = load_chip_smoke()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("kernel_times.py needs a GPU")
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_batch
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.numerics import float_quant
    from qmann_tpu_torch.ops import exact_matmul
    from qmann_tpu_torch.ops.cuda import hop_chain
    from qmann_tpu_torch.ops.cuda import qmatvec as qmv
    if not Path(hop_chain.__file__).resolve().is_relative_to(root):
        cs.fail(f"imported {hop_chain.__file__}, not the checkout at {root}")
    hop_chain.build()
    qmv.build()
    dev = torch.device(cs.DEVICE)
    card = cs.card_line()
    print(f"[kernel_times] {args.tag or root.name} | {card}", flush=True)
    rng = np.random.default_rng(cs.SEED)
    out = {"tag": args.tag, "root": str(root), "card": card,
           "chain": {}, "qmatvec": {}, "forward_prepared": {}}

    def times(fn):
        with torch.inference_mode():
            dev_ms = max((ms for ms, _ in cs.device_ms(fn).values()),
                         default=float("nan"))
            return {"device_ms": dev_ms, "ms": cs.cuda_ms(fn)}

    for attention_mode in (2, 3):
        cfg = QmannConfig(use_fused_chain=True, attention_mode=attention_mode)
        kw = dict(attention_mode=attention_mode,
                  ham_num_bit=cfg.num_bits_attention)
        for name, (V, M, W) in CHAIN_SHAPES.items():
            dims, mem, que, mask = synthetic_batch(rng, BATCH, V, M, W)
            _, _, prep = cs.scaled_prepared(cfg, dims, mem, dev)
            mem_t, que_t, mask_t = (torch.from_numpy(a).to(dev)
                                    for a in (mem, que, mask))
            chain_args = (exact_matmul(mem_t, prep.embed_wt),
                          float_quant(exact_matmul(que_t, prep.query_wt),
                                      cfg.fmt_w[0]),
                          prep.hmats, mask_t, cfg.fmt_w, cfg.fmt_att,
                          cfg.fmt_bin, cfg.fmt_act)
            key = f"mode{attention_mode} {name}"
            got = hop_chain.fused_hop_chain(*chain_args, **kw)
            want = hop_chain.fused_hop_chain_reference(*chain_args, **kw)
            _, flips, good = cs.compare_chain(cfg, got, want)
            if not good:
                cs.fail(f"chain disagrees with its plain version ({key})")
            out["chain"][key] = {**times(
                lambda: hop_chain.fused_hop_chain(*chain_args, **kw)),
                "flipped": flips}
            print(f"[kernel_times] chain {key}: {out['chain'][key]}",
                  flush=True)
            if getattr(prep, "hmats_q", None) is not None:
                cached = (*chain_args[:2], prep.hmats_q, *chain_args[3:])
                ck = f"{key} cached"
                out["chain"][ck] = times(lambda: hop_chain.fused_hop_chain(
                    *cached, hmats_quantized=True, **kw))
                print(f"[kernel_times] chain {ck}: {out['chain'][ck]}",
                      flush=True)
            if name == "flagship":
                batch = (mem_t, que_t, mask_t)
                fp = times(lambda: memn2n.forward_prepared(prep, *batch, cfg))
                with torch.inference_mode():
                    busy = cs.device_ms(lambda: memn2n.forward_prepared(
                        prep, *batch, cfg))
                fp["busy_ms"] = sum(ms for ms, _ in busy.values())
                fp["launches"] = sum(n for _, n in busy.values())
                fp["idle_share"] = 1.0 - fp["busy_ms"] / fp["ms"]
                del fp["device_ms"]
                out["forward_prepared"][f"mode{attention_mode}"] = fp
                print(f"[kernel_times] forward_prepared mode "
                      f"{attention_mode}: {fp}", flush=True)

    cfg = QmannConfig(use_pallas=True)
    for key, (B, V, M, W) in QMV_SHAPES.items():
        dims, mem, _, _ = synthetic_batch(rng, B, V, M, W)
        params = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg, dims, torch.Generator().manual_seed(cs.SEED),
            device=dev).items()}
        rows = torch.from_numpy(mem).to(dev).reshape(-1, dims.dim_input)
        qargs = (params["A"], rows, cfg.fmt_w[0], cfg.fmt_w[0])
        if not torch.equal(qmv.quantized_matvec(*qargs),
                           qmv.quantized_matvec_reference(*qargs)):
            cs.fail(f"qmatvec differs from its plain version ({key} rows)")
        out["qmatvec"][key] = times(lambda: qmv.quantized_matvec(*qargs))
        print(f"[kernel_times] qmatvec {key} rows: {out['qmatvec'][key]}",
              flush=True)

    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
