#!/usr/bin/env python3
"""Time one training step of the PyTorch/CUDA port at B=32, eager and as
a replayed CUDA graph, on one NVIDIA GPU, and count its kernel records by
kernel name.

    python3 step_times.py [--root DIR] [--tag NAME] [--out FILE]

Three configurations at the flagship widths (mode 2 iwl 5 on
`use_pallas`; mode 3 iwl 1 on `use_pallas` and on `use_pallas_hamming`),
each on the first 10 batches of a seeded qa1-shaped `synthetic_task` with
weights x4: the eager `train_step` loop against `train_epoch` through
`graphs.Graphs` (event ms per step, median of 5 strictly alternating
pairs of 10 steps), the profiler's busy ms and kernel records per step of
each, the eager step's records by kernel name (the 12 most frequent) and
the launches per eager step that each kernel wrapper of the port counts
(null for a wrapper the package at --root does not have).

A fourth, the sweep_fixed.sh family's step: mode 3 iwl 1 on `use_pallas`,
20 tasks x 2 seeds (R = 40 runs, 1280 folded queries a step) on
scripts/card_kit.py's family layout (V=64, M=50, seeded tasks of 905..1000
stories) from the runs' own initial weights: the eager family step
(`multi._family_epoch_step`) against the replays of the graph that
`multi_epoch` captured of it, 10 steps a sample, with the same readings.

`--root DIR` takes `qmann_tpu_torch` from DIR, such as an older commit
unpacked into the gitignored `chip_parent/`; the inputs and timers come
from this checkout (`scripts/card_kit.py`), so two commits are timed by
the same code.  Compare two commits in one call, in turns:

    for r in chip_parent . . chip_parent; do
      python3 step_times.py --root $r --tag $r --out steps.jsonl
    done

Prints one JSON line per configuration and one for the run, with the
card's name and power limit; `--out` appends the last.
"""
import argparse
import importlib
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
CONFIGS = (("mode 2 iwl 5, use_pallas", dict(use_pallas=True)),
           ("mode 3 iwl 1, use_pallas", dict(attention_mode=3, iwl=1,
                                             use_pallas=True)),
           ("mode 3 iwl 1, use_pallas_hamming",
            dict(attention_mode=3, iwl=1, use_pallas_hamming=True)))
STEPS, TOP = 10, 12
# each kernel module of the port and the wrapper that counts its launches
WRAPPERS = (("hop_chain", "fused_hop_chain_from_memory"),
            ("qmatvec", "quantized_matvec"),
            ("attention_read", "fused_read"),
            ("hamming", "hamming_score_kernel"),
            ("hamming_bwd", "hamming_backward_kernel"),
            ("qweighted_sum_bwd", "qweighted_sum_backward_kernel"),
            ("qweighted_sum_bwd", "weighted_sum_softmax_backward_kernel"))


FAMILY = "sweep_fixed family: mode 3 iwl 1, use_pallas, R = 40"


def timed_row(kit, tag, config, eager, graphed, launches, mods):
    """One configuration's row: launches per eager step, event ms of the
    eager and graphed sides in alternating pairs, busy ms and kernel
    records per step, the eager step's records by kernel name.  graphed
    has run (warm-up and capture) before."""
    before = launches()
    eager()
    after = launches()
    row = {"tag": tag, "config": config, "launches_per_step": {
        w: (after[w] - before[w]) / STEPS if w in mods else None
        for _, w in WRAPPERS}}
    t = kit.paired_ms(eager, graphed, STEPS)
    for side, fn in (("eager", eager), ("graphed", graphed)):
        kernels = kit.device_ms(fn, n_iter=2)
        row[side] = {"event_ms": statistics.median(t[side]),
                     "samples_ms": t[side],
                     "busy_ms": sum(ms for ms, _ in kernels.values())
                     / STEPS,
                     "records": sum(n for _, n in kernels.values())
                     / STEPS}
        if side == "eager":
            top = sorted(kernels.items(), key=lambda kv: -kv[1][1])
            row["eager_records_by_kernel"] = {
                key: n / STEPS for key, (_, n) in top[:TOP]}
    return row


def family_row(kit, dev, launches, mods, tag):
    """The sweep_fixed family's step (module docstring): STEPS batches of
    TRAIN_BATCH per run, every run's first samples in order."""
    import numpy as np
    import torch
    from qmann_tpu_torch import graphs
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.train import multi

    cfg = QmannConfig(verbose=False, attention_mode=3, iwl=1,
                      use_pallas=True, en_integer_fast_path=True)
    rng = np.random.default_rng(kit.SEED + 16)
    pool = synthetic_task(rng, 2000, 4 * kit.FAMILY_VALID,
                          4 * kit.FAMILY_TEST, *kit.FAMILY_LAYOUT)
    sizes = [1000 - 5 * ((7 * t) % kit.FAMILY_TASKS)
             for t in range(kit.FAMILY_TASKS)]
    tasks = kit.family_tasks(rng, pool, sizes)
    datas = [tasks[t] for t in sorted(tasks)]
    seeds = (0, 1)
    run_task = [t for t in range(len(datas)) for _ in seeds]
    R, B = len(run_task), kit.TRAIN_BATCH
    train, valid = ({k: torch.from_numpy(v).to(dev) for k, v in
                     multi._stack_split([getattr(d, split)
                                         for d in datas]).items()}
                    for split in ("train", "valid"))
    task_id = torch.tensor(run_task, device=dev)
    params = multi._initial_params(
        cfg, pool.dims, [s for _ in datas for s in seeds], None, dev)
    # every task has more than STEPS * B samples: no padding in the grid
    perm = torch.arange(STEPS * B, device=dev).repeat(R, 1)
    smask = torch.ones((STEPS, R, B), device=dev)
    size_b = torch.full((STEPS, R), float(B), device=dev)
    g = graphs.Graphs(dev)
    lr = g.static("lr", ())
    lr.fill_(cfg.learning_rate)
    best = {k: v.clone() for k, v in params.items()}
    best_err, best_cost = (torch.full((R,), float("inf"), device=dev)
                           for _ in range(2))
    ind_best = torch.zeros((R,), dtype=torch.int32, device=dev)
    for itr in (1, 2):   # the warm-up, then the capture
        multi.multi_epoch(params, best, best_err, best_cost, ind_best, itr,
                          train, valid, task_id, perm, smask, size_b, lr,
                          cfg, False, B, 128, g)
    step = next(gr for gr in g.graphs.values()
                if gr.key[0] == "family_step")
    counter = g.static("epoch_step", (1,), torch.int64)
    costs = g.static("epoch_costs", (STEPS, R))
    matches = g.static("epoch_matches", (STEPS, R), torch.int32)

    def eager():
        counter.zero_()
        for _ in range(STEPS):
            multi._family_epoch_step(params, train, task_id, perm, smask,
                                     size_b, lr, counter, costs, matches,
                                     cfg, False)

    def graphed():
        counter.zero_()
        for _ in range(STEPS):
            step.replay()

    return timed_row(kit, tag, FAMILY, eager, graphed, launches, mods)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    spec = importlib.util.spec_from_file_location(
        "card_kit", HERE / "scripts" / "card_kit.py")
    kit = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kit)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        kit.fail("step_times.py needs a GPU")
    sys.path.insert(0, str(root))
    import qmann_tpu_torch
    if not Path(qmann_tpu_torch.__file__).resolve().is_relative_to(root):
        kit.fail(f"imported {qmann_tpu_torch.__file__}, not the package at "
                 f"{root}")
    # every kernel module the package has, built in parallel
    mods = {}
    for name, wrapper in WRAPPERS:
        try:
            mod = importlib.import_module(f"qmann_tpu_torch.ops.cuda.{name}")
        except ModuleNotFoundError:   # an older commit without it
            continue
        if hasattr(mod, wrapper):     # an older module without it
            mods[wrapper] = mod
    sources = list({id(m): m for m in mods.values()}.values())
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda m: m.build(), sources))

    def launches():
        return {w: getattr(m, w).launches for w, m in mods.items()}

    from qmann_tpu_torch import graphs
    from qmann_tpu_torch.config import QmannConfig
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.train import train_epoch, train_step
    from qmann_tpu_torch.train.trainer import _batched_arrays

    dev = torch.device(kit.DEVICE)
    data = synthetic_task(np.random.default_rng(kit.SEED), 1000, 100, 100,
                          19, 10, 6)
    batches = {k: torch.from_numpy(v[:STEPS]).contiguous().to(dev)
               for k, v in _batched_arrays(data.train,
                                           kit.TRAIN_BATCH).items()}
    run = {"tag": args.tag, "root": str(root), "card": kit.card_line(),
           "kernel_modules": len(sources), "wrappers": len(mods)}
    for name, kw in CONFIGS:
        cfg = QmannConfig(verbose=False, **kw)
        base = {k: 4.0 * v for k, v in memn2n.init_params(
            cfg, data.dims, torch.Generator().manual_seed(kit.SEED),
            device=dev).items()}
        lr = torch.tensor(cfg.learning_rate, device=dev)
        p_e = {k: v.clone() for k, v in base.items()}
        p_g = {k: v.clone() for k, v in base.items()}
        g = graphs.Graphs(dev)

        def eager():
            for i in range(STEPS):
                train_step(p_e, {k: v[i] for k, v in batches.items()}, lr,
                           cfg)

        def graphed():
            train_epoch(p_g, batches, lr, cfg, graphs=g)

        graphed()   # warm-up and capture
        row = timed_row(kit, args.tag, name, eager, graphed, launches, mods)
        run[name] = row
        print(json.dumps(row), flush=True)
    row = family_row(kit, dev, launches, mods, args.tag)
    run[FAMILY] = row
    print(json.dumps(row), flush=True)
    print(json.dumps(run), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(run) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
