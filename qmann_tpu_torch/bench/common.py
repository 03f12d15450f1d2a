"""What the port's bench tools share: the card's name, the timer, the data
flags, qa1 or its synthetic stand-in, and bench.py's program of serially
dependent batches (``dependent_batches``), which backend_ab,
probe_dispatch and trace_forward run (on the card as one CUDA graph).
"""
from __future__ import annotations

import argparse
import subprocess
import time

QA1 = "qa1_single-supporting-fact"
QA1_SHAPE = (19, 10, 6)          # V, M, W of qa1
SYNTHETIC_SPLITS = (9000, 1000, 1000)


class Timer:
    """Seconds of the work between start() and stop(): CUDA events on a
    CUDA device (closed by a synchronize), else the host clock."""

    def __init__(self, dev):
        import torch
        self.torch, self.cuda = torch, dev.type == "cuda"

    def start(self):
        if self.cuda:
            self.torch.cuda.synchronize()
            self._t0 = self.torch.cuda.Event(enable_timing=True)
            self._t1 = self.torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._h0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self._t1.record()
            self.torch.cuda.synchronize()
            return self._t0.elapsed_time(self._t1) / 1e3
        return time.perf_counter() - self._h0


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0 or not proc.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def add_path_flags(p: argparse.ArgumentParser) -> None:
    """The dataset's directories, defaulting to the config's."""
    from qmann_tpu_torch.config import QmannConfig
    defaults = QmannConfig()
    p.add_argument("--data-path", default=defaults.data_path)
    p.add_argument("--raw-data-path", default=defaults.raw_data_path)


def add_data_flags(p: argparse.ArgumentParser) -> None:
    """qa1 from files, or with --synthetic synthetic_task at qa1's shape."""
    p.add_argument("--synthetic", action="store_true",
                   help="synthetic_task at qa1's shape instead of files")
    add_path_flags(p)


def route_of(cfg) -> dict:
    return {"attention_mode": cfg.attention_mode, "iwl": cfg.iwl,
            "use_pallas": cfg.use_pallas,
            "use_pallas_hamming": cfg.use_pallas_hamming,
            "use_fused_chain": cfg.use_fused_chain}


def load_qa1(args, seed: int = 0, n_train=None):
    """(TaskData, what it is): qa1 through load_task_native at the path
    flags, or with ``args.synthetic`` synthetic_task at qa1's shape from
    ``seed`` (n_train or 9000 train stories, 1000 valid, 1000 test)."""
    import numpy as np
    from qmann_tpu_torch.data import synthetic_task
    from qmann_tpu_torch.data.native import load_task_native
    if args.synthetic:
        data = synthetic_task(np.random.default_rng(seed),
                              n_train or SYNTHETIC_SPLITS[0],
                              *SYNTHETIC_SPLITS[1:], *QA1_SHAPE)
        return data, (f"synthetic_task at qa1's shape (V, M, W = "
                      f"{QA1_SHAPE}), seed {seed}")
    data = load_task_native(QA1, args.data_path, raw_path=args.raw_data_path,
                            limit_train=n_train)
    return data, f"bAbI {QA1} from {args.data_path} / {args.raw_data_path}"


def dependent_batches(forward, mem, que, mask, k: int, graphs=None):
    """bench.py's program (jit over a lax.scan of k batches): k serially
    dependent batches.  Each adds to the question a device scalar made
    from the previous batch's predictions (0, from pred[0] < 0), so no
    batch can be hoisted and no host sync falls between them.  The
    prediction is ``argmax_last`` of the logits, which is bench.py's
    ``cross_entropy(...).pred``: XLA drops that loss's other outputs as
    dead code, and an eager call would compute them.
    ``forward(mem, que, mask)`` -> ForwardResult.  With ``graphs`` (a
    ``graphs.Graphs``, kept across calls) the k batches are one captured
    CUDA graph on the card, the carry computed in it; without, they run
    eagerly.  Returns the [k, B] predictions, on the device."""
    import torch
    from qmann_tpu_torch.ops.losses import argmax_last

    def program(mem, que, mask):
        carry = torch.zeros((), dtype=que.dtype, device=que.device)
        preds = []
        with torch.inference_mode():
            for _ in range(k):
                pred = argmax_last(forward(mem, que + carry, mask).logits)
                carry = (pred[0] < 0).to(que.dtype)
                preds.append(pred)
            return torch.stack(preds)

    if graphs is None:
        return program(mem, que, mask)
    return graphs(("dependent_batches", forward, k), program, mem, que, mask)


def sync_free(fn, dev):
    """fn() with any host sync on the card raising (torch's sync debug
    mode "error"); on the CPU plainly fn()."""
    import torch
    if dev.type != "cuda":
        return fn()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
