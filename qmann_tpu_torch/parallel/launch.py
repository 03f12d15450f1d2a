"""Start a process group of local ranks and collect what each returns.

``run_ranks(fn, world, args)`` spawns ``world`` processes (the ``spawn``
start method: CUDA cannot be forked), joins them in one group on a
localhost store through ``initialize_multihost``, calls ``fn(*args)`` in
each and returns the ranks' results in rank order.  Each rank sets
torchrun's environment variables (RANK, LOCAL_RANK, WORLD_SIZE,
LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), so ``fn`` sees what it would
under ``python -m torch.distributed.run``.  ``group_timeout`` is the
group's collective timeout (``initialize_multihost``).  ``fn`` must be
importable by name: a spawned rank imports its module (and, through this
one, ``qmann_tpu_torch``, whose import turns TF32 off before any
matmul).

``init_single_process`` makes the group of one process in process (an
in-memory store): what a mesh of one rank needs outside torchrun.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from qmann_tpu_torch.parallel.mesh import backend_for, initialize_multihost


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_single_process(device="cuda") -> str:
    """A world-1 process group in this process; returns its backend."""
    dev_type = torch.device(device).type
    backend = backend_for(dev_type, 1, torch.cuda.device_count()
                          if dev_type == "cuda" else 0)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    return backend


def _rank_main(fn, rank: int, world: int, port: int, device: str,
               args: Sequence, results,
               group_timeout: Optional[datetime.timedelta]) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    if torch.device(device).type == "cpu":
        # many small ops per rank, several ranks per host: one thread each
        torch.set_num_threads(1)
    try:
        initialize_multihost(device=device, timeout=group_timeout)
        out = fn(*args)
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              device="cuda", timeout: float = 600.0,
              group_timeout: Optional[datetime.timedelta] = None
              ) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks of one process group
    and return their results in rank order.  Raises RuntimeError with the
    traceback of a rank that failed, TimeoutError when the ranks outlive
    ``timeout`` seconds; every rank is ended either way.  group_timeout
    bounds each collective of the group (None: torch's default)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, str(device), tuple(args),
                               results, group_timeout))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world:
            # after a failure, the others get a short grace: they may be
            # blocked in a collective the failed rank never joined
            left = deadline - time.monotonic()
            if errors:
                left = min(left, 5.0)
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=left)
            except queue.Empty:
                break
            (got if ok else errors)[rank] = out
        for p in procs:
            p.join(timeout=max(0.0, min(30.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if errors:
        rank = min(errors)
        raise RuntimeError(f"rank {rank} of {world} failed:\n{errors[rank]}")
    if len(got) < world:
        missing = sorted(set(range(world)) - set(got))
        raise TimeoutError(f"ranks {missing} of {world} returned nothing "
                           f"within {timeout} s")
    return [got[r] for r in range(world)]
