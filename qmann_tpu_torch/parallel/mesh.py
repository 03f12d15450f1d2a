"""The device mesh over ``torch.distributed`` ranks (counterpart of
``qmann_tpu/parallel/mesh.py``).

Two axes, as in the JAX package:

  "data"  — batch data parallelism
  "model" — the memory-sentence axis (memory-bank sharding)

One process (rank) per mesh position, laid out row-major as JAX's
``reshape(n // mp, mp)``: rank = data_idx * model + model_idx.  A rank
holds one process group per axis of size above 1: the ranks of its row
(same data_idx: the "model" axis) and of its column (same model_idx: the
"data" axis).  An axis of size 1 has no group: nothing crosses it.

The backend rule (``backend_for``): NCCL where every rank of a host has a
card of its own; gloo where ranks share a card (NCCL refuses two ranks on
one device) or on the CPU.  Gloo stages CUDA tensors through the host and
takes them only in ``all_reduce`` and ``broadcast``, so every collective
of the port is one of those two.  Each rank's device is
``cuda:(local_rank % device_count)``.

The process group is the caller's: ``initialize_multihost`` makes it
(``python -m torch.distributed.run`` / torchrun sets the environment it
reads), and every rank then calls ``make_mesh`` with the same arguments.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, MODEL_AXIS)


def backend_for(device_type: str, local_world_size: int,
                device_count: int) -> str:
    """"nccl" when every rank of a host has a card of its own, "gloo" when
    ranks share a card or run on the CPU."""
    if device_type == "cuda" and local_world_size <= device_count:
        return "nccl"
    return "gloo"


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()
                              if dist.is_initialized() else 0))


def _local_world_size() -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()
                              if dist.is_initialized() else 1))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)`` for a CUDA
    ``device`` (raises without a card), the CPU for "cpu"."""
    from qmann_tpu_torch.device import resolve_device
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    return torch.device("cuda", _local_rank() % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ("data", "model") mesh."""
    data: int
    model: int
    data_idx: int
    model_idx: int
    device: torch.device
    backend: str
    # axis name -> the process group of this rank along it (None: size 1)
    groups: Dict[str, Optional[object]]

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def rank(self) -> int:
        return self.data_idx * self.model + self.model_idx

    @property
    def world(self) -> int:
        return self.data * self.model

    def index(self, axis: str) -> int:
        return self.data_idx if axis == DATA_AXIS else self.model_idx

    def group(self, axes):
        """The process group spanning ``axes`` (one name or a sequence),
        or None when every one of them has size 1."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        live = [a for a in names if self.shape[a] > 1]
        if not live:
            return None
        if len(live) == 2:
            return dist.group.WORLD
        return self.groups[live[0]]


def rank0_only(log: Callable = print,
               mesh: Optional[Mesh] = None) -> Callable:
    """``log`` on rank 0 of ``mesh`` (or without a mesh); on the other
    ranks a function that prints nothing."""
    if mesh is None or mesh.rank == 0:
        return log
    return lambda *_args, **_kw: None


def make_mesh(n_devices: Optional[int] = None,
              model_parallelism: Optional[int] = None,
              device="cuda") -> Mesh:
    """Build this rank's ("data", "model") mesh over the process group.

    n_devices is the number of ranks (default: the world size; a mesh
    spans the whole world, so any other value raises).  model_parallelism
    defaults to JAX's rule: 4, else 2, else 1, whichever first divides n.
    Every rank must call this with the same arguments: the axis groups are
    made collectively, in one order.  Without a process group, only a mesh
    of one rank can be built."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a world of {n} "
                         f"processes; this one has {world} (start them with "
                         "python -m torch.distributed.run)")
    if model_parallelism is None:
        model_parallelism = next((c for c in (4, 2) if n % c == 0), 1)
    if n % model_parallelism:
        raise ValueError(f"model parallelism {model_parallelism} does not "
                         f"divide {n} ranks")
    mp = model_parallelism
    rank = dist.get_rank() if dist.is_initialized() else 0
    data_idx, model_idx = divmod(rank, mp)
    groups = {DATA_AXIS: None, MODEL_AXIS: None}
    # every rank creates every group, in the same order
    if mp > 1:
        for d in range(n // mp):
            g = dist.new_group([d * mp + j for j in range(mp)])
            if d == data_idx:
                groups[MODEL_AXIS] = g
    if n // mp > 1:
        for j in range(mp):
            g = dist.new_group([d * mp + j for d in range(n // mp)])
            if j == model_idx:
                groups[DATA_AXIS] = g
    dev = rank_device(device)
    backend = (dist.get_backend() if dist.is_initialized()
               else backend_for(dev.type, 1, torch.cuda.device_count()))
    return Mesh(n // mp, mp, data_idx, model_idx, dev, backend, groups)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device="cuda") -> str:
    """Join the process group (``torch.distributed.init_process_group``)
    with the backend rule's backend; returns it.

    Without coordinator_address the group is read from the environment
    torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); else
    "host:port" of rank 0's store, with num_processes and process_id.
    Call once per process before make_mesh / make_hybrid_mesh."""
    dev_type = torch.device(device).type
    if coordinator_address is None:
        init = dict(init_method="env://")
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ.get("WORLD_SIZE", 1)))
    else:
        init = dict(init_method=f"tcp://{coordinator_address}",
                    world_size=num_processes, rank=process_id)
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    count = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = backend_for(dev_type, local_world, count)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend, **init)
    return backend


def make_hybrid_mesh(model_parallelism: int = 4, device="cuda") -> Mesh:
    """The multi-host mesh: the "model" axis stays inside one host and the
    "data" axis spans hosts.  torchrun numbers ranks host by host, so the
    row-major layout keeps a row on one host when model_parallelism
    divides the ranks per host (LOCAL_WORLD_SIZE)."""
    local = _local_world_size()
    if local % model_parallelism:
        raise ValueError(f"model parallelism {model_parallelism} does not "
                         f"divide the {local} ranks of a host: the model "
                         "axis would cross hosts")
    return make_mesh(None, model_parallelism, device)

