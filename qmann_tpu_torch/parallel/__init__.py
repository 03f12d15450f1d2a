"""The device mesh over torch.distributed (counterpart of
``qmann_tpu/parallel/``): the mesh and process groups (``mesh.py``), the
collectives and the memory-sharded read (``distributed.py``), the sharding
rules and sharded steps (``sharding.py``), the explicit step
(``explicit.py``) and local process groups (``launch.py``)."""
from qmann_tpu_torch.parallel.mesh import make_mesh, DATA_AXIS, MODEL_AXIS
from qmann_tpu_torch.parallel.sharding import (
    axis_if_divisible, param_shardings, batch_shardings, shard_params,
    shard_batch, make_sharded_train_step, make_sharded_eval_step,
    shard_prepared, make_sharded_prepared_infer,
)
from qmann_tpu_torch.parallel.distributed import memory_sharded_attention_read
from qmann_tpu_torch.parallel.explicit import make_explicit_train_step

__all__ = [
    "make_mesh", "DATA_AXIS", "MODEL_AXIS",
    "axis_if_divisible",
    "param_shardings", "batch_shardings", "shard_params", "shard_batch",
    "make_sharded_train_step", "make_sharded_eval_step",
    "shard_prepared", "make_sharded_prepared_infer",
    "memory_sharded_attention_read", "make_explicit_train_step",
]
