from qmann_tpu_torch.models import memn2n
from qmann_tpu_torch.models.memn2n import (
    ForwardResult, Params, PreparedInference, forward, forward_prepared,
    init_params, loss_and_metrics, params_from_jax, params_to_jax,
    prepare_inference,
)

__all__ = ["memn2n", "ForwardResult", "Params", "PreparedInference",
           "forward", "forward_prepared", "init_params", "loss_and_metrics",
           "params_from_jax", "params_to_jax", "prepare_inference"]
