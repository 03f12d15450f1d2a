from qmann_tpu_torch.train.optim import (
    adamax_update, lr_schedule, rmsprop_update, rowsum_l2_norm,
    sgd_momentum_update, sgd_update, zero_null_columns,
)
from qmann_tpu_torch.train.trainer import (
    EpochMetrics, TrainResult, eval_split, evaluate, train_epoch, train_step,
    train_task,
)

__all__ = ["adamax_update", "lr_schedule", "rmsprop_update",
           "rowsum_l2_norm", "sgd_momentum_update", "sgd_update",
           "zero_null_columns", "EpochMetrics", "TrainResult", "eval_split",
           "evaluate", "train_epoch", "train_step", "train_task"]
