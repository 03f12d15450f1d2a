from qmann_tpu_torch.ops.qlinear import (
    exact_matmul, qmatvec, qembed_mat, qembed_mat_multi, qscore,
    qweighted_sum,
)
from qmann_tpu_torch.ops.softmax import softmax
from qmann_tpu_torch.ops.losses import cross_entropy, argmax_last, CEMetrics
from qmann_tpu_torch.ops.elementwise import qsum, activation

__all__ = [
    "exact_matmul", "qmatvec", "qembed_mat", "qembed_mat_multi", "qscore",
    "qweighted_sum", "softmax", "cross_entropy", "argmax_last", "CEMetrics",
    "qsum", "activation",
]
