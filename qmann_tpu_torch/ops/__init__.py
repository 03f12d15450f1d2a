from qmann_tpu_torch.ops.qlinear import (
    exact_matmul, qmatvec, qembed_mat, qembed_mat_multi, qscore,
    qscore_partial_sum, qweighted_partial_sum, qweighted_sum,
)
from qmann_tpu_torch.ops.softmax import (
    apply_softmax, exp2_softmax, exp_plan, exp_plan_softmax, shift_softmax,
    softmax,
)
from qmann_tpu_torch.ops.losses import (
    cross_entropy, argmax_last, CEMetrics, squared_error,
)
from qmann_tpu_torch.ops.elementwise import (
    qsum, activation, maxout, qmult, scale_apply,
)

__all__ = [
    "exact_matmul", "qmatvec", "qembed_mat", "qembed_mat_multi", "qscore",
    "qscore_partial_sum", "qweighted_partial_sum", "qweighted_sum",
    "apply_softmax", "exp2_softmax", "exp_plan", "exp_plan_softmax",
    "shift_softmax", "softmax", "cross_entropy", "argmax_last", "CEMetrics",
    "squared_error", "qsum", "activation", "maxout", "qmult", "scale_apply",
]
