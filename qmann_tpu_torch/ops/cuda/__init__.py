"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Sources live in ``qmann_tpu_torch/csrc/``."""
from qmann_tpu_torch.ops.cuda.attention_read import (
    fused_read, fused_read_reference,
)
from qmann_tpu_torch.ops.cuda.hamming import (
    hamming_score_kernel, hamming_score_reference,
)
from qmann_tpu_torch.ops.cuda.hamming_bwd import (
    hamming_backward, hamming_backward_kernel,
)
from qmann_tpu_torch.ops.cuda.hop_chain import (
    fused_hop_chain_from_memory, fused_hop_chain_from_memory_reference,
    fused_hop_chain_reference,
)
from qmann_tpu_torch.ops.cuda.qmatvec import (
    quantized_matvec, quantized_matvec_reference,
)
from qmann_tpu_torch.ops.cuda.qweighted_sum_bwd import (
    qweighted_sum_backward_kernel, weighted_sum_softmax_backward_kernel,
)

__all__ = ["fused_hop_chain_from_memory",
           "fused_hop_chain_from_memory_reference", "fused_hop_chain_reference",
           "fused_read", "fused_read_reference", "hamming_backward",
           "hamming_backward_kernel", "hamming_score_kernel",
           "hamming_score_reference", "quantized_matvec",
           "quantized_matvec_reference", "qweighted_sum_backward_kernel",
           "weighted_sum_softmax_backward_kernel"]
