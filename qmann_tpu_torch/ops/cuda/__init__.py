"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version.  Sources live in ``qmann_tpu_torch/csrc/``."""
from qmann_tpu_torch.ops.cuda.hop_chain import (
    fused_hop_chain, fused_hop_chain_reference,
)

__all__ = ["fused_hop_chain", "fused_hop_chain_reference"]
