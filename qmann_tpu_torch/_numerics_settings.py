"""Global torch numerics switches the port depends on, set in one place.

The exact embedding GEMM (``models.memn2n.forward_prepared``) multiplies
small integer counts by Q-format weights and relies on every product and
partial sum being exact in float32.  A bf16 ``torch.matmul`` would round
its float32 sums back to bf16 on output, and TF32 keeps ~10 significand
bits of each operand, so the GEMM and the float output layer run in full
float32 with both TF32 switches off.  Importing ``qmann_tpu_torch`` applies
these settings.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
torch.set_float32_matmul_precision("highest")
