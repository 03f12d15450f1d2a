from qmann_tpu_torch.data.babi import DataDims, Dictionary, synthetic_batch

__all__ = ["DataDims", "Dictionary", "synthetic_batch"]
