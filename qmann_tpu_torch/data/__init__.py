from qmann_tpu_torch.data.babi import (
    DataDims, Dictionary, Sample, TaskData, VectorizedSplit, compute_dims,
    synthetic_batch, synthetic_samples, synthetic_task, vectorize,
)

__all__ = ["DataDims", "Dictionary", "Sample", "TaskData", "VectorizedSplit",
           "compute_dims", "synthetic_batch", "synthetic_samples",
           "synthetic_task", "vectorize"]
