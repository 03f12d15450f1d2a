from qmann_tpu_torch.data.babi import (
    DataDims, Dictionary, Sample, TaskData, VectorizedSplit, compute_dims,
    load_samples, load_task, load_test_split, parse_parsed_file,
    parse_raw_file, resolve_task_file, synthetic_batch, synthetic_samples,
    synthetic_task, vectorize, write_synthetic_corpus,
)

__all__ = ["DataDims", "Dictionary", "Sample", "TaskData", "VectorizedSplit",
           "compute_dims", "load_samples", "load_task", "load_test_split",
           "parse_parsed_file", "parse_raw_file", "resolve_task_file",
           "synthetic_batch", "synthetic_samples", "synthetic_task",
           "vectorize", "write_synthetic_corpus"]
