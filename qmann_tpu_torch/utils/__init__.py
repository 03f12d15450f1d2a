from qmann_tpu_torch.utils.profiling import PhaseProfiler, trace, annotate
from qmann_tpu_torch.utils.reporting import (
    TaskLoopResult, TaskResult, config_banner, write_results,
    write_run_outputs,
)
from qmann_tpu_torch.utils.checkpoint import save_checkpoint, load_checkpoint

__all__ = [
    "PhaseProfiler", "trace", "annotate",
    "TaskLoopResult", "TaskResult", "config_banner", "write_results",
    "write_run_outputs", "save_checkpoint", "load_checkpoint",
]
