"""Result reporting compatible with the reference's CSV outputs
(counterpart of ``qmann_tpu/utils/reporting.py``; the same bytes for the
same results, held equal by tests/test_torch_utils.py).

The reference writes two CSVs (MemN2N/MemN2N.c:318-360 header,
:3066-3101 per-task rows):
  * result.csv      — config banner + one row per task with
                      avg/max/min of train/test time and error over the
                      task-loop repeats
  * result_all.csv  — the same plus per-layer-constructor echoes and the
                      per-loop test errors
"""
from __future__ import annotations

import dataclasses
import io
import os
from typing import List, Sequence

from qmann_tpu_torch.config import QmannConfig


@dataclasses.dataclass
class TaskLoopResult:
    time_train: float
    err_train: float
    time_test: float
    err_test: float


@dataclasses.dataclass
class TaskResult:
    task_index: int
    loops: List[TaskLoopResult]

    def _stats(self, vals: Sequence[float]):
        return (sum(vals) / len(vals), max(vals), min(vals))

    def row(self) -> str:
        tt = self._stats([l.time_train for l in self.loops])
        et = self._stats([l.err_train for l in self.loops])
        ts = self._stats([l.time_test for l in self.loops])
        es = self._stats([l.err_test for l in self.loops])
        cells = [self.task_index, *tt, *et, *ts, *es]
        return ",".join(f"{c:f}" if isinstance(c, float) else str(c)
                        for c in cells)


def config_banner(cfg: QmannConfig) -> str:
    """Config echo like the reference's stdout banner
    (MemN2N/MemN2N.c:298-313)."""
    buf = io.StringIO()
    print("< Configurations >", file=buf)
    print(f"    Attention mode     : {cfg.attention_mode}", file=buf)
    print(f"    Fixed point        : {cfg.en_fixed_point}", file=buf)
    print(f"    BW_WL / iwl / frac : {cfg.bw_wl} / {cfg.iwl} / {cfg.frac}",
          file=buf)
    print(f"    EN_MQ              : {cfg.en_mq}", file=buf)
    print(f"    Binary mode        : {cfg.binary_mode}", file=buf)
    print(f"    Hops / dim_emb     : {cfg.num_hops} / {cfg.dim_emb}", file=buf)
    print(f"    Weight tying       : {cfg.type_weight_tying}", file=buf)
    print(f"    Linear mapping     : {cfg.en_linear_mapping}", file=buf)
    print(f"    Temporal encoding  : {cfg.en_time}", file=buf)
    print(f"    lr / decay / itrs  : {cfg.learning_rate} / "
          f"{cfg.rate_decay_step} / {cfg.num_itr}", file=buf)
    print(f"    Batch size         : {cfg.size_batch}", file=buf)
    print(f"    Grad L2 clip       : {cfg.max_grad_l2_norm}", file=buf)
    return buf.getvalue()


_HEADER = ("ind_data_set,time_train_avg,time_train_max,time_train_min,"
           "err_train_avg,err_train_max,err_train_min,time_test_avg,"
           "time_test_max,time_test_min,err_test_avg,err_test_max,"
           "err_test_min")


def write_results(path: str, cfg: QmannConfig, results: Sequence[TaskResult],
                  all_variant: bool = False) -> None:
    """Append a run's results in the reference CSV shape."""
    with open(path, "a") as f:
        f.write("<config>\n")
        for line in config_banner(cfg).splitlines():
            f.write(f"# {line}\n")
        header = _HEADER
        if all_variant and results:
            n_loops = len(results[0].loops)
            header += "," + ",".join(str(i) for i in range(n_loops))
        f.write(header + "\n")
        for r in results:
            row = r.row()
            if all_variant:
                row += "," + ",".join(f"{l.err_test:f}" for l in r.loops)
            f.write(row + "\n")


def write_run_outputs(out_dir: str, cfg: QmannConfig,
                      results: Sequence[TaskResult]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    write_results(os.path.join(out_dir, "result.csv"), cfg, results)
    write_results(os.path.join(out_dir, "result_all.csv"), cfg, results,
                  all_variant=True)
