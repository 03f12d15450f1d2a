"""python -m qmann_tpu_torch <num_task_loop> <task_start> <task_end> <iwl>
[flags]: the command-line training run (``qmann_tpu_torch/cli.py``)."""
import sys

from qmann_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
