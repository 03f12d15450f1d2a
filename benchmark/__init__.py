"""The benchmark of ``qmann_tpu_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: a harness driven by ``BENCHMARK.json`` and data files.

* ``run.py``: the entry (``harness.py``: one run of one cell);
* ``configs/<name>.json``: each model configuration as it is run;
* ``traffic/<mix>.json``: each traffic mix, read by the one generator
  (``stories.py``) and by the job kind it names (``jobs/<kind>.py``);
* ``workloads/<cell>.json``: each cell's limits for the check;
* ``metrics/<name>.py``: one reader per per-layer metric;
* ``work.py`` and ``peaks.json``: the operations, bytes and peaks;
* ``reference.py``: the plain reference the check compares with;
* ``calibrate.py``, ``sweep_knee.py``: how the limits and the engine's rate
  were found.

A later cell, configuration, mix or metric is new files and new entries in
``BENCHMARK.json``; no existing file needs an edit.  Nothing here imports
JAX or the JAX package (``qmann_tpu``).
"""
