"""Checkpoints with Q-format metadata (counterpart of
``qmann_tpu/utils/checkpoint.py``, in its layout, so that a checkpoint
written by either package loads in the other).

A checkpoint is a directory with:
  * params.npz       — float32 master weights in the JAX layout (the
    training state; ``models.memn2n.params_from_jax`` puts them on a
    device)
  * params_fixed.npz — the same weights fake-quantized at their serving
    Q-formats (what a fixed-point inference engine would load)
  * meta.json        — config, data dims and each weight's Q-format
  * dictionary.json  — the vocabulary, when one is given
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from qmann_tpu_torch.config import QmannConfig
from qmann_tpu_torch.device import to_numpy
from qmann_tpu_torch.numerics import QFormat, float_quant


def _weight_format(name: str, cfg: QmannConfig) -> QFormat:
    """Serving Q-format per parameter (MemN2N/MemN2N.c:826-912 wiring)."""
    if name in ("A", "B", "C", "E", "H"):
        return cfg.fmt_w[0]
    if name == "W":
        return cfg.fmt_ds_ans
    return cfg.fmt_act[0]



def save_checkpoint(ckpt_dir: str, params: Mapping, cfg: QmannConfig, dims,
                    tag: str = "model", dictionary=None) -> str:
    """Write ``params`` (tensors on any device, or numpy arrays) under
    ckpt_dir/tag; returns that path."""
    path = os.path.join(ckpt_dir, tag)
    os.makedirs(path, exist_ok=True)
    np_params = {k: to_numpy(v) for k, v in params.items()}
    np.savez(os.path.join(path, "params.npz"), **np_params)
    fixed = {k: float_quant(torch.from_numpy(v), _weight_format(k, cfg))
             .numpy() for k, v in np_params.items()}
    np.savez(os.path.join(path, "params_fixed.npz"), **fixed)
    meta = {
        "config": dataclasses.asdict(cfg),
        "dims": dataclasses.asdict(dims) if dataclasses.is_dataclass(dims)
                else dict(dims),
        "formats": {k: {"iwl": _weight_format(k, cfg).iwl,
                        "frac": _weight_format(k, cfg).frac}
                    for k in np_params},
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)
    if dictionary is not None:
        with open(os.path.join(path, "dictionary.json"), "w") as f:
            json.dump(list(dictionary.words), f)
    return path


def load_checkpoint(path: str, fixed: bool = False
                    ) -> Tuple[Dict[str, np.ndarray], QmannConfig, dict]:
    """(params as float32 numpy arrays in the JAX layout, config, dims as a
    dict); ``fixed`` reads the fake-quantized weights."""
    fname = "params_fixed.npz" if fixed else "params.npz"
    with np.load(os.path.join(path, fname)) as z:
        params = {k: z[k] for k in z.files}
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    cfg = QmannConfig(**meta["config"])
    return params, cfg, meta["dims"]
