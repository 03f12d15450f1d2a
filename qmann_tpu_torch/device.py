"""Device selection for the port's entry points, and host copies.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``).  Asking for a CUDA device on a machine without one
raises: nothing falls back to the CPU quietly.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises RuntimeError for a CUDA
    device when torch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but torch sees no CUDA "
            "device; pass device='cpu' to run on the CPU")
    return dev


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a tensor on any device; other arrays as
    ``np.asarray`` gives them."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
