"""What the harness's parts share: where the benchmark's files are, how a
cell is found from its name, the program's configuration and weights made
from a configuration file, and the process's age."""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict

import torch

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "qmann_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one cell is made of, by its name in ``spec``: its
    ``workload`` entry, its ``config`` entry and file, its ``traffic`` file
    (``traffic/<traffic>.json``), its ``limits`` (``workloads/<name>.json``)
    and the metrics it reports."""
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    bench = root / "benchmark"

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "root": root,
        "workload": wl,
        "config": cfg_entry,
        "model_file": load_json(root / cfg_entry["file"]),
        "traffic": load_json(bench / "traffic" / f"{wl['traffic']}.json"),
        "cell": load_json(bench / "workloads" / f"{name}.json"),
        "end_to_end": [m for m in spec["end_to_end"] if reports(m)],
        "per_layer": [m for m in spec["per_layer"] if reports(m)],
    }


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (``qmann_tpu_torch`` is not ``qmann_tpu``)."""
    import sys
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED_MODULES))


def program_config(model: dict, route: dict):
    """The program's ``QmannConfig`` from a configuration file's ``model``
    fields and a traffic file's ``route`` flags."""
    from qmann_tpu_torch.config import QmannConfig
    return QmannConfig(**model, **route, verbose=False)


def make_weights(model: dict, dim_input: int, weight_std: float, seed: int,
                 device, runs: int = 0) -> Dict[str, torch.Tensor]:
    """The layer-wise-tied MemN2N's weights (A, C, B [D, I], W [I, D],
    H [D, D]; [runs, ...] stacked when runs > 0), Gaussian(0, weight_std)
    drawn on ``device`` from the seed's weight stream, in float32, with
    the NULL column (input 0) of A and C zero, as every SGD step leaves
    it."""
    from benchmark.stories import generator
    if model["type_weight_tying"] != 2 or not model["en_linear_mapping"]:
        raise ValueError("the harness makes layer-wise-tied weights with a "
                         "linear map")
    D, I = model["dim_emb"], dim_input
    lead = (runs,) if runs else ()
    g = generator(seed, 1, device)
    flat = torch.randn(lead + (3 * D * I + I * D + D * D,), generator=g,
                       device=device) * weight_std
    sizes = [D * I, D * I, D * I, I * D, D * D]
    shapes = [(D, I), (D, I), (D, I), (I, D), (D, D)]
    out = {}
    for k, part, shape in zip("ACBWH", torch.split(flat, sizes, dim=-1),
                              shapes):
        out[k] = part.reshape(lead + shape).contiguous()
    out["A"][..., 0] = 0.0
    out["C"][..., 0] = 0.0
    return out


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc, at
    the kernel's clock-tick resolution)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start
