"""The harness driven end to end on the CPU at tiny sizes, through cells
added from files alone: a run is correct, its last line has the driver's
keys with the numbers compared last, and each fault a cell can have,
planted in the program underneath, turns ``correct`` false.  Also the
whole-name import check and the exit without a card; on the card, the
control at each cell's own size."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import common, harness

# each cell's traffic, cut to a size a test run holds
TINY = {
    "family.m2.runsh": dict(tasks=2, seeds_per_task=2, train_sizes=[70, 45],
                            valid=20, test=20, eval_chunk=16,
                            max_sentences=8, vocab=16, sentences=[1, 8],
                            trace_seconds=0.3),
    "step.m3.cli": dict(train=70, valid=20, test=30, eval_chunk=32,
                        trace_seconds=0.3),
    "serve.m2.b1000": dict(batch=16, chain=3, pool=2, max_sentences=8,
                           vocab=16, sentences=[1, 8], trace_seconds=0.3),
    "engine.m2.open": dict(pool=64, rate=300.0, max_sentences=8, vocab=16,
                           sentences=[1, 8], engine_batch=8,
                           trace_seconds=0.3),
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A checkout's benchmark files with one throwaway cell added for each
    cell: a traffic file, a cell file and an entry in BENCHMARK.json."""
    base = tmp_path_factory.mktemp("checkout")
    shutil.copytree(common.BENCH_DIR, base / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = common.load_spec()
    for name, cut in TINY.items():
        cell = common.find_cell(spec, name)
        tiny = f"tiny.{name}"
        traffic = dict(cell["traffic"], **cut)
        (base / "benchmark" / "traffic" / f"tiny_{name}.json").write_text(
            json.dumps(traffic))
        (base / "benchmark" / "workloads" / f"{tiny}.json").write_text(
            json.dumps(cell["cell"]))
        spec["workloads"].append(dict(cell["workload"], name=tiny,
                                      traffic=f"tiny_{name}"))
        for m in spec["end_to_end"] + spec["per_layer"]:
            if name in m.get("workloads", []):
                m["workloads"].append(tiny)
    (base / "BENCHMARK.json").write_text(json.dumps(spec))
    return base


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(root, name, trace=False, seed=2 ** 33 + 1):
    spec = common.load_spec(root)
    cell = common.find_cell(spec, f"tiny.{name}", root)
    return harness.run_cell(cell, seed, 0.3, trace, torch.device("cpu"))


@pytest.mark.parametrize("name", list(TINY))
def test_a_cell_from_files_alone_runs_correct(root, name):
    out = run(root, name)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    line = harness.result_line(out, "cpu", 1, "none")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    e2e = {m["name"] for m in common.find_cell(
        common.load_spec(root), f"tiny.{name}", root)["end_to_end"]}
    assert set(line["metrics"]) == e2e
    assert all(set(v) == {"value", "limit"}
               for v in line["compared"].values())
    json.dumps(line)


def test_a_traced_run_reads_per_layer_metrics(root):
    out = run(root, "step.m3.cli", trace=True)
    assert out["correct"]
    line = harness.result_line(out, "cpu", 1, "none")
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "mfu.cli" in line["metrics"]
    assert all(m["unit"] for m in line["metrics"].values())


def _unchanged(*args, **kw):
    return args[0]


def _half_batch(orig):
    def loss(params, memory, question, answer, mask, sample_mask, cfg,
             remove_softmax=False):
        sm = sample_mask.clone()
        sm[..., sm.shape[-1] // 2:] = 0.0
        total, met = orig(params, memory, question, answer, mask, sm, cfg,
                          remove_softmax)
        return 2.0 * total, met
    return loss


def _altered(orig):
    def argmax(x, dim=-1):
        pred = orig(x, dim=dim).clone()
        pred.view(-1)[0] = (pred.view(-1)[0] + 1) % x.shape[-1]
        return pred
    return argmax


@pytest.mark.parametrize("name", ["family.m2.runsh", "step.m3.cli"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_training_faults_fail_the_check(root, monkeypatch, name, fault):
    from qmann_tpu_torch.models import memn2n
    from qmann_tpu_torch.train import multi, trainer
    if fault == "unchanged":
        for mod in (trainer, multi):
            monkeypatch.setattr(mod, "sgd_update", _unchanged)
            monkeypatch.setattr(mod, "zero_null_columns", _unchanged)
    else:
        monkeypatch.setattr(memn2n, "loss_and_metrics",
                            _half_batch(memn2n.loss_and_metrics))
    assert not run(root, name)["correct"]


@pytest.mark.parametrize("name", ["serve.m2.b1000", "engine.m2.open"])
def test_an_altered_answer_fails_the_check(root, monkeypatch, name):
    from qmann_tpu_torch.ops import losses
    from qmann_tpu_torch.serve import engine
    monkeypatch.setattr(losses, "argmax_last",
                        _altered(losses.argmax_last))
    monkeypatch.setattr(engine, "argmax_last", _altered(engine.argmax_last))
    assert not run(root, name)["correct"]


def test_banned_modules_compare_whole_names():
    assert common.banned_modules(["qmann_tpu_torch", "qmann_tpu_torch.ops",
                                  "jaxtyping", "flaxen"]) == []
    assert common.banned_modules(["qmann_tpu.ops", "jax.numpy", "jaxlib",
                                  "flax"]) == ["flax", "jax", "jaxlib",
                                               "qmann_tpu"]


def test_a_cell_loads_no_jax(root):
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from benchmark import common, harness\n"
        "from benchmark.tests.test_bench_harness import run\n"
        "from pathlib import Path\n"
        "torch.set_num_threads(2)\n"
        "assert run(Path(%r), 'serve.m2.b1000')['correct']\n"
        "print(common.banned_modules())\n" % (str(common.ROOT), str(root)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "step.m3.cli", "--seed", "1",
                         "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_no_program_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files,
    a run exits with an error and prints no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shutil.copytree(common.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "step.m3.cli", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(TINY))
def test_the_control_fails_at_the_cells_size(name):
    """The reference in TF32 in the program's place, at the cell's own
    size, on three seeds: each fails one of the cell's numbers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = common.find_cell(common.load_spec(), name)
    limits = cell["cell"]["limits"]
    for seed in (2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13):
        job = harness.load_job(cell["traffic"]["job"])(
            cell, seed, torch.device("cuda:0"))
        job.setup()
        job.window(min(2.0, cell["traffic"]["trace_seconds"]))
        job.release()
        got = job.readings(control="tf32")
        assert any(got[k] > limits[k] for k in limits), (seed, got)
