"""The port's command line against the JAX package's: the parser's
positionals, flags and defaults, the config it builds, both run modes on
the CPU over files the test writes from a numpy seed, the refusals, and
the throughput tool.  The JAX CLI's own runs need the bAbI dataset.

Tolerance: none (parsers and configs are compared field by field).
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from qmann_tpu import cli as jcli  # noqa: E402
from qmann_tpu_torch import cli  # noqa: E402
from qmann_tpu_torch.bench import qps  # noqa: E402
from qmann_tpu_torch.data import babi  # noqa: E402
from qmann_tpu_torch.utils import checkpoint  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _actions(parser):
    return {a.dest: a for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_parser_has_jax_positionals_flags_and_defaults():
    got, want = _actions(cli.build_parser()), _actions(jcli.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, w in want.items():
        g = got[dest]
        for field in ("option_strings", "default", "type", "choices",
                      "nargs", "const", "required"):
            assert getattr(g, field) == getattr(w, field), (dest, field)
        assert type(g) is type(w), dest
    assert got["device"].default == "cuda"
    assert got["device"].option_strings == ["--device"]


ARGVS = [
    [],
    ["3", "2", "5", "1", "--attention-mode", "3", "--use-pallas",
     "--hamming-unweighted", "--hamming-weight-para", "-1", "--epochs", "7",
     "--quant-mode", "2", "--grad-quant", "--grad-quant-placement",
     "update", "--no-time", "--pe", "--similarity-analysis",
     "--similarity-probe", "0", "--out-dir", "o", "--seed", "4"],
    ["1", "1", "20", "5", "--joint", "--shuffle", "--dim-forced",
     "--max-dict-len", "192", "--max-sen-len", "64", "--use-pallas"],
    ["2", "4", "4", "0", "--binary-mode", "--no-mq", "--tying", "1",
     "--no-linear-mapping", "--dim-emb", "20", "--hops", "2",
     "--batch-size", "8", "--lr", "0.05", "--weight-decay", "0.001",
     "--save-best-model", "--similarity-dir", "s", "--use-raw",
     "--rand-noise-time", "0.1", "--use-fused-chain", "--quiet",
     "--non-linearity", "--no-fixed-point", "--bw-wl", "10",
     "--data-path", "d", "--raw-data-path", "r"],
    ["--linear-start", "--sc-att", "--shift-based-sm", "--att-shift",
     "--use-pallas-hamming", "--mesh", "4,2", "--max-samples", "9"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_config_from_args_matches_jax(argv):
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.fixture
def corpus(tmp_path):
    return babi.write_synthetic_corpus(str(tmp_path / "data"),
                                       np.random.default_rng(11), [1, 2],
                                       80, 24, parsed=[1])


def _small(parsed_dir, raw_dir, out):
    return ["--epochs", "1", "--dim-emb", "8", "--hops", "2", "--use-pallas",
            "--data-path", parsed_dir, "--raw-data-path", raw_dir,
            "--out-dir", str(out), "--checkpoint-dir", str(out / "ckpt"),
            "--device", "cpu", "--quiet", "--profile"]


def _rows(path):
    lines = Path(path).read_text().splitlines()
    head = lines.index(next(ln for ln in lines
                            if ln.startswith("ind_data_set")))
    return [ln.split(",") for ln in lines[head + 1:]]


def test_main_per_task_mode_on_the_cpu(corpus, tmp_path, capsys):
    out = tmp_path / "out"
    assert cli.main(["2", "1", "2", "5", *_small(*corpus, out)]) == 0
    printed = capsys.readouterr().out
    assert "< Time Profile >" in printed and "Dim input : 30" in printed
    rows = _rows(out / "result.csv")
    assert [r[0] for r in rows] == ["1", "2"] and len(rows[0]) == 13
    assert [len(r) for r in _rows(out / "result_all.csv")] == [15, 15]
    tags = sorted(os.listdir(out / "ckpt"))
    assert tags == [f"{t}_loop{i}" for t in ("qa1_single-supporting-fact",
                                             "qa2_two-supporting-facts")
                    for i in range(2)]
    params, cfg, dims = checkpoint.load_checkpoint(str(out / "ckpt" /
                                                       tags[1]))
    assert cfg.seed == 1 and cfg.use_pallas and cfg.dim_emb == 8
    assert dims["dim_input"] == 30 and params["A"].shape == (8, 30)


def test_main_joint_mode_on_the_cpu(corpus, tmp_path, capsys):
    """EN_JOINT at small forced dims: one training run on qa_joint, each
    task tested with it."""
    out = tmp_path / "out"
    argv = ["1", "1", "2", "5", "--joint", "--shuffle", "--dim-forced",
            "--max-dict-len", "24", "--max-sen-len", "12",
            "--max-samples", "96", "--max-test-samples", "16",
            *_small(*corpus, out)]
    assert cli.main(argv) == 0
    assert "Joint training: 87 samples, dict 24" in capsys.readouterr().out
    rows = _rows(out / "result.csv")
    assert [r[0] for r in rows] == ["1", "2"]
    assert os.listdir(out / "ckpt") == ["qa_joint_loop0"]
    _, _, dims = checkpoint.load_checkpoint(str(out / "ckpt" /
                                                "qa_joint_loop0"))
    assert dims["dim_input"] == 36


@pytest.mark.parametrize("flag", [["--mesh", "2,1"], ["--linear-start"],
                                  ["--sc-att"], ["--shift-based-sm"],
                                  ["--att-shift"], ["--att-clip"]])
def test_mesh_and_feature_flags_on_the_command_line(tmp_path, request, flag,
                                                    capsys):
    """--mesh 2,1 outside torchrun exits 2 before any data is read (no data
    exists at the paths given), naming torchrun; --mesh 1,1 runs on a group
    of this one process, prints the mesh banner with its backend, writes
    its result row and leaves no process group behind.  The feature flags
    each run task 1 on 32 stories of the files the fixture writes
    (--linear-start: 1 epoch after the 5 linear-start ones), write their
    result row and a checkpoint whose config carries the flag."""
    import torch.distributed as dist
    if flag[0] == "--mesh":
        assert cli.main(["1", "1", "1", "5", *flag, "--device", "cpu",
                         "--data-path", str(tmp_path / "none"),
                         "--raw-data-path", str(tmp_path / "none"),
                         "--out-dir", str(tmp_path)]) == 2
        assert "torch.distributed.run --standalone --nproc-per-node 2" in \
            capsys.readouterr().err
        assert os.listdir(tmp_path) == [] and not dist.is_initialized()
        corpus = request.getfixturevalue("corpus")
        out = tmp_path / "out"
        assert cli.main(["1", "1", "1", "5", "--mesh", "1,1",
                         "--max-samples", "32", *_small(*corpus, out)]) == 0
        assert "< Mesh : data=1 model=1 > backend gloo" in \
            capsys.readouterr().out
        assert [r[0] for r in _rows(out / "result.csv")] == ["1"]
        assert not dist.is_initialized()
        return
    corpus = request.getfixturevalue("corpus")
    out = tmp_path / "out"
    assert cli.main(["1", "1", "1", "5", *flag, "--max-samples", "32",
                     *_small(*corpus, out)]) == 0
    assert [r[0] for r in _rows(out / "result.csv")] == ["1"]
    params, cfg, _ = checkpoint.load_checkpoint(
        str(out / "ckpt" / "qa1_single-supporting-fact_loop0"))
    field = {"--linear-start": "en_linear_start", "--sc-att": "en_sc_att",
             "--shift-based-sm": "en_shift_based_sm",
             "--att-shift": "en_att_shift",
             "--att-clip": "en_att_clip"}[flag[0]]
    assert getattr(cfg, field)
    assert ("scale" in params) == (flag[0] == "--sc-att")
    assert all(np.isfinite(v).all() for v in params.values())


def test_cli_and_qps_default_to_the_card(corpus, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["1", "1", "1", "5", "--data-path", corpus[0],
                  "--raw-data-path", corpus[1], "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qps.main(["--synthetic"])
    # --sharded parses and changes nothing, as JAX's flag; devices is the
    # world size (no process group: 1)
    assert qps.main(["--sharded", "--synthetic", "--device", "cpu",
                     "--batch", "8", "--iters", "1", "--train-iters", "1",
                     "--requests", "8", "--max-samples", "32"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["devices"] == 1 and line["inference_qps"] > 0


def test_qps_synthetic_on_the_cpu(capsys):
    assert qps.main(["--synthetic", "--device", "cpu", "--batch", "16",
                     "--iters", "2", "--train-iters", "1", "--requests",
                     "24", "--max-samples", "40", "--use-pallas"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for key in ("inference_qps", "serving_engine_qps",
                "train_samples_per_sec", "epoch_seconds"):
        assert line[key] > 0, key
    assert line["timer"] == "host_clock" and line["card"] is None
    assert line["data"].startswith("synthetic_task")
    assert line["route"]["use_pallas"] and "vs_baseline" not in line


def test_qps_reads_babi_files(corpus, capsys):
    assert qps.main(["--device", "cpu", "--data-path", corpus[0],
                     "--raw-data-path", corpus[1], "--batch", "8",
                     "--iters", "1", "--train-iters", "1", "--requests",
                     "8"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["data"].startswith("bAbI qa1") and line["batch"] == 8


def test_module_help_lists_every_jax_flag():
    proc = subprocess.run([sys.executable, "-m", "qmann_tpu_torch", "--help"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for action in jcli.build_parser()._actions:
        for opt in action.option_strings:
            assert opt in proc.stdout, opt
    assert "--device" in proc.stdout and "num_task_loop" in proc.stdout


# ---------------------------------------------------------------------------
# bench/sweep.py, bench/megasweep.py, bench/compare.py against the JAX tools
# ---------------------------------------------------------------------------

def _jax_parser(main):
    """The parser a JAX bench tool builds inside its main()."""
    seen = []

    def grab(self, argv=None, namespace=None):
        seen.append(self)
        raise SystemExit(0)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen[0]


@pytest.mark.parametrize("tool", ["sweep", "megasweep"])
def test_bench_tool_flags_match_jax(tool):
    import importlib
    jmod = importlib.import_module(f"qmann_tpu.bench.{tool}")
    tmod = importlib.import_module(f"qmann_tpu_torch.bench.{tool}")
    got, want = _actions(tmod.build_parser()), _actions(_jax_parser(jmod.main))
    assert set(got) == set(want) | {"device"}
    for dest, w in want.items():
        for field in ("option_strings", "default", "type", "nargs",
                      "const"):
            assert getattr(got[dest], field) == getattr(w, field), (dest,
                                                                    field)
    assert got["device"].default == "cuda"


@pytest.fixture
def one_thread():
    """The tools' CPU runs are thousands of tiny torch ops: one intra-op
    thread keeps them from contending with the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_init(monkeypatch, one_thread):
    """The port's init_params draws JAX's weights for the same seed (the
    generator's seed), so that a tool of each package trains the same
    runs."""
    import jax
    from qmann_tpu.config import QmannConfig as JaxConfig
    from qmann_tpu.models import memn2n as jmodel
    from qmann_tpu_torch.models import memn2n

    def init(cfg, dims, generator, device="cuda"):
        jcfg = JaxConfig(**{f.name: getattr(cfg, f.name)
                            for f in dataclasses.fields(JaxConfig)})
        p = jmodel.init_params(jcfg, dims,
                               jax.random.PRNGKey(generator.initial_seed()))
        return memn2n.params_from_jax({k: np.asarray(v) for k, v in
                                       p.items()}, cfg, device=device)

    monkeypatch.setattr(memn2n, "init_params", init)


SWEEP_ARGS = ["--iwl", "1", "--epochs", "1", "--max-samples", "32",
              "--max-test-samples", "16"]


def _summary(out):
    return json.loads((out / "summary.json").read_text())


def _rows_equal(got, want):
    """summary.json rows: the same keys, and every value but the host's
    wall-clock equal."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "wallclock"} == \
            {k: v for k, v in w.items() if k != "wallclock"}


def test_sweep_matches_jax_sweep(corpus, tmp_path, jax_init, capsys):
    """bench.sweep on the fixture's files, 2 tasks x 1 loop at iwl 1 (the
    JAX sweep's per-run train_task is the reference): the same summary
    rows and result CSVs per iwl; --resume adds a loop to task 1's row and
    keeps task 2's."""
    from qmann_tpu.bench import sweep as jsweep
    from qmann_tpu_torch.bench import sweep
    io = ["--data-path", corpus[0], "--raw-data-path", corpus[1]]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    one = [*SWEEP_ARGS, "--tasks", "1-2", "--loops", "1", *io]
    assert jsweep.main([*one, "--out-dir", str(jout)]) == 0
    assert sweep.main([*one, "--out-dir", str(tout), "--device", "cpu"]) == 0
    _rows_equal(_summary(tout), _summary(jout))
    assert [r[0] for r in _rows(tout / "iwl1" / "result.csv")] == ["1", "2"]
    assert sweep.main([*SWEEP_ARGS, "--tasks", "1", "--loops", "2", *io,
                       "--out-dir", str(tout), "--device", "cpu",
                       "--resume"]) == 0
    assert [len(r["errs"]) for r in _summary(tout)] == [2, 1]
    assert "sweep_mean_err_test" in capsys.readouterr().out


def test_megasweep_matches_jax_megasweep(corpus, tmp_path, jax_init,
                                         capsys):
    """bench.megasweep at its default route (the integer fast path on, no
    use_pallas; megasweep's padded layout, dim_input 114) on the fixture's
    files, 2 tasks x 2 seeds, 1 epoch: the same summary rows as the JAX
    tool, history.npz and meta.json; and bench.compare prints the JAX
    compare's table for the two directories."""
    from qmann_tpu.bench import compare as jcompare
    from qmann_tpu.bench import megasweep as jmega
    from qmann_tpu_torch.bench import compare, megasweep
    args = ["--tasks", "1-2", "--seeds", "0,1", "--iwl", "1", "--epochs",
            "1", "--max-samples", "32", "--max-test-samples", "16",
            "--eval-chunk", "16",
            "--save-best-model", "--data-path", corpus[0],
            "--raw-data-path", corpus[1]]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert jmega.main([*args, "--out-dir", str(jout)]) == 0
    assert megasweep.main([*args, "--out-dir", str(tout), "--device",
                           "cpu"]) == 0
    _rows_equal(_summary(tout), _summary(jout))
    hist = np.load(tout / "history.npz")
    want = np.load(jout / "history.npz")
    assert set(hist.files) == set(want.files)
    for k in ("iwl1_err_train", "iwl1_err_valid", "iwl1_task", "iwl1_seed"):
        np.testing.assert_array_equal(hist[k], want[k])
    meta = json.loads((tout / "meta.json").read_text())
    assert meta["stages"][0]["runs"] == 4 and meta["seeds"] == [0, 1]
    assert [r[0] for r in _rows(tout / "iwl1" / "result_all.csv")] == \
        ["1", "2"]
    capsys.readouterr()
    assert jcompare.main([str(jout), str(tout)]) == 0
    want_table = capsys.readouterr().out
    assert compare.main([str(jout), str(tout)]) == 0
    assert capsys.readouterr().out == want_table
    assert "mean (n=2 common)" in want_table


def test_bench_tools_default_to_the_card(corpus, tmp_path):
    from qmann_tpu_torch.bench import megasweep, sweep
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    for main in (sweep.main, megasweep.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--tasks", "1", "--data-path", corpus[0],
                  "--raw-data-path", corpus[1], "--out-dir",
                  str(tmp_path)])


# ---------------------------------------------------------------------------
# the serving bench tools: engine_bench, backend_ab, probe_dispatch and
# trace_forward against the JAX tools' parsers, and tiny CPU runs
# ---------------------------------------------------------------------------

# the flags each tool adds to JAX's, and the one it leaves out: JAX's
# --chain-tile sets the Pallas chain kernel's batch tile, which the CUDA
# chain takes from ops/cuda/geometry.py
DATA_FLAGS = {"data_path", "raw_data_path"}
SERVE_TOOL_EXTRAS = {
    "engine_bench": DATA_FLAGS | {"synthetic", "device", "use_pallas",
                                  "use_fused_chain"},
    "backend_ab": DATA_FLAGS | {"device", "weight_scale"},
    "probe_dispatch": DATA_FLAGS | {"synthetic", "device",
                                    "use_fused_chain"},
    "trace_forward": DATA_FLAGS | {"synthetic", "device",
                                   "use_fused_chain"},
}
SERVE_TOOL_LEFT_OUT = {"backend_ab": {"chain_tile"}}


@pytest.mark.parametrize("tool", sorted(SERVE_TOOL_EXTRAS))
def test_serve_tool_flags_match_jax(tool):
    import importlib
    jmod = importlib.import_module(f"qmann_tpu.bench.{tool}")
    tmod = importlib.import_module(f"qmann_tpu_torch.bench.{tool}")
    got, want = _actions(tmod.build_parser()), _actions(_jax_parser(jmod.main))
    left_out = SERVE_TOOL_LEFT_OUT.get(tool, set())
    assert left_out <= set(want)
    assert set(got) == (set(want) - left_out) | SERVE_TOOL_EXTRAS[tool]
    for dest, w in want.items():
        if dest in left_out:
            continue
        for field in ("option_strings", "default", "type", "nargs", "const",
                      "choices"):
            assert getattr(got[dest], field) == getattr(w, field), (dest,
                                                                    field)
    assert got["device"].default == "cuda"


def _serve_tool_argv(tool, corpus, tmp_path):
    data = ["--data-path", corpus[0], "--raw-data-path", corpus[1]]
    return {"engine_bench": ["--batch", "8", "--passes", "2", "--producers",
                             "2", "--requests", "24", "--use-fused-chain",
                             "--use-pallas", *data],
            "backend_ab": ["--batch", "16", "--scan-k", "2", "--repeats",
                           "2", "--variants", "unfused,chain,read", *data],
            "probe_dispatch": ["--batch", "16", "--iters", "2", "--scan-k",
                               "2", "--use-fused-chain", *data],
            "trace_forward": ["--iters", "1", "--top", "5",
                              "--use-fused-chain", "--out",
                              str(tmp_path / "trace"), *data]}[tool]


def test_serve_tools_default_to_the_card(corpus, tmp_path):
    import importlib
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    for tool in sorted(SERVE_TOOL_EXTRAS):
        main = importlib.import_module(f"qmann_tpu_torch.bench.{tool}").main
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(_serve_tool_argv(tool, corpus, tmp_path))


JAX_ROW_KEYS = {
    "engine_bench": [
        {"prepared", "requests", "waves", "mean_wave_fill", "sustained_qps",
         "wall_s_per_pass", "latency_ms_p50", "latency_ms_p95",
         "wave_vectorize_ms_avg", "wave_infer_ms_avg", "failed_waves"},
        {"prepared", "requests", "waves", "mean_wave_fill", "sustained_qps",
         "wall_s_per_pass", "latency_ms_p50", "latency_ms_p95",
         "wave_vectorize_ms_avg", "wave_infer_ms_avg", "failed_waves"},
        {"paired_speedup_per_pass", "paired_speedup_median",
         "prepared_infer_ms_saved_per_wave"}],
    "backend_ab": [{"variant", "qps_median", "qps_min", "qps_max",
                    "first_call_s", "outputs_identical"}] * 3
    + [{"winner", "speedup_vs_unfused"}],
    "probe_dispatch": [{"per_call_qps", "per_call_prepared_qps",
                        "prepared_speedup_x", "device_scan_qps",
                        "dispatch_overhead_x"}],
    "trace_forward": [{"total_ms", "records", "buckets", "top",
                       "hand_kernels"}],
}


@pytest.mark.parametrize("tool", sorted(SERVE_TOOL_EXTRAS))
def test_serve_tool_runs_on_the_cpu(tool, corpus, tmp_path, one_thread,
                                    capsys):
    """A tiny --device cpu run of each tool prints JAX's keys (and its
    own) on JSON lines."""
    import importlib
    main = importlib.import_module(f"qmann_tpu_torch.bench.{tool}").main
    assert main([*_serve_tool_argv(tool, corpus, tmp_path), "--device",
                 "cpu"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")]
    assert len(rows) == len(JAX_ROW_KEYS[tool])
    for row, keys in zip(rows, JAX_ROW_KEYS[tool]):
        assert keys <= set(row), keys - set(row)
    if tool == "engine_bench":
        assert rows[2]["answers_identical"]
        assert [r["prepared"] for r in rows[:2]] == [True, False]
        assert all(r["failed_waves"] == 0 and r["requests"] == 48
                   and r["card"] is None for r in rows[:2])
        assert rows[0]["route"]["use_fused_chain"]
    elif tool == "backend_ab":
        assert [r["variant"] for r in rows[:3]] == ["unfused", "chain",
                                                    "read"]
        assert all(r["qps_median"] > 0 and r["host_syncs_in_loop"] is None
                   for r in rows[:3])
    elif tool == "probe_dispatch":
        assert rows[0]["prepared_exact_route"] and rows[0]["notes"]
        assert rows[0]["per_call_qps"] > 0 and rows[0]["device_scan_qps"] > 0
    else:
        row = rows[0]
        assert row["timed"] == "cpu_op" and row["records"] > 0
        assert row["records_without_path"] == 0
        assert {"attention score", "embed (A/C dense_mat)",
                "cross-entropy/pred"} <= set(row["buckets"])
        assert abs(sum(b["ms"] for b in row["buckets"].values())
                   - row["total_ms"]) < 1e-6 * max(row["total_ms"], 1.0)
        assert all(k["launches"] == 0 for k in row["hand_kernels"].values())


@pytest.mark.parametrize("mode,variants", [
    (2, "unfused,chain,read"), (3, "unfused,hamming,read,chain")])
def test_backend_ab_variants_give_identical_predictions(mode, variants,
                                                        one_thread, capsys):
    """Every variant's predictions over the dependent batches equal the
    first's (the tool raises otherwise); then the tool's gate fails on a
    variant whose forward is perturbed."""
    from qmann_tpu_torch.bench import backend_ab
    from qmann_tpu_torch.models import memn2n
    argv = ["--attention-mode", str(mode), "--synthetic", "19,10,6,16",
            "--batch", "48", "--scan-k", "3", "--repeats", "1",
            "--variants", variants, "--weight-scale", "4", "--device", "cpu"]
    assert backend_ab.main(argv) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r.get("variant") for r in rows[:-1]] == variants.split(",")
    assert all(r["outputs_identical"] and r["distinct_predictions"] > 5
               for r in rows[:-1])

    real = memn2n.forward_prepared

    def perturbed(prep, mem, que, mask, cfg):
        out = real(prep, mem, que, mask, cfg)
        if cfg.use_pallas:
            out = out._replace(logits=out.logits.flip(-1))
        return out

    memn2n.forward_prepared = perturbed
    try:
        with pytest.raises(AssertionError, match="read diverges"):
            backend_ab.main(argv)
    finally:
        memn2n.forward_prepared = real
    with pytest.raises(SystemExit):
        backend_ab.main(["--variants", "unfused,hamming", "--device", "cpu"])


# ---------------------------------------------------------------------------
# bench/scaling.py, bench/diagnose.py and bench/scatt_study.py against the
# JAX tools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tool,extras", [
    ("scaling", {"device"}),
    ("diagnose", DATA_FLAGS | {"device"}),
    ("scatt_study", DATA_FLAGS | {"device"})])
def test_study_tool_flags_match_jax(tool, extras):
    import importlib
    jmod = importlib.import_module(f"qmann_tpu.bench.{tool}")
    tmod = importlib.import_module(f"qmann_tpu_torch.bench.{tool}")
    want = _actions(_jax_parser(jmod.main))
    got = _actions(tmod.build_parser() if hasattr(tmod, "build_parser")
                   else _jax_parser(tmod.main))
    assert set(got) == set(want) | extras
    for dest, w in want.items():
        for field in ("option_strings", "default", "type", "nargs", "const"):
            assert getattr(got[dest], field) == getattr(w, field), (dest,
                                                                    field)
    assert got["device"].default == "cuda"


def test_scaling_on_cpu_ranks(capsys):
    """--device cpu --devices 1,2: a group of one and of two gloo processes,
    one JSON line each with the JAX tool's keys, efficiency 1 at the first
    count.  Without a card the default device raises."""
    from qmann_tpu_torch.bench import scaling
    assert scaling.main(["--device", "cpu", "--devices", "1,2", "--batch",
                         "8", "--memory-rows", "4", "--dim-input", "16",
                         "--dim-emb", "8", "--iters", "2"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert {"devices", "train_samples_per_sec",
                "scaling_efficiency"} <= set(r)
        assert r["train_samples_per_sec"] > 0 and r["card"] is None
    assert rows[0]["scaling_efficiency"] == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            scaling.main(["--devices", "1"])


@pytest.fixture
def jax_paths(monkeypatch, corpus):
    """The JAX tools read the config's default dataset paths: point their
    loader at the fixture's files."""
    from qmann_tpu.data import native as jnative
    real = jnative.load_task_native

    def load(task, _path, raw_path=None, **kw):
        return real(task, corpus[0], raw_path=corpus[1], **kw)

    monkeypatch.setattr(jnative, "load_task_native", load)
    return ["--data-path", corpus[0], "--raw-data-path", corpus[1]]


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_diagnose_matches_jax_diagnose(jax_paths, jax_init, capsys):
    """2 epochs on task 1's 32 first stories from JAX's weights: the same
    records, key for key and value for value (errors, the probe's pinned
    share and largest score, each weight's max|w|, all rounded as JAX
    rounds them)."""
    from qmann_tpu.bench import diagnose as jdiagnose
    from qmann_tpu_torch.bench import diagnose
    args = ["--epochs", "2", "--max-samples", "32"]
    assert jdiagnose.main(args) == 0
    want = _json_lines(capsys.readouterr().out)
    assert diagnose.main([*args, *jax_paths, "--device", "cpu"]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert len(got) == len(want) == 2
    assert got == want


def test_scatt_study_matches_jax_scatt_study(jax_paths, jax_init, tmp_path,
                                             capsys):
    """Every mitigation for 1 epoch and 1 seed on task 1 from JAX's
    weights: summary.json's rows equal JAX's but for the wall clock; with
    --resume a second run trains nothing and keeps the rows."""
    from qmann_tpu.bench import scatt_study as jstudy
    from qmann_tpu_torch.bench import scatt_study
    args = ["--epochs", "1", "--seeds", "1"]
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert [m for m, _ in scatt_study.MITIGATIONS] == \
        [m for m, _ in jstudy.MITIGATIONS]
    assert jstudy.main([*args, "--out-dir", str(jout)]) == 0
    assert scatt_study.main([*args, *jax_paths, "--out-dir", str(tout),
                             "--device", "cpu"]) == 0
    _rows_equal(_summary(tout), _summary(jout))
    capsys.readouterr()
    assert scatt_study.main([*args, *jax_paths, "--out-dir", str(tout),
                             "--device", "cpu", "--resume"]) == 0
    assert _json_lines(capsys.readouterr().out) == []
    assert len(_summary(tout)) == len(scatt_study.MITIGATIONS)
