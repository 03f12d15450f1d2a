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
def test_unported_flags_raise_before_reading_data(tmp_path, request, flag):
    """--mesh raises before any data is read (no data exists at the paths
    given).  The feature flags are ported: each runs task 1 on 32 stories
    of the files the fixture writes (--linear-start: 1 epoch after the 5
    linear-start ones), writes its result row and a checkpoint whose config
    carries the flag."""
    if flag[0] == "--mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cli.main(["1", "1", "1", "5", *flag, "--device", "cpu",
                      "--data-path", str(tmp_path / "none"),
                      "--raw-data-path", str(tmp_path / "none"),
                      "--out-dir", str(tmp_path)])
        assert os.listdir(tmp_path) == []
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


def test_cli_and_qps_default_to_the_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["1", "1", "1", "5", "--data-path", corpus[0],
                  "--raw-data-path", corpus[1], "--out-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qps.main(["--synthetic"])
    with pytest.raises(NotImplementedError, match="mesh"):
        qps.main(["--sharded", "--device", "cpu"])


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
