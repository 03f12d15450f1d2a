"""BENCHMARK.json and the harness's data files against the benchmark's
rules: names and units, the keys each entry may have, every cell's
files, metrics and readers, the bounds and the run length."""
from __future__ import annotations

import importlib.util
import json
import re

import pytest

from benchmark import common

SPEC = common.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
FILE_NAME = re.compile(r"^[A-Za-z0-9_.\-/]+$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_token|dim_emb")


def one_line(text, limit=200):
    return (isinstance(text, str) and 1 <= len(text) <= limit
            and "\n" not in text and "\t" not in text)


def test_top_level():
    assert set(SPEC) == KEYS["top"]
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = SPEC["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC[
        "run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_entries(section):
    entries = SPEC[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") \
            else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"])
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and key != "source":
                assert one_line(e[key])


def test_configs():
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert one_line(c["source"]) and c["source"].startswith("http")
        assert any(c["file"].startswith(p + "/") for p in SPEC["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        body = common.load_json(common.ROOT / c["file"])
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)


def test_workloads_and_files():
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    four = 0
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        assert NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = common.find_cell(SPEC, w["name"])
        assert importlib.util.find_spec(
            f"benchmark.jobs.{cell['traffic']['job']}") is not None
        assert cell["cell"]["limits"]
        for f in (f"traffic/{w['traffic']}.json",
                  f"workloads/{w['name']}.json"):
            assert FILE_NAME.match(f)
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = [w["name"] for w in SPEC["workloads"]]

    def reports(m, cell):
        return cell in m.get("workloads", cells)

    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert reports(e2e[m["moves"]], cell), (m["name"], cell)
        reader = common.BENCH_DIR / "metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location("reader", reader)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        assert callable(mod.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # one layer name for metrics of one layer, on one line
    for m in SPEC["per_layer"]:
        assert one_line(m["layer"])
    for cell in cells:
        got = [m for m in SPEC["end_to_end"] if reports(m, cell)]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert any(reports(m, cell) for m in SPEC["per_layer"])
