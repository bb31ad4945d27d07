"""Everything a cell needs is found by name in files of its own, and
BENCHMARK.json keeps to the benchmark's contract."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    """A cell's traffic file names its configuration, which is a
    configuration of BENCHMARK.json with its own file."""
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    traffic = harness.load("traffic", w["traffic"])
    assert traffic["config"] == w["config"] and traffic["chips"] == w["chips"]
    cfg = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert cfg["file"] == f"portbench/configs/{w['config']}.json"
    config = harness.load("configs", w["config"])
    assert config["reduced"] == cfg["reduced"] and config["source"] == cfg["source"]
    assert set(traffic["limits"]) | set(config["limits"]) >= {"cov_gap", "pose_gap_m",
                                                              "map_mismatch"}


def test_configs():
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and NAME.match(c["name"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_metrics_found_by_name():
    """Each end-to-end metric has its reader in e2e/, each per-layer metric
    its reader in metrics/, with the unit BENCHMARK.json states."""
    e2e, layer = harness.readers("e2e"), harness.readers("metrics")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["name"] in e2e and e2e[m["name"]].UNIT == m["unit"]
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert "setup_s" in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e_names = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["name"] in layer and layer[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e_names and set(m["workloads"]) <= cells
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_kernel_names():
    names = harness.port_kernels()
    assert "frame_step_kernel" in names and "obs_pass_kernel" in names
    for path in (ROOT / "portbench" / "kernels").glob("*.json"):
        assert json.loads(path.read_text())["kernels"]
