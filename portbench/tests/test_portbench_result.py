"""A whole run on the CPU at a tiny size (the card's check skipped, the
port's plain versions in place of its kernels): the result line's keys."""

import json

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("config", ["ekf_known", "ekf_gated"])
def test_result_line(config):
    """The gated path's float32 covariance is judged by no limit of its own
    yet (PERF.md, Open questions): here it shows the keys only."""
    res = harness.run("tiny", 2**31 + 11, 0.5, False, device=torch.device("cpu"),
                      traffic=tiny(config), cache_dir=None)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    if config == "ekf_known":
        assert res["correct"] is True
    assert set(res["metrics"]) == {"steps_per_s", "request_ms_p95", "peak_mem_gib", "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["checks"]) == {"cov_gap", "pose_gap_m", "map_mismatch"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_traced_line():
    res = harness.run("tiny", 5, 3.0, True, device=torch.device("cpu"),
                      traffic=tiny("ekf_known"), cache_dir=None)
    assert res["correct"] is True
    assert {"busy_s", "window_s"} <= set(res["device"]) and res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"]["ops_per_frame"]["value"] > 0
    assert list(res)[-1] == "checks"


CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_card(cell):
    """Each cell, a short window on the card: correct, on the card it names."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    res = harness.run(cell, 2**31 + 101, 1.0, False)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
