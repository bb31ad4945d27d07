"""The command line, and the refusals that print no result."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.run import parse

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("argv, want", [
    (["--workload", "known.lm10k", "--seed", "4294967311", "--seconds", "10", "--trace", "1"],
     ("known.lm10k", 4294967311, 10.0, 1)),
    (["--workload", "known.lm4096", "--seed", "0", "--seconds", "2.5"],
     ("known.lm4096", 0, 2.5, 0)),
])
def test_parse(argv, want):
    a = parse(argv)
    assert (a.workload, a.seed, a.seconds, a.trace) == want


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "10"],
    ["--workload", "known.lm10k", "--seed", "x", "--seconds", "10"],
    ["--workload", "known.lm10k", "--seed", "1", "--seconds", "0"],
    ["--workload", "known.lm10k", "--seed", "1", "--seconds", "10", "--trace", "2"],
])
def test_parse_refuses(argv):
    with pytest.raises(SystemExit) as e:
        parse(argv)
    assert e.value.code != 0


def test_unknown_cell_refused():
    with pytest.raises(SystemExit) as e:
        harness.load("traffic", "no.such.cell")
    assert e.value.code != 0


def _run(cwd, env_extra=None):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env_extra or {})}
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "known.lm10k",
                           "--seed", "7", "--seconds", "1"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    """Without a card the run exits non-zero and prints no result."""
    res = _run(ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "CUDA device" in res.stderr


def test_alone_no_result(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, the run exits non-zero and prints no result."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _run(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_alone_program_missing(tmp_path):
    """Past the card's check, a checkout without the program under test
    still refuses."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch; sys.path.insert(0, '.'); from portbench import harness; "
            "harness.run('known.lm10k', 1, 1.0, False, device=torch.device('cpu'), cache_dir=None)")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "program under test" in res.stderr
