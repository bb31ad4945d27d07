"""The frozen generators give what the program's own give, bit for bit."""

import numpy as np
import pytest

from conan_slam_tpu_torch.benchmarks import world as port_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.sim import precompute
from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y
from portbench import harness
from portbench.gen import rollout, world


def _vehicle(cfg: SlamConfig) -> dict:
    return {k: getattr(cfg, k) for k in ("velocity", "wheel_base", "dt_controls", "rate_swa",
                                         "max_swa", "at_waypoint", "number_loops")}


def test_waypoints():
    assert np.array_equal(world.WAYPOINTS, np.stack([_WP_X, _WP_Y], 1).astype(np.float32))


@pytest.mark.parametrize("n, seed, extent", [(300, 42, 6500.0), (300, 53, 5000.0)])
def test_landmarks(n, seed, extent):
    ours = world.landmarks(n, seed, extent)
    if seed == port_world.SEED:
        theirs = port_world.bench_world(n, "cpu")[0]
    else:
        theirs = port_world.gated_world(n, "cpu").landmarks.numpy()
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("loops, steps", [(1, 2_400), (2, 21_000)])
def test_truth(loops, steps):
    cfg = SlamConfig(number_loops=loops)
    ours = rollout.rollout_truth(world.WAYPOINTS, _vehicle(cfg), steps)
    theirs = precompute.rollout_truth(world.WAYPOINTS, cfg, steps)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n_lm, nz", [(500, 64), (40, 40)])
def test_returns(n_lm, nz):
    cfg = SlamConfig(number_loops=2)
    x_true = precompute.rollout_truth(world.WAYPOINTS, cfg, 3_000 * 6).x_true
    lm = world.landmarks(n_lm, 42, 6500.0)
    ours = rollout.rollout_returns(x_true, lm, cfg.max_range, nz, cfg.observe_interval)
    theirs = precompute.rollout_observations(x_true, lm, cfg.max_range, nz, cfg.observe_interval)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rollout_cache(tmp_path):
    """A cached rollout is the rollout."""
    cell = {"world": {"landmarks": 50, "seed": 42, "extent": 3000.0}, "rollout_frames": 40}
    config = harness.load("configs", "ekf_known")
    lm = world.landmarks(50, 42, 3000.0)
    made = harness.rollout(config, cell, lm, tmp_path)
    assert len(list(tmp_path.glob("*.npz"))) == 1
    again = harness.rollout(config, cell, lm, tmp_path)
    for a, b in zip((*made[0], *made[1]), (*again[0], *again[1])):
        assert np.array_equal(a, b)
