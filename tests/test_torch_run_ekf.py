"""Port parity for the on-device simulation loop, run_ekf_slam (mirrors
the end-to-end runs of tests/test_ekf.py and tests/test_models.py): 600
steps on the default world against the JAX run_ekf_slam fed the same
draws (the reference's own, rebuilt from its key schedule), over known
and gated association and every route of ekf_frame_step; and the
port's own end-to-end checks: noise-free tracking, a capacity overflow.

Tolerances, each with its reason:
  * x_est: atol 2e-3 m, the slice's bound (tests/test_torch_slice.py):
    ~5 km positions, float32 ulps of 4.9e-4 m, rounded in two packages'
    op orders frame after frame (observed 4e-4);
  * x_true: atol 1e-4 m (the same truth chain in two libms; observed
    4e-6); the map size, the course's end and the waypoint index equal;
  * per-frame NIS: rtol 2e-2, atol 1e-3 (the slice's bound);
  * ATE: rtol 1e-2.
"""

import jax
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.runner import metrics as jmetrics
from conan_slam_tpu.runner.loop import run_ekf_slam as j_run_ekf_slam
from conan_slam_tpu.sim.world import default_world as j_default_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.runner.loop import run_ekf_slam
from conan_slam_tpu_torch.runner.metrics import ate_rmse
from conan_slam_tpu_torch.sim.world import default_world
from valet_reference import frame_draws

torch.set_num_threads(2)

N_STEPS = 600
ROUTES = {"fused": {}, "fused_obs=False": dict(fused_obs=False),
          "fast_frame=False": dict(fast_frame=False),
          "switch_batch_update=False": dict(switch_batch_update=False)}


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("known", [True, False], ids=["known", "gated"])
def test_run_ekf_slam_matches_reference(known, route):
    kw = dict(switch_association_known=known, **ROUTES[route])
    jworld, jcfg, cfg = j_default_world(), JSlamConfig(**kw), SlamConfig(**kw)
    key = jax.random.PRNGKey(42)
    jcarry, jouts = j_run_ekf_slam(jworld, jcfg, key, n_steps=N_STEPS)
    ctrl, obs = frame_draws(key, N_STEPS // cfg.observe_interval, cfg.observe_interval,
                            jworld.num_landmarks)
    world = default_world(device="cpu")
    carry, outs = run_ekf_slam(world, cfg, None, N_STEPS, ctrl_noise=torch.as_tensor(ctrl),
                               obs_noise=torch.as_tensor(obs))
    np.testing.assert_allclose(outs.x_true.numpy(), np.asarray(jouts.x_true), rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs.x_est.numpy(), np.asarray(jouts.x_est), rtol=0, atol=2e-3)
    np.testing.assert_array_equal(outs.n_active.numpy(), np.asarray(jouts.n_active))
    np.testing.assert_array_equal(outs.done.numpy(), np.asarray(jouts.done))
    np.testing.assert_allclose(outs.consistency.numpy(), np.asarray(jouts.consistency),
                               rtol=2e-2, atol=1e-3)
    assert int(carry.steer.iwp) == int(jcarry.steer.iwp)
    assert int(carry.state.n_active) == int(jcarry.state.n_active) > 0
    np.testing.assert_array_equal(carry.state.table.numpy(), np.asarray(jcarry.state.table))
    ate = float(ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    jate = float(jmetrics.ate_rmse(jouts.x_true, jouts.x_est, ~jouts.done))
    np.testing.assert_allclose(ate, jate, rtol=1e-2)


@pytest.mark.parametrize("known", [True, False], ids=["known", "gated"])
def test_noise_free_run_tracks_truth(known):
    # The reference's implicit oracle (tests/test_ekf.py:343-376): perfect
    # odometry and measurements, and the filter tracks the truth.
    cfg = SlamConfig(switch_control_noise=False, switch_sensor_noise=False,
                     switch_inflate_noise=False, switch_association_known=known)
    carry, outs = run_ekf_slam(default_world(device="cpu"), cfg,
                               torch.Generator().manual_seed(0), 3000)
    assert float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)) < 0.1
    assert int(carry.state.n_active) > 0


def test_capacity_overflow_runs_to_the_end():
    # Eight slots for thirty landmarks: the map fills, every later new
    # landmark is dropped, and the run goes on to its last step.
    cfg = SlamConfig(max_landmarks=8)
    carry, outs = run_ekf_slam(default_world(device="cpu"), cfg,
                               torch.Generator().manual_seed(1), 2400)
    state = carry.state
    assert outs.x_est.shape == (2400, 3) and bool(torch.isfinite(outs.x_est).all())
    assert bool(torch.isfinite(state.p).all())
    assert int(state.n_active) == 8 and int(outs.n_active.max()) == 8
    mapped = state.table[state.table >= 0]
    assert torch.equal(mapped.sort().values, torch.arange(8))
    assert float(ate_rmse(outs.x_true, outs.x_est, ~outs.done)) < 1.0
