"""Port parity for the simulation chain (mirrors tests/test_sim.py): the
compaction, the sensor, the noise, the steering and truth chain, the
random world, the on-device loop against the precomputed driver, and the
committed reference arrays of the seed-42 valet run.

The same numpy inputs go through conan_slam_tpu (JAX, CPU) and
conan_slam_tpu_torch (PyTorch, CPU).  Tolerances, each with its reason:
  * compaction: ids, mask and buffer bit for bit (a gather and a scatter,
    no arithmetic).
  * sensor returns: range rtol 1e-6 (float32 sqrt of the same squares),
    bearing atol 2e-6 rad (atan2 of two libms, ~4 ulps at pi); visibility
    equal (no landmark of these draws lies within an ulp of a boundary).
  * noise: rtol 1e-6, atol 1e-6 (one multiply-add, which XLA may contract
    to an FMA).
  * truth chain over 3,000 steps: positions atol 1e-3 m, ~2 ulps of the
    ~5 km coordinates, which two libms' sin/cos/atan2 reach as the chain
    compounds (observed 4e-6); steering and odometry atol 1e-4 rad: a few
    metres before a waypoint one ulp of the ~1 km coordinates (6e-5 m)
    turns the bearing to it by ~1.5e-5 rad (observed once, 1.5e-5); the
    waypoint index, loops left and done flag equal at every step.
  * on-device loop against the precomputed driver, noise free: 0.05 m, the
    reference's own bound (tests/test_sim.py:71-95).
  * the committed arrays: the draws bit for bit; x_est of the JAX run's
    first 3,000 steps within 1e-6 m (the same program on the same CPU);
    config 2's kept draws cover every return the port's rollout sees.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.filters.common import compact as j_compact
from conan_slam_tpu.runner.loop import _advance_truth as j_advance_truth
from conan_slam_tpu.runner.loop import run_ekf_slam as j_run_ekf_slam
from conan_slam_tpu.sim import sensor_sim as jsensor_sim
from conan_slam_tpu.sim.steering import init_steer_state as j_init_steer_state
from conan_slam_tpu.sim.world import default_world as j_default_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.common import compact
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.runner.metrics import ate_rmse
from conan_slam_tpu_torch.sim import sensor_sim
from conan_slam_tpu_torch.sim.steering import init_steer_state
from conan_slam_tpu_torch.sim.world import config2_world, default_world, random_world
from valet_reference import CONFIG2_DATA, DATA, frame_draws

torch.set_num_threads(2)


@pytest.mark.parametrize("n,size,p_visible", [
    (30, 30, 0.5), (40, 8, 0.6), (30, 30, 0.0), (30, 16, 1.0), (500, 64, 0.1),
], ids=["valet", "overflow", "none", "all-overflow", "config2"])
def test_compact_matches_reference(n, size, p_visible):
    rng = np.random.default_rng(n + size)
    z = rng.normal(size=(n, 2)).astype(np.float32)
    vis = rng.random(n) < p_visible
    ref = j_compact(jsensor_sim.Observation(z=jnp.asarray(z), visible=jnp.asarray(vis)), size)
    got = compact(sensor_sim.Observation(z=torch.as_tensor(z), visible=torch.as_tensor(vis)), size)
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(ref.ids))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.z.numpy(), np.asarray(ref.z))
    assert int(got.mask.sum()) == min(int(vis.sum()), size)


def test_get_observations_and_noise_match_reference():
    jworld = j_default_world()
    lm = np.array(jworld.landmarks)
    rng = np.random.default_rng(8)
    key = jax.random.PRNGKey(8)
    for _ in range(20):
        pose = np.array([*rng.uniform(-4000, 4000, 2), rng.uniform(-np.pi, np.pi)], np.float32)
        ref = jsensor_sim.get_observations(jnp.asarray(pose), jworld.landmarks, 2000.0)
        got = sensor_sim.get_observations(torch.as_tensor(pose), torch.as_tensor(lm), 2000.0)
        np.testing.assert_array_equal(got.visible.numpy(), np.asarray(ref.visible))
        np.testing.assert_allclose(got.z.numpy()[:, 0], np.asarray(ref.z)[:, 0], rtol=1e-6)
        np.testing.assert_allclose(got.z.numpy()[:, 1], np.asarray(ref.z)[:, 1], atol=2e-6)
        # The noise from the reference's own draws of its key.
        key, k_obs, k_ctrl = jax.random.split(key, 3)
        draws = np.array(jax.random.normal(k_obs, (lm.shape[0], 2), jnp.float32))
        rn = jsensor_sim.add_observation_noise(k_obs, ref, 0.1, 0.02, True)
        gn = sensor_sim.add_observation_noise(torch.as_tensor(draws), got._replace(
            z=torch.as_tensor(np.array(ref.z))), 0.1, 0.02, True)
        np.testing.assert_allclose(gn.z.numpy(), np.asarray(rn.z), rtol=1e-6, atol=1e-6)
        cdraw = np.array(jax.random.normal(k_ctrl, (2,), jnp.float32))
        rv, rs = jsensor_sim.add_control_noise(k_ctrl, 83.33, jnp.float32(0.1), 0.3, 0.017, True)
        gv, gs = sensor_sim.add_control_noise(torch.as_tensor(cdraw), 83.33, torch.tensor(0.1),
                                              0.3, 0.017, True)
        np.testing.assert_allclose([float(gv), float(gs)], [float(rv), float(rs)], rtol=1e-6)
    off = sensor_sim.add_control_noise(torch.zeros(2), 83.33, torch.tensor(0.1), 0.3, 0.017, False)
    assert float(off[0]) == pytest.approx(83.33) and float(off[1]) == pytest.approx(0.1)


def test_truth_chain_matches_reference():
    # 3,000 steps of steering, truth motion and noisy odometry (the first
    # waypoint switch falls in them), with the same draws: the reference's
    # chain runs with its noise switch off, and each draw is applied as its
    # add_control_noise applies it.
    n = 3000
    jworld, jcfg = j_default_world(), JSlamConfig()
    draws = np.array(jax.random.normal(jax.random.PRNGKey(5), (n, 2), jnp.float32))
    cfg_off = jcfg.replace(switch_control_noise=False)

    def step(carry, d):
        st, x = carry
        st, x, vn, swan = j_advance_truth(st, x, jworld, cfg_off, None)
        vn, swan = vn + d[0] * jcfg.sigma_v, swan + d[1] * jcfg.sigma_swa
        return (st, x), (x, st.swa, st.iwp, st.loops_left, st.done, vn, swan)

    _, ref = jax.lax.scan(step, (j_init_steer_state(1), jnp.zeros(3, jnp.float32)),
                          jnp.asarray(draws))
    ref = [np.asarray(a) for a in ref]

    world, cfg = default_world(device="cpu"), SlamConfig()
    st, x = init_steer_state(1, device="cpu"), torch.zeros(3)
    got = []
    for k in range(n):
        st, x, vn, swan = loop._advance_truth(st, x, world, cfg, torch.as_tensor(draws[k]))
        got.append((x, st.swa, st.iwp, st.loops_left, st.done, vn, swan))
    got = [torch.stack(a).numpy() for a in zip(*got)]
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    for a, b in zip(got[2:5], ref[2:5]):
        np.testing.assert_array_equal(a, b)
    assert ref[2].max() >= 1                       # a waypoint switch is held
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-6)
    np.testing.assert_allclose(got[6], ref[6], rtol=0, atol=1e-4)


def test_random_world_is_deterministic():
    a = random_world(torch.Generator().manual_seed(3), 50, device="cpu")
    b = random_world(torch.Generator().manual_seed(3), 50, device="cpu")
    c = random_world(torch.Generator().manual_seed(4), 50, device="cpu")
    assert torch.equal(a.landmarks, b.landmarks) and torch.equal(a.waypoints, b.waypoints)
    assert not torch.equal(a.landmarks, c.landmarks)
    assert a.landmarks.shape == (50, 2) and a.waypoints.shape == (5, 2)
    assert a.landmarks.dtype == torch.float32
    assert bool((a.landmarks.abs() <= 5000.0).all()) and bool((a.waypoints.abs() <= 5000.0).all())
    assert torch.equal(a.waypoints[0], torch.zeros(2))


def test_on_device_loop_matches_precomputed_noise_free():
    # With every noise off, the on-device loop and the precomputed rollout
    # integrate the same filter (the reference's test_sim.py:71-95).
    world = default_world(device="cpu")
    cfg = SlamConfig(switch_control_noise=False, switch_sensor_noise=False,
                     switch_inflate_noise=False)
    gen = torch.Generator().manual_seed(0)
    _, a = loop.run_ekf_slam(world, cfg, gen, 3000)
    _, b = loop.run_ekf_slam_precomputed(world, cfg, gen, 3000)
    valid = ~a.done
    err = (a.x_est[valid, :2] - b.x_est[valid, :2]).abs().max()
    assert float(err) < 0.05, float(err)
    assert float(ate_rmse(b.x_true, b.x_est, ~b.done)) < 0.1


def test_reference_arrays_hold_the_reference_run():
    # valet_seed42.npz against the JAX package: the draws rebuilt from the
    # key schedule bit for bit, and 3,000 steps of its run_ekf_slam (known
    # and gated) on those draws.
    data = np.load(DATA)
    jworld, jcfg = j_default_world(), JSlamConfig()
    key = jax.random.PRNGKey(42)
    ctrl, obs = frame_draws(key, 500, jcfg.observe_interval, jworld.num_landmarks)
    np.testing.assert_array_equal(ctrl, data["ctrl"][:500])
    np.testing.assert_array_equal(obs, data["obs"][:500])
    assert data["ctrl"].shape == (4167, 6, 2) and data["obs"].shape == (4167, 30, 2)
    for name, known in (("known", True), ("gated", False)):
        _, outs = j_run_ekf_slam(jworld, jcfg.replace(switch_association_known=known), key,
                                 n_steps=3000)
        np.testing.assert_allclose(np.asarray(outs.x_est), data[f"x_est_{name}"][:3000],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(np.asarray(outs.n_active), data[f"n_active_{name}"][:3000])
        np.testing.assert_array_equal(np.asarray(outs.done), data[f"done_{name}"][:3000])
        if known:
            np.testing.assert_allclose(np.asarray(outs.x_true), data["x_true"][:3000],
                                       rtol=0, atol=1e-6)
    # The whole run's fixed points: done at step 19,555 with 25 mapped.
    for name in ("known", "gated"):
        assert int(data[f"done_{name}"].argmax()) == 19_555
        assert int(data[f"n_active_{name}"][-1]) == 25


def test_config2_arrays_hold_the_reference_draws():
    # config2_key0.npz: the control draws and the kept returns' draws bit
    # for bit those of PRNGKey(0)'s key schedule (the first 400 frames),
    # and every landmark the port's rollout sees in a frame is among that
    # frame's kept ids, so the run rebuilt from them gets every draw the
    # filter reads.
    data = np.load(CONFIG2_DATA)
    ctrl, obs = frame_draws(jax.random.PRNGKey(0), 400, 6, 500)
    np.testing.assert_array_equal(ctrl, data["ctrl"][:400])
    ids, vals = data["obs_ids"].astype(np.int64), data["obs_vals"]
    for f in range(400):
        kept = ids[f] >= 0
        np.testing.assert_array_equal(vals[f, kept], obs[f, ids[f, kept]])
        assert not vals[f, ~kept].any()
    world = config2_world(device="cpu")
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    _, (_, roll_ids, roll_mask) = loop.precompute_rollout(world, cfg, 25_000)
    assert roll_mask.shape == (4167, 64) and ids.shape[0] == 4167
    for f in range(4167):
        seen = roll_ids[f][roll_mask[f]].numpy()
        assert np.isin(seen, ids[f]).all(), f
    assert int(data["mapped"]) == 304 and abs(float(data["ate"]) - 0.18524) < 1e-5
