"""Port parity for the whole slice: the precomputed-rollout EKF driver
(full map, known association, augment off; one frame or a frame pair per P
pass) against the JAX reference, on
one shared truth rollout and fed the reference's own noise draws; and the
port's independence from JAX and the JAX package.

Tolerances, each with its reason:
  * pose trace and final pose: atol 2e-3 m.  Positions reach ~5 km, where
    the float32 spacing is 4.9e-4 m; the two packages round every frame
    differently (XLA vs PyTorch op order and libm) and the filter carries
    that over 100 frames as a few ulps (observed 5e-4).
  * final state mean: atol 2e-2 m.  The same ulp drift on ~5 km map means,
    which only the state's covariance pulls back (observed 5e-3).
  * P: atol 1e-4 on unit-scale variances (observed 2e-5).
  * per-frame NIS: rtol 2e-2, atol 1e-3.  NIS is v^T S^-1 v of innovations
    that are differences of km-scale predictions; their float32 rounding
    is ~1e-3 relative of a 0.1 m innovation (observed 4e-3 relative).
  * ATE: rtol 1e-2.
"""

import functools
import importlib
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.filters.ekf import init_state_with_map as j_init_state_with_map
from conan_slam_tpu.runner import metrics as jmetrics
from conan_slam_tpu.runner.loop import run_ekf_slam_precomputed as j_run
from conan_slam_tpu.sim import precompute as jprecompute
from conan_slam_tpu.sim.world import World as JWorld, default_world as j_default_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.ops import frame_kernel as tfk
from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
from conan_slam_tpu_torch.runner.metrics import ate_rmse
from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y, world_from_numpy

torch.set_num_threads(2)

# The module (filters.ekf exports the function ``update`` under its name).
ekf_update = importlib.import_module("conan_slam_tpu_torch.filters.ekf.update")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_world(n_landmarks, seed):
    if n_landmarks is None:
        return j_default_world()
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-5000, 5000, size=(n_landmarks, 2)).astype(np.float32)
    wp = np.stack([_WP_X, _WP_Y], axis=1).astype(np.float32)
    return JWorld(landmarks=jnp.asarray(lm), waypoints=jnp.asarray(wp))


@pytest.mark.parametrize("n_landmarks,n_steps,seed,dim,frame_pair", [
    (None, 600, 3, 63, False),    # the reference's 30-landmark valet world, D unpadded
    (200, 300, 5, 512, False),    # 200 landmarks: D = 403 padded to 512 (pad_multiple=256)
    # The frame pair (one P pass per two frames) against the reference's
    # driver with frame_pair=True, which pairs nothing on the CPU: the
    # pair's algebra is that of two frames.
    (None, 1200, 3, 63, True),
    (200, 300, 5, 512, True),
])
def test_slice_matches_reference(n_landmarks, n_steps, seed, dim, frame_pair):
    jworld = _jax_world(n_landmarks, seed)
    n_lm = jworld.num_landmarks
    kw = dict(max_landmarks=n_lm, max_obs=16, enable_augment=False, frame_pair=frame_pair)
    cfg, jcfg = SlamConfig(**kw), JSlamConfig(**kw)
    world = world_from_numpy(np.asarray(jworld.landmarks), np.asarray(jworld.waypoints), "cpu")
    # Both packages run the port's numpy rollout (the reference would take
    # its native C++ one, equal to a few ulps; see the rollout test below).
    roll = precompute_rollout(world, cfg, n_steps)
    jroll = tuple(tuple(jnp.asarray(a.numpy()) for a in part) for part in roll)
    key = jax.random.PRNGKey(seed)
    jstate, jouts = j_run(jworld, jcfg, key, n_steps=n_steps, precomputed=jroll,
                          init_state=j_init_state_with_map(jworld.landmarks, sigma0=1.0))
    assert jstate.x.shape[0] == dim

    # The reference draws its noise inside _run_precomp (runner/loop.py:292-294).
    interval = cfg.observe_interval
    n_frames = n_steps // interval
    nz = min(n_lm, cfg.max_obs)
    k_ctrl, k_obs = jax.random.split(key)
    ctrl_noise = np.array(jax.random.normal(k_ctrl, (n_frames, interval, 2), jnp.float32))
    obs_noise = np.array(jax.random.normal(k_obs, (n_frames, nz, 2), jnp.float32))

    state, outs = run_ekf_slam_precomputed(
        world, cfg, None, n_steps, init_state_with_map(world.landmarks, sigma0=1.0), roll,
        ctrl_noise=torch.as_tensor(ctrl_noise), obs_noise=torch.as_tensor(obs_noise),
    )
    assert state.x.shape[0] == dim
    np.testing.assert_allclose(outs.x_true.numpy(), np.asarray(jouts.x_true), atol=0)
    np.testing.assert_allclose(outs.x_est.numpy(), np.asarray(jouts.x_est), rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.x.numpy()[:3], np.asarray(jstate.x)[:3], rtol=0, atol=2e-3)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=0, atol=2e-2)
    np.testing.assert_allclose(state.p.numpy(), np.asarray(jstate.p), rtol=0, atol=1e-4)
    np.testing.assert_allclose(outs.consistency.numpy(), np.asarray(jouts.consistency),
                               rtol=2e-2, atol=1e-3)
    np.testing.assert_array_equal(outs.n_active.numpy(), np.asarray(jouts.n_active))
    ate = float(ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    jate = float(jmetrics.ate_rmse(jouts.x_true, jouts.x_est, ~jouts.done))
    np.testing.assert_allclose(ate, jate, rtol=1e-2)


def test_slice_schedules_agree(monkeypatch):
    # The same frames through the resident route (H9's plain version, the
    # default) and the split schedule's plain versions: one algebra, fp32
    # rounding apart (the closed form against the p2 row vs G^T M G), held
    # at this file's tolerances.  The split is chosen through frame_step's
    # own test hook, bound where fused_frame_step looks it up.
    jworld = _jax_world(200, 5)
    cfg = SlamConfig(max_landmarks=200, max_obs=16, enable_augment=False)
    world = world_from_numpy(np.asarray(jworld.landmarks), np.asarray(jworld.waypoints), "cpu")
    roll = precompute_rollout(world, cfg, 300)
    rng = np.random.default_rng(5)
    noise = dict(ctrl_noise=torch.as_tensor(rng.normal(size=(50, 6, 2)).astype(np.float32)),
                 obs_noise=torch.as_tensor(rng.normal(size=(50, 16, 2)).astype(np.float32)))
    state0 = init_state_with_map(world.landmarks, sigma0=1.0)
    s_res, o_res = run_ekf_slam_precomputed(world, cfg, None, 300, state0, roll, **noise)
    monkeypatch.setattr(ekf_update, "frame_step",
                        functools.partial(tfk.frame_step, schedule="split"))
    s_split, o_split = run_ekf_slam_precomputed(world, cfg, None, 300, state0, roll, **noise)
    np.testing.assert_allclose(o_res.x_est.numpy(), o_split.x_est.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(s_res.x.numpy(), s_split.x.numpy(), rtol=0, atol=2e-2)
    np.testing.assert_allclose(s_res.p.numpy(), s_split.p.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(o_res.consistency.numpy(), o_split.consistency.numpy(),
                               rtol=2e-2, atol=1e-3)


def test_state_carries_across_from_the_reference():
    # init_state_with_map pads D exactly as the reference (pad_multiple
    # 256), and a reference state crosses into the port and back unchanged.
    from conan_slam_tpu_torch.filters.ekf import state_from_numpy, state_to_numpy

    lm = np.random.default_rng(9).uniform(-500, 500, size=(200, 2)).astype(np.float32)
    jstate = j_init_state_with_map(jnp.asarray(lm), sigma0=0.7)
    state = init_state_with_map(torch.as_tensor(lm), sigma0=0.7, device="cpu")
    jarrays = [np.asarray(a) for a in jstate]
    for got, ref in zip(state_to_numpy(state), jarrays):
        np.testing.assert_array_equal(got, ref)
    for got, ref in zip(state_to_numpy(state_from_numpy(*jarrays, device="cpu")), jarrays):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_rollout_matches_reference():
    # The port's rollout is the reference's numpy path, bit for bit; the
    # reference's default native rollout agrees to float32 ulps (its own
    # tests/test_sim.py bound).
    jworld = _jax_world(200, 5)
    cfg = SlamConfig(max_landmarks=200, max_obs=16)
    jcfg = JSlamConfig(max_landmarks=200, max_obs=16)
    world = world_from_numpy(np.asarray(jworld.landmarks), np.asarray(jworld.waypoints), "cpu")
    (x_true, swa, active, done), (z, ids, mask) = precompute_rollout(world, cfg, 1200)
    wp, lm = np.asarray(jworld.waypoints), np.asarray(jworld.landmarks)
    for native in (False, True):
        jt = jprecompute.rollout_truth(wp, jcfg, 1200, use_native=native)
        jo = jprecompute.rollout_observations(jt.x_true, lm, jcfg.max_range, 16, 6,
                                              use_native=native)
        atol = 1e-3 if native else 0.0     # ~4 ulps of the ~5 km positions
        np.testing.assert_allclose(x_true.numpy(), jt.x_true, rtol=0, atol=atol)
        np.testing.assert_allclose(swa.numpy(), jt.swa, rtol=0, atol=atol)
        np.testing.assert_array_equal(active.numpy(), jt.active)
        np.testing.assert_array_equal(done.numpy(), jt.done)
        np.testing.assert_array_equal(ids.numpy(), jo.ids)
        np.testing.assert_array_equal(mask.numpy(), jo.mask)
        np.testing.assert_allclose(z.numpy(), jo.z_true, rtol=0, atol=atol)


def test_port_runs_without_jax():
    # Every module of the port imports, and a known-association frame, a
    # frame pair, a chunked run that checkpoints, a few gated frames, the
    # on-device loop on each route and the example run on the CPU, in a
    # process where importing jax or the JAX package fails.
    code = textwrap.dedent("""
        import importlib, os, pkgutil, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["conan_slam_tpu"] = None
        import torch
        import conan_slam_tpu_torch
        for m in pkgutil.walk_packages(conan_slam_tpu_torch.__path__, "conan_slam_tpu_torch."):
            importlib.import_module(m.name)
        from conan_slam_tpu_torch.config import SlamConfig
        from conan_slam_tpu_torch.filters.ekf import init_state_with_map
        from conan_slam_tpu_torch.runner.loop import (
            run_ekf_slam_precomputed, run_ekf_slam_precomputed_chunked)
        from conan_slam_tpu_torch.sim.world import default_world
        world = default_world(device="cpu")
        state0 = init_state_with_map(world.landmarks)
        gen = torch.Generator().manual_seed(0)
        for pair, n in ((False, 6), (True, 12)):
            cfg = SlamConfig(max_landmarks=30, max_obs=16, enable_augment=False, frame_pair=pair)
            state, outs = run_ekf_slam_precomputed(world, cfg, gen, n, state0)
            assert torch.isfinite(state.p).all() and outs.x_est.shape == (n, 3)
        with tempfile.TemporaryDirectory() as d:
            state, outs = run_ekf_slam_precomputed_chunked(world, cfg, 0, 36, 24, state0,
                                                           checkpoint_dir=d)
            assert outs.x_est.shape == (36, 3) and len(os.listdir(d)) == 4
        # A few gated frames from an empty map, with augmentation, on the
        # 30-landmark world and on BASELINE config 2's committed world.
        from conan_slam_tpu_torch.sim.world import config2_world
        for w, k, nz in ((world, 30, 16), (config2_world(device="cpu"), 500, 64)):
            cfg = SlamConfig(max_landmarks=k, max_obs=nz, switch_association_known=False)
            state, outs = run_ekf_slam_precomputed(w, cfg, gen, 36)
            assert torch.isfinite(state.p).all() and int(state.n_active) > 0
            assert outs.n_active.shape == (36,)
        # The on-device simulation loop, every route of its frame, and the example.
        from conan_slam_tpu_torch.runner.loop import run_ekf_slam
        for kw in ({}, dict(fused_obs=False), dict(fast_frame=False),
                   dict(switch_batch_update=False)):
            for known in (True, False):
                cfg = SlamConfig(switch_association_known=known, **kw)
                carry, outs = run_ekf_slam(world, cfg, gen, 24)
                assert outs.x_est.shape == (24, 3) and torch.isfinite(outs.x_est).all()
        from conan_slam_tpu_torch.examples import valet_loop
        assert valet_loop.main(["--steps", "12", "--device", "cpu"])["done_at"] == 12
        assert not any(k.split(".")[0] in ("jax", "conan_slam_tpu")
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
