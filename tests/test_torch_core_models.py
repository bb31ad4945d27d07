"""Port parity: the config, geometry, linear algebra, motion and sensor models.

The same numpy inputs go through conan_slam_tpu (JAX, CPU) and
conan_slam_tpu_torch (PyTorch, CPU).  Elementwise float32 formulas agree to
a few ulps (the frameworks' libm differ in the last bit), hence the
tolerances below.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.core import geometry as jgeo
from conan_slam_tpu.core import linalg as jlin
from conan_slam_tpu.models import motion as jmotion
from conan_slam_tpu.models import sensor as jsensor
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.core import geometry as tgeo
from conan_slam_tpu_torch.core import linalg as tlin
from conan_slam_tpu_torch.models import motion as tmotion
from conan_slam_tpu_torch.models import sensor as tsensor

torch.set_num_threads(2)

# A few float32 ulps at unit scale: the libm of the two frameworks differ in
# the last bit of sin/cos/atan2.
ATOL = 2e-6


def test_config_matches_reference():
    assert dataclasses.asdict(SlamConfig()) == dataclasses.asdict(JSlamConfig())
    cfg, jcfg = SlamConfig(max_obs=64, dt_observe=0.03), JSlamConfig(max_obs=64, dt_observe=0.03)
    assert cfg.observe_interval == jcfg.observe_interval
    assert cfg.max_observations() == jcfg.max_observations()


def _t(a):
    return torch.as_tensor(np.array(a))


def test_wrap_angle_matches_including_the_wrap():
    rng = np.random.default_rng(0)
    a = rng.uniform(-20.0, 20.0, size=200).astype(np.float32)
    # The remainder convention decides values at and next to +/-pi.
    edge = np.float32([math.pi, -math.pi, 3 * math.pi, -3 * math.pi, 0.0,
                       np.nextafter(np.float32(math.pi), np.float32(0.0)),
                       np.nextafter(np.float32(-math.pi), np.float32(0.0))])
    a = np.concatenate([a, edge])
    got = tgeo.wrap_angle(_t(a)).numpy()
    ref = np.asarray(jgeo.wrap_angle(jnp.asarray(a)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    assert np.all(got >= -math.pi - 1e-6) and np.all(got < math.pi + 1e-6)
    # At +/-pi exactly both land on the same side.
    np.testing.assert_array_equal(np.sign(got[-7:-3]), np.sign(ref[-7:-3]))


def test_range_bearing_matches():
    rng = np.random.default_rng(1)
    pose = np.float32([12.0, -7.0, 0.3])
    pts = rng.uniform(-500, 500, size=(50, 2)).astype(np.float32)
    tr, tb = tgeo.range_bearing(_t(pose), _t(pts))
    jr, jb = jgeo.range_bearing(jnp.asarray(pose), jnp.asarray(pts))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [2, 5, 16])
def test_sym_and_safe_cholesky_match(n):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n)).astype(np.float32)
    s = (a @ a.T + n * np.eye(n)).astype(np.float32)
    s_asym = s + 1e-3 * rng.normal(size=(n, n)).astype(np.float32)
    np.testing.assert_allclose(tlin.sym(_t(s_asym)).numpy(),
                               np.asarray(jlin.sym(jnp.asarray(s_asym))), atol=1e-7)
    got = tlin.safe_cholesky(_t(s_asym)).numpy()
    ref = np.asarray(jlin.safe_cholesky(jnp.asarray(s_asym)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_safe_cholesky_degrades_to_zero_like_the_reference():
    bad = np.float32([[1.0, 2.0], [2.0, 1.0]])          # indefinite
    nan = np.full((3, 3), np.nan, np.float32)
    for m in (bad, nan):
        got = tlin.safe_cholesky(_t(m)).numpy()
        ref = np.asarray(jlin.safe_cholesky(jnp.asarray(m)))
        np.testing.assert_array_equal(got, np.zeros_like(m))
        np.testing.assert_array_equal(ref, np.zeros_like(m))


def test_chol2_matches():
    q = np.float32([[0.18, 0.01], [0.01, 0.0006]])
    np.testing.assert_allclose(tlin.chol2(_t(q)).numpy(),
                               np.asarray(jlin.chol2(jnp.asarray(q))), rtol=1e-6, atol=1e-9)


def test_motion_step_and_jacobians_match():
    rng = np.random.default_rng(2)
    poses = np.concatenate([
        rng.uniform(-3000, 3000, size=(40, 2)), rng.uniform(-math.pi, math.pi, size=(40, 1))
    ], axis=1).astype(np.float32)
    v = (83.33 + rng.normal(size=40) * 0.3).astype(np.float32)
    swa = rng.uniform(-0.7, 0.7, size=40).astype(np.float32)
    got = tmotion.step(_t(poses), _t(v), _t(swa), 73.0, 0.01).numpy()
    ref = np.asarray(jmotion.step(jnp.asarray(poses), jnp.asarray(v), jnp.asarray(swa), 73.0, 0.01))
    # Positions are ~3 km: fp32 spacing there is 2.4e-4.
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=ATOL)
    for tj, jj in zip(tmotion.jacobians(_t(poses), _t(v), _t(swa), 73.0, 0.01),
                      jmotion.jacobians(jnp.asarray(poses), jnp.asarray(v),
                                        jnp.asarray(swa), 73.0, 0.01)):
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5, atol=1e-6)


def test_motion_jacobians_are_the_derivatives_of_step():
    pose = torch.tensor([10.0, -4.0, 0.7], dtype=torch.float64)
    v, swa = torch.tensor(83.33, dtype=torch.float64), torch.tensor(0.2, dtype=torch.float64)
    gv, gu = tmotion.jacobians(pose, v, swa, 73.0, 0.01)
    jac = torch.autograd.functional.jacobian
    jv = jac(lambda p: tmotion.step(p, v, swa, 73.0, 0.01), pose)
    ju = jac(lambda u: tmotion.step(pose, u[0], u[1], 73.0, 0.01), torch.stack([v, swa]))
    torch.testing.assert_close(gv, jv)
    torch.testing.assert_close(gu, ju)


def test_sensor_observe_matches():
    rng = np.random.default_rng(3)
    pose = np.float32([150.0, -80.0, -2.9])
    xf = rng.uniform(-2000, 2000, size=(64, 2)).astype(np.float32)
    xf[0] = pose[:2]                                     # the r = 0 guard
    for tj, jj in zip(tsensor.observe(_t(pose), _t(xf)),
                      jsensor.observe(jnp.asarray(pose), jnp.asarray(xf))):
        np.testing.assert_allclose(tj.numpy(), np.asarray(jj), rtol=1e-5, atol=ATOL)
