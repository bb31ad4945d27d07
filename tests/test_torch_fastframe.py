"""Port parity: the rank-compounded frame (filters.ekf.fastframe).

The same numpy state and controls go through the JAX reference and the
port.  Both run the same float32 recursion op for op, so at a
well-conditioned heading noise they agree to a few ulps; at the
reference's realistic heading sigma the recursion amplifies float32
cancellation in any order (see tests/test_fastframe.py), so there the port
is held to the same float64 oracle as the reference, with the same factor.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.filters.ekf import fastframe as jff
from conan_slam_tpu_torch.filters.ekf import fastframe as tff
from conan_slam_tpu_torch.filters.ekf.state import state_from_numpy

torch.set_num_threads(2)


def _problem(seed, cap=12, n_act=9, s_steps=6):
    rng = np.random.default_rng(seed)
    d = 3 + 2 * cap
    na = 3 + 2 * n_act
    a = rng.normal(size=(na, na)).astype(np.float32) * 0.1
    p = np.zeros((d, d), np.float32)
    p[:na, :na] = a @ a.T + np.eye(na, dtype=np.float32) * 0.3
    x = np.zeros((d,), np.float32)
    x[:3] = [5.0, -3.0, 0.4]
    x[3:na] = rng.uniform(-200, 200, size=(na - 3,)).astype(np.float32)
    ctrl = dict(
        vns=(83.33 + rng.normal(size=s_steps) * 0.3).astype(np.float32),
        swans=(0.1 + rng.normal(size=s_steps) * 0.02).astype(np.float32),
        phis=(0.4 + np.cumsum(rng.normal(size=s_steps)) * 0.01).astype(np.float32),
    )
    q = np.diag([0.18, 0.0006]).astype(np.float32)
    return x, p, ctrl, q


def _both(x, p, ctrl, q, active, sigma_h, use_heading, fn):
    jstate = jekf.init_state(12, 40)._replace(x=jnp.asarray(x), p=jnp.asarray(p))
    tstate = state_from_numpy(x, p, 9, np.full(40, -1), device="cpu")
    jargs = [jnp.asarray(ctrl[k]) for k in ("vns", "swans", "phis")]
    targs = [torch.as_tensor(ctrl[k]) for k in ("vns", "swans", "phis")]
    ref = getattr(jff, fn)(jstate, *jargs, jnp.asarray(active), jnp.asarray(q),
                           73.0, 0.01, sigma_h, use_heading)
    got = getattr(tff, fn)(tstate, *targs, torch.as_tensor(active), torch.as_tensor(q),
                           73.0, 0.01, sigma_h, use_heading)
    return ref, got


@pytest.mark.parametrize("use_heading", [True, False])
def test_coeff_frame_core_matches(use_heading):
    x, p, ctrl, q = _problem(5)
    active = np.ones(6, bool)
    q_chol = np.linalg.cholesky(q).astype(np.float32)
    ref = jff.coeff_frame_core(
        jnp.asarray(x[:3]), jnp.asarray(p[:3, 2]), jnp.asarray(p[2, 2]),
        *(jnp.asarray(ctrl[k]) for k in ("vns", "swans", "phis")), jnp.asarray(active),
        jnp.asarray(q_chol), 73.0, 0.01, 0.05, use_heading,
    )
    got = tff.coeff_frame_core(
        torch.as_tensor(x[:3]), torch.as_tensor(p[:3, 2]), torch.as_tensor(p[2, 2]),
        *(torch.as_tensor(ctrl[k]) for k in ("vns", "swans", "phis")),
        torch.as_tensor(active), torch.as_tensor(q_chol), 73.0, 0.01, 0.05, use_heading,
    )
    for name, r, g in zip(("pose", "pose_trace", "corr0", "cmat", "bmat"), ref, got):
        # Same float32 recursion: a few ulps (libm sin/cos differ in the last bit).
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("use_heading", [True, False])
def test_frame_factors_and_predict_heading_match(use_heading):
    x, p, ctrl, q = _problem(7)
    active = np.array([1, 1, 1, 1, 1, 0], bool)
    (jst, jpt, jv, jb), (tst, tpt, tv, tb) = _both(
        x, p, ctrl, q, active, 0.05, use_heading, "frame_factors")
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tpt.numpy(), np.asarray(jpt), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-9)
    jfull, tfull = _both(x, p, ctrl, q, active, 0.05, use_heading, "frame_predict_heading")
    np.testing.assert_allclose(tfull.p.numpy(), np.asarray(jfull.p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfull.x.numpy(), np.asarray(jfull.x), rtol=1e-6, atol=1e-5)


def test_done_mask_all_inactive_is_a_no_op():
    x, p, ctrl, q = _problem(9)
    _, tfull = _both(x, p, ctrl, q, np.zeros(6, bool), 0.001, True, "frame_predict_heading")
    np.testing.assert_allclose(tfull.x.numpy(), x, atol=1e-6)
    np.testing.assert_allclose(tfull.p.numpy(), p, atol=1e-5)


def _sequential_f64(x0, p0, vns, swans, phis, q, wb, dt, sig_h):
    """Float64 numpy oracle: S sequential predict + heading steps."""
    x = np.asarray(x0, np.float64).copy()
    p = np.asarray(p0, np.float64).copy()
    q = np.asarray(q, np.float64)
    r = float(sig_h) ** 2

    def wrap(a):
        return (a + np.pi) % (2 * np.pi) - np.pi

    for k in range(len(vns)):
        v, swa = float(vns[k]), float(swans[k])
        a = swa + x[2]
        g = np.eye(x.shape[0])
        g[0, 2], g[1, 2] = -v * dt * np.sin(a), v * dt * np.cos(a)
        gu = np.array([[dt * np.cos(a), -v * dt * np.sin(a)],
                       [dt * np.sin(a), v * dt * np.cos(a)],
                       [dt * np.sin(swa) / wb, v * dt * np.cos(swa) / wb]])
        p = g @ p @ g.T
        p[:3, :3] += gu @ q @ gu.T
        x[0] += v * dt * np.cos(a)
        x[1] += v * dt * np.sin(a)
        x[2] = wrap(x[2] + v * dt * np.sin(swa) / wb)
        pc = p[:, 2].copy()
        s = pc[2] + r
        w = pc / s
        x = x + w * wrap(float(phis[k]) - x[2])
        x[2] = wrap(x[2])
        p = p - np.outer(w, pc) - np.outer(pc, w) + s * np.outer(w, w)
    return x, p


def test_realistic_sigma_vs_f64_oracle_as_accurate_as_the_reference():
    x, p, ctrl, q = _problem(11)
    ctrl["phis"] = (0.4 + np.cumsum(np.random.default_rng(11).normal(size=6)) * 0.002
                    ).astype(np.float32)
    sigma_h = 0.01 * np.pi / 180.0
    x64, p64 = _sequential_f64(x, p, ctrl["vns"], ctrl["swans"], ctrl["phis"], q,
                               73.0, 0.01, sigma_h)
    jfull, tfull = _both(x, p, ctrl, q, np.ones(6, bool), sigma_h, True,
                         "frame_predict_heading")
    err_ref_x = np.abs(np.asarray(jfull.x, np.float64) - x64).max()
    err_port_x = np.abs(tfull.x.numpy().astype(np.float64) - x64).max()
    err_ref_p = np.abs(np.asarray(jfull.p, np.float64) - p64).max()
    err_port_p = np.abs(tfull.p.numpy().astype(np.float64) - p64).max()
    # The reference holds its compounded form to 3x the sequential error;
    # the port is held to 3x the reference's own compounded error.
    assert err_port_x <= 3.0 * err_ref_x + 1e-4, (err_port_x, err_ref_x)
    assert err_port_p <= 3.0 * err_ref_p + 1e-5, (err_port_p, err_ref_p)
