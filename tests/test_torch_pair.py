"""Port parity for the frame pair (two known-association frames, one P
pass): ``ops.frame_kernel.frame_step_pair`` against the JAX reference's
``frame_step_pair`` and against two sequential frames, and the driver's
choice of route.  The pair driver against the reference's driver is a case
of tests/test_torch_slice.py::test_slice_matches_reference.

On the CPU the pair runs its kernels' plain versions; the reference runs
its Pallas kernels in interpret mode, or its jnp route (two reference
frames).  Tolerances, each with its reason:
  * against the reference's interpreted pair: the reference's frame test
    (pose traces 1e-5, mean 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol 1e-3 /
    atol 1e-5).  Its stacked pass runs the bf16 "split3" product tier
    (frame_kernel.py:1578-1582: hi/lo halves, the lo x lo term dropped,
    ~2^-16 of a product) where the port stays float32; on P's entries of
    ~0.3 that is ~5e-6 (observed 1.8e-6), inside atol 1e-4.
  * against two sequential frames (the port's and the reference's jnp
    route): frame A's pose trace 1e-5 (the same chain on the same strips);
    frame B's pose trace 1e-4, the mean rtol 1e-4 / atol 2e-4, P rtol 1e-3
    / atol 2e-4 and NIS rtol 1e-3 / atol 1e-5 (the reference's own pair
    test, tests/test_pallas_ops.py:552-569): frame B reads strips rebuilt
    as P[rows] + G_A[:, rows]^T (M_A G_A), rounded otherwise than the
    materialised P_A.
  * the per-frame route where the driver cannot pair: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.ops import frame_kernel as tfk
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.sim.world import default_world

torch.set_num_threads(2)

TAIL = (73.0, 0.01, 0.01 * np.pi / 180)


def _frame(rng, x, nz, capacity):
    """One frame's controls, measurements of ``nz`` mapped landmarks seen
    from the mean ``x`` and gathered rows, all at the sensors' noise scale
    (speed 0.3 m/s about a standstill, range 0.1 m, bearing 0.01 rad,
    heading sigma_heading), so the frame's update is of the usual size."""
    s = 6
    ids = rng.choice(capacity, size=nz, replace=False)
    fx, fy = x[3 + 2 * ids] - x[0], x[4 + 2 * ids] - x[1]
    zr = (np.hypot(fx, fy) + rng.normal(size=nz) * 0.1).astype(np.float32)
    zb = (np.arctan2(fy, fx) - x[2] + rng.normal(size=nz) * 0.01).astype(np.float32)
    mask = np.ones(nz, bool)
    mask[rng.integers(nz)] = False
    ctrl = ((rng.normal(size=s) * 0.3).astype(np.float32),
            (rng.normal(size=s) * 0.02).astype(np.float32),
            (x[2] + rng.normal(size=s) * TAIL[2]).astype(np.float32),
            np.array([1, 1, 1, 1, 1, 0], bool))
    rows = np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)])
    return rows, ctrl, (zr, zb, mask)


def _pair_problem(seed, capacity=100, nz=10):
    """A frame-start state at D = 256 (a pad to 128, as the reference's
    _frame_step_problem) and two frames; frame B is measured from frame A's
    updated pose, so its innovations sit at the sensor's noise scale."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-50, 50, size=(capacity, 2)).astype(np.float32)
    state = jekf.init_state_with_map(lm, sigma0=0.5, pad_multiple=128)
    d = state.x.shape[0]
    a = rng.normal(size=(d, 8)).astype(np.float32) * 0.05
    p, x = np.asarray(state.p) + a @ a.T, np.array(state.x)
    q = np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)
    r = np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32)
    frame_a = _frame(rng, x, nz, capacity)
    rows, ctrl, meas = frame_a
    fa = tfk.frame_step(_torch(p), _torch(x), _torch(_slots(rows)), capacity, *map(_torch, ctrl),
                        _torch(q), *map(_torch, meas), _torch(r), *TAIL, True)
    frame_b = _frame(rng, fa.x.numpy(), nz, capacity)
    return p, x, frame_a, frame_b, q, r


def _args(prob, to, use_heading):
    """``frame_step_pair``'s arguments, each array through ``to``."""
    p, x, (rows_a, ctrl_a, meas_a), (rows_b, ctrl_b, meas_b), q, r = prob
    return (to(p), to(x), to(rows_a.astype(np.int32)), tuple(map(to, ctrl_a)),
            tuple(map(to, meas_a)), to(rows_b.astype(np.int32)), tuple(map(to, ctrl_b)),
            tuple(map(to, meas_b)), to(q), to(r), *TAIL, use_heading)


def _slots(rows):
    """The map slots of gathered rows [0, 1, 2, 3 + 2 s, 4 + 2 s, ...]."""
    return (np.asarray(rows)[3::2] - 3) // 2


def _torch(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.int32 else a)


def test_frame_step_pair_matches_reference_kernel():
    # The reference's pair as its TPU runs it (two interpreted chain
    # dispatches, one interpreted stacked rank pass) at D = 256.
    prob = _pair_problem(71)
    ref = jfk.frame_step_pair(*_args(prob, jnp.asarray, True), interpret=True)
    got = tfk.frame_step_pair(*_args(prob, _torch, True))
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(ref.pose_trace),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pose_mid.numpy(), np.asarray(ref.pose_mid),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(got.nis.numpy(), np.asarray(ref.nis), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("use_heading,seed", [(True, 73), (False, 79)])
def test_frame_step_pair_matches_two_frames(use_heading, seed):
    prob = _pair_problem(seed)
    args = _args(prob, _torch, use_heading)
    (p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b, q, r, *tail) = args
    got = tfk.frame_step_pair(*args)
    fa = tfk.frame_step(p, x, _torch(_slots(rows_a)), 100, *ctrl_a, q, *meas_a, r, *tail)
    fb = tfk.frame_step(fa.p, fa.x, _torch(_slots(rows_b)), 100, *ctrl_b, q, *meas_b, r, *tail)
    # The reference's CPU route: two jnp reference frames.
    jref = jfk.frame_step_pair(*_args(prob, jnp.asarray, use_heading))
    for pt, pose_mid, xb, pb, nis in (
            (np.stack([fa.pose_trace, fb.pose_trace]), fa.x[:3], fb.x, fb.p,
             np.stack([fa.nis, fb.nis])),
            (jref.pose_trace, jref.pose_mid, jref.x, jref.p, jref.nis)):
        np.testing.assert_allclose(got.pose_trace[0].numpy(), np.asarray(pt)[0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.pose_trace[1].numpy(), np.asarray(pt)[1],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.pose_mid.numpy(), np.asarray(pose_mid),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(xb), rtol=1e-4, atol=2e-4)
        np.testing.assert_allclose(got.p.numpy(), np.asarray(pb), rtol=1e-3, atol=2e-4)
        np.testing.assert_allclose(got.nis.numpy(), np.asarray(nis), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("case", ["odd_frames", "augment", "gated"])
def test_driver_runs_frames_one_by_one_where_it_cannot_pair(case, monkeypatch):
    # frame_pair=True selects the pair only where the reference's use_pair
    # holds (runner/loop.py:307-315); elsewhere the per-frame loop runs,
    # bit-equal to frame_pair=False.
    world = default_world(device="cpu")
    kw = dict(max_landmarks=30, max_obs=16, enable_augment=False)
    n_steps, state0 = 60, init_state_with_map(world.landmarks)
    if case == "odd_frames":
        n_steps = 66
    elif case == "augment":
        kw["enable_augment"], state0 = True, None
    else:
        kw["switch_association_known"], state0 = False, None
    roll = loop.precompute_rollout(world, SlamConfig(**kw), n_steps)
    runs = []
    for pair in (False, True):
        def no_pair(*a, **k):
            raise AssertionError("the driver paired frames it cannot pair")
        monkeypatch.setattr(loop, "ekf_precomp_pair_step", no_pair)
        gen = torch.Generator().manual_seed(5)
        runs.append(loop.run_ekf_slam_precomputed(world, SlamConfig(**kw, frame_pair=pair), gen,
                                                  n_steps, state0, roll))
    for a, b in zip(jax.tree_util.tree_leaves(runs[0]), jax.tree_util.tree_leaves(runs[1])):
        assert torch.equal(a, b)
