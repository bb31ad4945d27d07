"""Port parity for the gated, mapping-from-scratch EKF (BASELINE config 2):
the factor, gating and whole-frame-update kernels' plain versions,
``associate_gated``, ``fused_frame_update``, ``augment`` and the whole
gated slice, against the JAX reference.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernels in interpret mode (or its jnp route), as
its own tests/test_pallas_ops.py does.  Tolerances, each with its reason:
  * frame factors: the reference's own (mean and pose trace 1e-5, vtf
    rtol 1e-4 / atol 1e-5, B atol 1e-6): the same float32 recursion.
  * frame update: x rtol/atol 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol
    1e-3 / atol 1e-5 (the reference's megakernel test): float32 products
    in another order, the sweep inverse against the reference's Cholesky.
  * gating scores: nd and min NIS rtol 1e-4 / atol 1e-3.  The reference
    kernel's polynomial atan2 is good to ~2e-6 rad; against a bearing
    sigma of 1 degree that moves a NIS by ~1e-4.
  * augment: rtol 1e-6 / atol 1e-6, one float32 product of the same terms.
  * the whole slice (1,200 steps from an empty map): identical per-step
    map size and final id table; pose trace atol 5e-3 m (observed 1.6e-3:
    float32 ulps of the two packages' op orders, carried over 200 frames);
    map means atol 0.1 m (observed 0.047: a feature founded from the pose
    carries that drift through its range lever arm); P rtol 1e-2 of each
    entry's scale (observed 3.8e-3 on fresh ~15 m^2 feature priors).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.core import linalg as jlinalg
from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.filters.common import CompactObs as JCompactObs
from conan_slam_tpu.filters.ekf import associate as jassociate
from conan_slam_tpu.filters.ekf.update import fused_frame_update as j_fused_frame_update
from conan_slam_tpu.models import sensor as jsensor
from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu.ops.factor_kernel import frame_factors_fused as j_frame_factors_fused
from conan_slam_tpu.ops.gating_kernel import gating_scores as j_gating_scores
from conan_slam_tpu.runner.loop import run_ekf_slam_precomputed as j_run
from conan_slam_tpu.sim.world import default_world as j_default_world, random_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.core.linalg import det2, inv2
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf import associate_gated, augment, fused_frame_update
from conan_slam_tpu_torch.filters.ekf.associate import _innovation_blocks, gated_scores_dense
from conan_slam_tpu_torch.filters.ekf.state import state_from_numpy
from conan_slam_tpu_torch.models.sensor import init_feature
from conan_slam_tpu_torch.ops import cuda, frame_kernel as tfk
from conan_slam_tpu_torch.ops.factor_kernel import factor_gate, frame_factors_fused
from conan_slam_tpu_torch.ops.gating_kernel import gating_scores
from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
from conan_slam_tpu_torch.sim.world import _CONFIG2_LANDMARKS, config2_world, default_world

torch.set_num_threads(2)

R_COV = np.diag([0.1**2, (np.pi / 180) ** 2]).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _pair(x, p, n_active, table):
    """The same state in both packages."""
    jstate = jekf.EKFState(x=_j(x), p=_j(p), n_active=jnp.int32(n_active),
                           table=jnp.asarray(np.asarray(table, np.int32)))
    return jstate, state_from_numpy(x, p, n_active, table, device="cpu")


def _obs_pair(z, ids, mask):
    jobs = JCompactObs(z=_j(z), ids=_j(np.asarray(ids, np.int32)), mask=_j(mask))
    return jobs, CompactObs(z=_t(z), ids=_t(np.asarray(ids, np.int64)), mask=_t(mask))


def _map_problem(seed, k=100, nz=10, n_active=None, pad_multiple=128, far=False):
    """A mapped state (correlated P), measurements of active landmarks."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-60, 60, size=(k, 2)).astype(np.float32)
    jstate = jekf.init_state_with_map(lm, sigma0=0.4, pad_multiple=pad_multiple)
    d = jstate.x.shape[0]
    a = rng.normal(size=(d, 6)).astype(np.float32) * 0.03
    p = np.asarray(jstate.p) + a @ a.T
    n_active = k if n_active is None else n_active
    ids = rng.choice(n_active, size=nz, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01],
                 -1).astype(np.float32)
    if far:
        z[-1] = [500.0, 1.0]                 # far away: a new feature
    mask = np.ones(nz, bool)
    mask[-2] = False
    return np.asarray(jstate.x), p, n_active, np.asarray(jstate.table), z, ids, mask


def _factors(rng, d, nb):
    vmat = rng.normal(size=(d, nb)).astype(np.float32) * 0.01
    b = rng.normal(size=(nb, nb)).astype(np.float32) * 0.1
    return vmat, (0.5 * (b + b.T)).astype(np.float32)


# ------------------------------------------------------------ small helpers


def test_inv2_det2_init_feature_match_reference():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(7, 2, 2)).astype(np.float32)
    m[0] = [[1.0, 2.0], [2.0, 4.0]]              # singular: inverse is zero
    np.testing.assert_allclose(inv2(_t(m)).numpy(), np.asarray(jlinalg.inv2(_j(m))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(det2(_t(m)).numpy(), np.asarray(jlinalg.det2(_j(m))),
                               rtol=1e-6, atol=1e-6)
    pose = np.array([3.0, -2.0, 0.7], np.float32)
    z = np.stack([rng.uniform(5, 80, 9), rng.uniform(-1.5, 1.5, 9)], -1).astype(np.float32)
    for got, ref in zip(init_feature(_t(pose), _t(z)), jsensor.init_feature(_j(pose), _j(z))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-5)


# --------------------------------------------- H5: the frame factors (T5)


@pytest.mark.parametrize("use_heading,seed", [(True, 23), (False, 29)])
def test_frame_factors_match_reference_kernel(use_heading, seed):
    x, p, n_act, table, *_ = _map_problem(seed)
    jstate, tstate = _pair(x, p, n_act, table)
    rng = np.random.default_rng(seed)
    ctrl = [(83.33 + rng.normal(size=6) * 0.3).astype(np.float32),
            (rng.normal(size=6) * 0.2).astype(np.float32),
            (rng.normal(size=6) * 0.5).astype(np.float32),
            np.array([1, 1, 1, 1, 1, 0], bool),
            np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)]
    tail = (73.0, 0.01, 0.01 * np.pi / 180, use_heading)
    ref = j_frame_factors_fused(jstate, *map(_j, ctrl), *tail, interpret=True)
    got = frame_factors_fused(tstate, *map(_t, ctrl), *tail)
    np.testing.assert_allclose(got[0].x.numpy(), np.asarray(ref[0].x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-5, atol=1e-6)
    assert got[2].shape == ref[2].shape and got[3].shape == ref[3].shape
    nb = 2 + 12 + (6 if use_heading else 0)
    assert not got[2][nb:].any() and not got[3][nb:].any()


# ----------------------------------------- H6: the gating scores (T7)


@pytest.mark.parametrize("virtual", [False, True])
def test_gating_scores_match_reference_kernel(virtual):
    # Odd K (the reference's panel padding), five inactive slots and a far
    # measurement that passes no gate.
    k = 87
    x, p, _, table, z, ids, mask = _map_problem(51, k=k, nz=12, n_active=k - 5, far=True)
    jstate, tstate = _pair(x, p, k - 5, table)
    vmat, bmat = _factors(np.random.default_rng(52), x.shape[0], 10)
    vm = (_j(vmat), _j(bmat)) if virtual else (None, None)
    tvm = (_t(vmat), _t(bmat)) if virtual else (None, None)
    jb = jassociate._innovation_blocks(jstate, *vm)
    tb = _innovation_blocks(tstate, *tvm)
    for got, ref in zip(tb, jb):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    # Each block keeps its orientation: exact on an asymmetric P.
    pa = p + np.triu(np.full_like(p, 0.01), 1)
    for got, ref in zip(_innovation_blocks(_pair(x, pa, k - 5, table)[1]),
                        jassociate._innovation_blocks(_pair(x, pa, k - 5, table)[0])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    ref = j_gating_scores(_j(z), _j(mask), jstate.pose, jstate.features, jstate.active_mask,
                          *jb, _j(R_COV), 50.0, interpret=True)
    got = gating_scores(_t(z), tstate.pose, tstate.features, tstate.active_mask, *tb,
                        _t(R_COV), 50.0)
    found = np.asarray(ref[0]) < 1e38
    assert found[:-1].all() and not found[-1]
    np.testing.assert_array_equal(got[0].numpy() < 1e38, found)
    np.testing.assert_allclose(got[0].numpy()[found], np.asarray(ref[0])[found],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got[1].numpy()[found], np.asarray(ref[1])[found])
    assert int(got[1][-1]) == -1
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("virtual", [False, True])
def test_associate_gated_matches_reference(virtual):
    k = 87
    x, p, _, table, z, ids, mask = _map_problem(51, k=k, nz=12, n_active=k - 5, far=True)
    jstate, tstate = _pair(x, p, k - 5, table)
    jobs, tobs = _obs_pair(z, ids, mask)
    vmat, bmat = _factors(np.random.default_rng(52), x.shape[0], 10)
    vm = (_j(vmat), _j(bmat)) if virtual else (None, None)
    tvm = (_t(vmat), _t(bmat)) if virtual else (None, None)
    r = jekf.associate_gated(jstate, jobs, _j(R_COV), 50.0, 1000.0, *vm, use_pallas=False)
    g = associate_gated(tstate, tobs, _t(R_COV), 50.0, 1000.0, *tvm)
    np.testing.assert_array_equal(g.known_mask.numpy(), np.asarray(r.known_mask))
    np.testing.assert_array_equal(g.new_mask.numpy(), np.asarray(r.new_mask))
    km = np.asarray(r.known_mask)
    np.testing.assert_array_equal(g.slots.numpy()[km], np.asarray(r.slots)[km])
    assert bool(g.new_mask[-1]) and km.sum() == 10


def test_associate_gated_empty_map_founds_every_measurement():
    x, p, _, table, z, ids, mask = _map_problem(8, k=20, nz=6, n_active=20)
    jstate, tstate = _pair(x, p, 0, table)
    jobs, tobs = _obs_pair(z, ids, mask)
    r = jekf.associate_gated(jstate, jobs, _j(R_COV), 50.0, 1000.0, use_pallas=False)
    g = associate_gated(tstate, tobs, _t(R_COV), 50.0, 1000.0)
    assert not g.known_mask.any()
    np.testing.assert_array_equal(g.new_mask.numpy(), np.asarray(r.new_mask))
    np.testing.assert_array_equal(g.new_mask.numpy(), mask)


# -------------------- H15: the factors and the association in one launch


def _gate_frame(seed, k, use_heading, tie=None):
    """A frame-start state with ``k`` slots (five inactive), a frame's
    controls and, from the post-frame pose, range/bearing measurements of
    active landmarks, the last far from every slot (it passes no gate).
    ``tie`` = (j1, j2) makes slot j2 a copy of slot j1 (its mean, its rows
    and columns of P) and measurement 0 a measurement of it: an exact nd
    tie between the two slots."""
    x, p, _, table, *_ = _map_problem(seed, k=k, nz=12, n_active=k - 5)
    x, p = x.copy(), p.copy()
    if tie is not None:
        j1, j2 = tie
        r1, r2 = 3 + 2 * j1 + np.arange(2), 3 + 2 * j2 + np.arange(2)
        x[r2] = x[r1]
        p[r2, :] = p[r1, :]
        p[:, r2] = p[:, r1]
    rng = np.random.default_rng(seed + 1)
    ctrl = [(83.33 + rng.normal(size=6) * 0.3).astype(np.float32),
            (rng.normal(size=6) * 0.2).astype(np.float32),
            (rng.normal(size=6) * 0.5).astype(np.float32),
            np.array([1, 1, 1, 1, 1, 0], bool),
            np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)]
    tail = (73.0, 0.01, 0.01 * np.pi / 180, use_heading)
    tstate = _pair(x, p, k - 5, table)[1]
    pose = frame_factors_fused(tstate, *map(_t, ctrl), *tail)[0].x[:3].numpy()
    lm = x[3:3 + 2 * k].reshape(k, 2)
    ids = rng.choice(k - 5, size=12, replace=False)
    if tie is not None:
        ids[0] = tie[0]
    d = lm[ids] - pose[:2]
    z = np.stack([np.hypot(d[:, 0], d[:, 1]) + rng.normal(size=12) * 0.05,
                  np.arctan2(d[:, 1], d[:, 0]) - pose[2] + rng.normal(size=12) * 0.005],
                 -1).astype(np.float32)
    if tie is not None:
        z[0] = [np.hypot(*d[0]), np.arctan2(d[0, 1], d[0, 0]) - pose[2]]
    z[-1] = [500.0, 1.0]
    mask = np.ones(12, bool)
    mask[-2] = False
    return x, p, table, ctrl, tail, z, mask


# K 87 (one reference panel) and 203 (two), neither a multiple of any tile
# of either package; the tie's slots in one panel and across two.
@pytest.mark.parametrize("use_heading", [True, False])
@pytest.mark.parametrize("k,tie", [(87, None), (87, (7, 40)), (203, (7, 150))])
def test_factor_gate_plain_route_matches_reference(k, tie, use_heading):
    # H15's plain route (factor_gate on CPU tensors) against the JAX
    # package: its factor kernel and gating kernel in interpret mode with
    # the host fold between them, and associate_gated's mask rule.  The
    # tolerances are the factor kernel's and the gating kernel's above.
    x, p, table, ctrl, tail, z, mask = _gate_frame(71 + k, k, use_heading, tie)
    jstate, tstate = _pair(x, p, k - 5, table)
    gate_reject, gate_augment = 50.0, 1000.0
    jst1, jpt, jvtf, jbm = j_frame_factors_fused(jstate, *map(_j, ctrl), *tail, interpret=True)
    jb = jassociate._innovation_blocks(jst1, jvtf.T, jbm)
    rnd, rj, rmn = (np.asarray(a) for a in j_gating_scores(
        _j(z), _j(mask), jst1.pose, jst1.features, jst1.active_mask, *jb, _j(R_COV),
        gate_reject, interpret=True))
    cuda.reset_launch_counts()
    got = factor_gate(tstate, *map(_t, ctrl), *tail, _t(z), _t(mask), _t(R_COV), gate_reject,
                      gate_augment)
    assert not any(kk.launches for kk in cuda.KERNELS.values())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jst1.x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(jpt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.vtf.numpy(), np.asarray(jvtf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.bmat.numpy(), np.asarray(jbm), rtol=1e-5, atol=1e-6)
    found = rnd < 1e38
    assert found[:-2].all() and not found[-1]          # the far measurement passes no gate
    np.testing.assert_array_equal(got.best_nd.numpy() < 1e38, found)
    np.testing.assert_allclose(got.best_nd.numpy()[found], rnd[found], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(got.best_j.numpy()[found], rj[found])
    assert int(got.best_j[-1]) == -1
    np.testing.assert_allclose(got.min_nis.numpy(), rmn, rtol=1e-4, atol=1e-3)
    # associate_gated's mask rule (the reference's, on its kernel's scores).
    np.testing.assert_array_equal(got.known_mask.numpy(), mask & found)
    np.testing.assert_array_equal(got.slots.numpy(), np.where(found, rj, 0))
    np.testing.assert_array_equal(got.new_mask.numpy(), mask & ~found & (rmn > gate_augment))
    if tie is not None:
        # The two slots score the same nd exactly; the lower one wins.
        nis, nd = gated_scores_dense(got_state := tstate._replace(x=got.x), _t(z), _t(R_COV),
                                     got.vtf.T, got.bmat)
        assert float(nd[0, tie[0]]) == float(nd[0, tie[1]]) and bool(nis[0, tie[0]] < 50.0)
        assert int(got.best_j[0]) == int(rj[0]) == tie[0]
        assert got_state.x.shape == tstate.x.shape


def test_factor_gate_constants_match_the_kernel_source():
    # H15's block, tile and stamp constants as the wrappers read them, and
    # the gating tile a wrapper picks: a multiple of 32 to FG_MAX_TILE,
    # about two gating blocks an SM (32 slots at config 2's K, 64 at the
    # 10k shape's on 132 SMs, the most at a K past them).
    import re

    from conan_slam_tpu_torch.ops import factor_kernel, gating_kernel

    src = (cuda.CSRC / "factor_gate.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (FG_\w+) +(\d+)", src)}
    assert consts["FG_THREADS"] == factor_kernel.FG_THREADS
    assert consts["FG_STAMPS"] == factor_kernel.FG_STAMPS
    assert consts["FG_MAX_TILE"] == gating_kernel.MAX_TILE
    assert "fg_launch(factor_gate_kernel, a, a.n_strip + fg_gate_blocks(k, tile), true" in src
    props = type("Props", (), {"multi_processor_count": 132})
    get = torch.cuda.get_device_properties
    torch.cuda.get_device_properties = lambda device: props
    try:
        tiles = {k: gating_kernel.gate_tile(k, "cuda") for k in (87, 510, 10_110, 60_000, 10**6)}
        grid = factor_kernel.factor_gate_grid(20_224, 10_110, "cuda")
    finally:
        torch.cuda.get_device_properties = get
    assert tiles == {87: 32, 510: 32, 10_110: 64, 60_000: 224, 10**6: 224}
    assert grid == (79, 158, 64)


def _fold(st, vns, swans, phis, act, q, tail):
    """The virtual covariance's innovation blocks by H15's algebra: u = V3
    B c0, s = c0^T B c0 and the pose block P + V3 B V3^T from the frame's
    coefficient columns; then pvm = P + u p2_j^T, pjj = P + s p2_j p2_j^T."""
    from conan_slam_tpu_torch.core.linalg import chol2
    from conan_slam_tpu_torch.filters.ekf.fastframe import coeff_frame_core

    p2 = st.p[:, 2]
    *_, cmat, bmat = coeff_frame_core(st.pose, p2[:3], p2[2], vns, swans, phis, act, chol2(q),
                                      *tail)
    v3 = p2[:3, None] * cmat[0][None, :] + cmat[1:]             # the strip's pose rows
    bc0 = bmat @ cmat[0]
    u, s = v3 @ bc0, cmat[0] @ bc0
    k = st.capacity
    p2m = p2[3:3 + 2 * k].reshape(k, 2)
    pvm = st.p[:3, 3:3 + 2 * k].reshape(3, k, 2).permute(1, 0, 2) + u[None, :, None] * p2m[:, None]
    rows = 3 + 2 * torch.arange(k)[:, None, None] + torch.arange(2)[:, None]
    pjj = st.p[rows, rows.transpose(1, 2)] + s * p2m[:, :, None] * p2m[:, None, :]
    return st.p[:3, :3] + v3 @ bmat @ v3.T, pvm, pjj


@pytest.mark.parametrize("use_heading", [True, False])
def test_factor_gate_fold_equals_innovation_blocks(use_heading):
    # The rank-one fold H15 runs in place of the host's (K, 3, 2) products:
    # in float64 it equals _innovation_blocks(st, vtf^T, B) of the padded
    # strip to 1e-12.
    from conan_slam_tpu_torch.ops.factor_kernel import _frame_factors_reference

    x, p, table, ctrl, tail, *_ = _gate_frame(93, 87, use_heading)
    st = _pair(x, p, 82, table)[1]
    st = st._replace(x=st.x.double(), p=st.p.double())
    c64 = [_t(c).double() if c.dtype == np.float32 else _t(c) for c in ctrl]
    st1, _, vtf, bmat = _frame_factors_reference(st, *c64, *tail)
    assert vtf.dtype == torch.float64
    for got, ref in zip(_fold(st, *c64, tail), _innovation_blocks(st1, vtf.T, bmat)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-12)


def test_gated_frame_step_on_the_cpu_is_the_parent_route():
    # One gated frame of the frame loop on the CPU (factor_and_associate_gated's
    # CPU route): bit for bit H5's plain version, then associate_gated's
    # dense route, the update and augmentation, as the loop ran them before
    # H15 (a frame of the 30-landmark world after 60 frames from an empty map).
    from conan_slam_tpu_torch.runner.loop import _noisy_obs, ekf_precomp_frame_step, make_noise
    from conan_slam_tpu_torch.sim.sensor_sim import add_control_noise

    cfg = SlamConfig(max_landmarks=30, max_obs=16, switch_association_known=False)
    world = default_world(device="cpu")
    s = cfg.observe_interval
    roll = precompute_rollout(world, cfg, 61 * s)
    rng = np.random.default_rng(5)
    ctrl = _t(rng.normal(size=(61, s, 2)).astype(np.float32))
    obsn = _t(rng.normal(size=(61, roll[1][0].shape[1], 2)).astype(np.float32))
    part = (tuple(a[:60 * s] for a in roll[0]), tuple(a[:60] for a in roll[1]))
    state, _ = run_ekf_slam_precomputed(world, cfg, None, 60 * s, None, part,
                                        ctrl_noise=ctrl[:60], obs_noise=obsn[:60])
    assert int(state.n_active) > 0
    (x_true, swa, active, done), (z_true, ids, zmask) = roll
    frame = (x_true[60 * s:], swa[60 * s:], active[60 * s:], done[60 * s:], ctrl[60],
             z_true[60], ids[60], zmask[60], obsn[60])
    noise = make_noise(cfg, device="cpu")
    got = ekf_precomp_frame_step(state, frame, cfg=cfg, noise=noise)

    vns, swans = add_control_noise(frame[4], cfg.velocity, frame[1], cfg.sigma_v, cfg.sigma_swa,
                                   cfg.switch_control_noise)
    obs = _noisy_obs(cfg, frame[5], frame[6], frame[7], frame[8])
    live = torch.logical_not(frame[3][-1])
    st, pose_trace, vtf, bmat = frame_factors_fused(
        state, vns, swans, frame[0][:, 2], frame[2], noise.qe, cfg.wheel_base, cfg.dt_controls,
        cfg.sigma_heading, cfg.switch_heading_known)
    assoc = associate_gated(st, obs, noise.re, cfg.gate_reject, cfg.gate_augment, vtf.T, bmat)
    assert bool(assoc.known_mask.any())
    st, nis = fused_frame_update(st, bmat, vtf, obs, assoc.slots, assoc.known_mask & live,
                                 noise.re, return_nis=True)
    st = augment(st, obs, assoc.new_mask & live, noise.re)
    want = (st, torch.cat([pose_trace[:-1], st.x[None, :3]]), nis)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


# ---------------------------------- H7 + H1 + H8 + H4: the frame update (T6)


def _update_problem(seed, all_masked=False, nb=12):
    x, p, n_act, table, z, ids, mask = _map_problem(seed, k=100, nz=10)
    if all_masked:
        mask = np.zeros_like(mask)
    vmat, bmat = _factors(np.random.default_rng(seed + 1), x.shape[0], nb)
    rows = np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)])
    return x, p, n_act, table, z, ids, mask, vmat, bmat, rows


@pytest.mark.parametrize("all_masked", [False, True])
def test_frame_update_obs_matches_reference_kernel(all_masked):
    x, p, _, _, z, ids, mask, vmat, bmat, rows = _update_problem(13, all_masked)
    vtf = np.ascontiguousarray(vmat.T)
    args = (p, x, rows.astype(np.int32), z[:, 0], z[:, 1], mask, R_COV, bmat, vtf)
    ref = jfk.frame_update_obs(*map(_j, args), interpret=True)
    # The port takes the raw slots and the table's capacity (100 slots).
    got = tfk.frame_update_obs(*(_t(a) for a in args[:2]), _t(ids.astype(np.int64)), 100,
                               *map(_t, args[3:]))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)
    if all_masked:
        # No measurement: the factored correction alone, mean unchanged.
        np.testing.assert_allclose(got.x.numpy(), x, atol=1e-5)
        np.testing.assert_allclose(got.p.numpy(), p + vmat @ bmat @ vmat.T, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("form", ["vmat", "vtf", "measurement_only"])
def test_fused_frame_update_matches_reference(form):
    # The port takes the factors only as the row strip vtf (r, D) and B; it
    # is held against each of the reference's input forms: vmat (D, r), vtf,
    # and bmat=None (a measurement-only update, zero factors in the port).
    x, p, n_act, table, z, ids, mask, vmat, bmat, _ = _update_problem(17)
    jstate, tstate = _pair(x, p, n_act, table)
    jobs, tobs = _obs_pair(z, ids, mask)
    slots = ids
    vtf = np.ascontiguousarray(vmat.T)
    if form == "measurement_only":
        jf = dict(vmat=None, bmat=None)
        bmat, vtf = np.zeros((8, 8), np.float32), np.zeros((8, x.shape[0]), np.float32)
    elif form == "vtf":
        jf = dict(vmat=None, bmat=_j(bmat), vtf=_j(vtf))
    else:
        jf = dict(vmat=_j(vmat), bmat=_j(bmat))
    rs, rn = j_fused_frame_update(jstate, jf.pop("vmat"), jf.pop("bmat"), jobs, _j(slots),
                                  _j(mask), _j(R_COV), use_pallas=False, return_nis=True, **jf)
    gs, gn = fused_frame_update(tstate, _t(bmat), _t(vtf), tobs, _t(slots), _t(mask),
                                _t(R_COV), return_nis=True)
    np.testing.assert_allclose(gs.x.numpy(), np.asarray(rs.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gs.p.numpy(), np.asarray(rs.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(gn), float(rn), rtol=1e-3, atol=1e-5)
    assert fused_frame_update(tstate, _t(bmat), _t(vtf), tobs, _t(slots), _t(mask),
                              _t(R_COV)).p.shape == tstate.p.shape


# ----------------------------------------------------- augmentation


@pytest.mark.parametrize("case", ["some_new", "none_new", "empty_map", "overflow_unpadded"])
def test_augment_matches_reference(case):
    # overflow_unpadded: capacity 12 with D = 27 unpadded, 9 slots taken
    # and 5 new measurements: 3 fit, and the last slot's rows are the last
    # rows of P; the other 2 are dropped.
    cap, pad, n_act, nz = {"some_new": (40, 128, 17, 8), "none_new": (40, 128, 17, 8),
                           "empty_map": (40, 0, 0, 8), "overflow_unpadded": (12, 0, 9, 6)}[case]
    rng = np.random.default_rng(len(case))
    d = 3 + 2 * cap if not pad else ((3 + 2 * cap + pad - 1) // pad) * pad
    na = 3 + 2 * n_act
    a = rng.normal(size=(na, na)).astype(np.float32) * 0.1
    p = np.zeros((d, d), np.float32)
    p[:na, :na] = a @ a.T + np.eye(na, dtype=np.float32) * 0.3
    x = np.zeros((d,), np.float32)
    x[:3] = [5.0, -3.0, 0.4]
    x[3:na] = rng.uniform(-200, 200, size=(na - 3,)).astype(np.float32)
    n_ids = 60
    table = np.full(n_ids, -1, np.int64)
    table[rng.choice(n_ids, size=n_act, replace=False)] = np.arange(n_act)
    ids = np.sort(rng.choice(np.flatnonzero(table < 0), size=nz, replace=False))
    z = np.stack([rng.uniform(5, 80, nz), rng.uniform(-1.5, 1.5, nz)], -1).astype(np.float32)
    mask = np.ones(nz, bool)
    mask[1] = False
    new = mask.copy()
    if case == "none_new":
        new[:] = False
    elif case == "some_new":
        new[[0, 5]] = False
    jstate, tstate = _pair(x, p, n_act, table)
    jobs, tobs = _obs_pair(z, ids, mask)
    ref = jekf.augment(jstate, jobs, _j(new), _j(R_COV))
    got = augment(tstate, tobs, _t(new), _t(R_COV))
    assert got.x.shape == (d,) and got.p.shape == (d, d)
    assert int(got.n_active) == int(ref.n_active) == min(cap, n_act + int(new.sum()))
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-6, atol=1e-6)
    if case == "overflow_unpadded":
        assert d == 27 and got.p[-2:, :3].abs().sum() > 0     # slot 11 is P's last rows
    if case == "none_new":
        np.testing.assert_array_equal(got.p.numpy(), p)
        np.testing.assert_array_equal(got.x.numpy(), x)


# ------------------------------------------------------- the whole slice


def _run_both(kw, n_steps, seed):
    cfg, jcfg = SlamConfig(**kw), JSlamConfig(**kw)
    jworld = j_default_world()
    world = default_world(device="cpu")
    roll = precompute_rollout(world, cfg, n_steps)
    jroll = tuple(tuple(jnp.asarray(a.numpy()) for a in part) for part in roll)
    key = jax.random.PRNGKey(seed)
    jstate, jouts = j_run(jworld, jcfg, key, n_steps=n_steps, precomputed=jroll)
    # The reference draws its noise inside _run_precomp (runner/loop.py:292-294).
    n_frames = n_steps // cfg.observe_interval
    k_ctrl, k_obs = jax.random.split(key)
    ctrl = np.array(jax.random.normal(k_ctrl, (n_frames, cfg.observe_interval, 2), jnp.float32))
    obsn = np.array(jax.random.normal(k_obs, (n_frames, roll[1][0].shape[1], 2), jnp.float32))
    state, outs = run_ekf_slam_precomputed(world, cfg, None, n_steps, None, roll,
                                           ctrl_noise=_t(ctrl), obs_noise=_t(obsn))
    return (jstate, jouts), (state, outs)


def test_gated_slice_matches_reference():
    # The 30-landmark valet world from an empty map: gated association,
    # augmentation on, 1,200 steps = 200 frames.
    (jstate, jouts), (state, outs) = _run_both(
        dict(max_landmarks=30, max_obs=16, switch_association_known=False), 1200, 3)
    na = outs.n_active.numpy()
    np.testing.assert_array_equal(na, np.asarray(jouts.n_active))
    assert na[0] > 0 and na[-1] > na[0]          # the map grows during the run
    np.testing.assert_array_equal(state.table.numpy(), np.asarray(jstate.table))
    np.testing.assert_allclose(outs.x_est.numpy(), np.asarray(jouts.x_est), rtol=0, atol=5e-3)
    np.testing.assert_allclose(state.x.numpy()[:3], np.asarray(jstate.x)[:3], rtol=0, atol=5e-3)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), rtol=0, atol=0.1)
    jp = np.asarray(jstate.p)
    scale = np.sqrt(np.outer(np.diag(jp), np.diag(jp))) + 1e-6
    assert (np.abs(state.p.numpy() - jp) / scale).max() < 1e-2


def test_n_active_is_recorded_per_frame():
    # Known association with augmentation from an empty map: the map grows
    # frame by frame, and outs.n_active is the size after each step's frame,
    # as the reference records it (not the final size over every step).
    (jstate, jouts), (state, outs) = _run_both(dict(max_landmarks=30, max_obs=16), 600, 4)
    na = outs.n_active.numpy()
    np.testing.assert_array_equal(na, np.asarray(jouts.n_active))
    assert len(np.unique(na)) > 2 and na[-1] == int(state.n_active)
    np.testing.assert_array_equal(state.table.numpy(), np.asarray(jstate.table))


def test_config2_world_matches_reference():
    # The committed landmarks are random_world(PRNGKey(7), 500) exactly, and
    # the tour is the default waypoints (benchmarks/bench_gated.py:46).
    ref = random_world(jax.random.PRNGKey(7), 500)
    lm = np.load(_CONFIG2_LANDMARKS)
    assert lm.dtype == np.float32 and lm.shape == (500, 2)
    assert os.path.getsize(_CONFIG2_LANDMARKS) < 8192
    np.testing.assert_array_equal(lm, np.asarray(ref.landmarks))
    world = config2_world(device="cpu")
    np.testing.assert_array_equal(world.landmarks.numpy(), lm)
    np.testing.assert_array_equal(world.waypoints.numpy(), np.asarray(j_default_world().waypoints))
