"""Port parity for the per-step EKF API (mirrors tests/test_ekf.py): the
Cholesky and Joseph updates, predict, the heading observation, the batch
operator, the batch and sequential updates, observation_step (known and
gated, with the frames where the reference's ``lax.cond`` skips the update
or the augmentation), the metrics, and ekf_sim_step with its carry
crossing from the JAX package.

The same numpy inputs go through conan_slam_tpu (JAX, CPU) and
conan_slam_tpu_torch (PyTorch, CPU).  Tolerances, each with its reason:
  * the updates on unit-scale states: means and covariances rtol 1e-5,
    atol 1e-6 (the same fp32 algebra in two libraries' op orders;
    Cholesky and triangular solves of a small S);
  * observation_step and ekf_sim_step on the ~50 m map: means atol 1e-4 m,
    covariances rtol 1e-4 / atol 1e-5 (new features 150-200 m out carry
    variances of ~50 m^2, rounded relative to their size), NIS rtol 1e-4;
    slots, masks, map size and table equal; ekf_sim_step's final map means
    atol 1e-3 m (a few ulps of its ~300 m coordinates after 36 steps);
  * metrics: rtol 1e-5 (float32 reductions over 400 steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.filters.common import CompactObs as JCompactObs
from conan_slam_tpu.filters.ekf.observe import assemble_operator as j_assemble_operator
from conan_slam_tpu.ops import cholesky_update as jchol
from conan_slam_tpu.runner import loop as jloop
from conan_slam_tpu.runner import metrics as jmetrics
from conan_slam_tpu.sim.world import World as JWorld
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters import ekf
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.observe import assemble_operator
from conan_slam_tpu_torch.ops import cholesky_update as tchol
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.sim.world import world_from_numpy

torch.set_num_threads(2)

K, N_IDS, N_MAPPED = 10, 14, 6     # capacity, landmark ids, ids mapped at the start


def _t(a):
    return torch.as_tensor(np.array(a))


def _spd(rng, d, scale=0.05):
    a = rng.normal(size=(d, d + 2)).astype(np.float32)
    return (a @ a.T * scale / d + np.eye(d, dtype=np.float32) * 0.1).astype(np.float32)


def _map_state(seed):
    """A state of K slots with the first N_MAPPED of N_IDS landmarks mapped
    (within +-50 m), the rest far out (150-200 m, past any gate), and a
    dense SPD covariance: numpy (x, p, n_active, table) and the
    landmarks."""
    rng = np.random.default_rng(seed)
    near = rng.uniform(-50, 50, size=(N_MAPPED, 2))
    ang = rng.uniform(-1.2, 1.2, size=N_IDS - N_MAPPED)
    far = np.stack([np.cos(ang), np.sin(ang)], 1) * rng.uniform(150, 200, size=(N_IDS - N_MAPPED, 1))
    lm = np.concatenate([near, far]).astype(np.float32)
    d = 3 + 2 * K
    x = np.zeros(d, np.float32)
    x[:3] = [0.5, -0.3, 0.05]
    x[3:3 + 2 * N_MAPPED] = (near + rng.normal(size=near.shape) * 0.3).reshape(-1)
    p = _spd(rng, d)
    table = np.full(N_IDS, -1, np.int32)
    table[:N_MAPPED] = np.arange(N_MAPPED)
    return (x, p, np.int32(N_MAPPED), table), lm


def _obs(seed, lm, x, ids, nz=8):
    """A buffer of ``nz`` slots holding noisy returns of landmarks ``ids``
    from pose x[:3], in ascending id order, the rest masked."""
    rng = np.random.default_rng(seed + 1)
    ids = np.sort(np.asarray(ids, np.int32))
    d = lm[ids] - x[:2]
    z = np.zeros((nz, 2), np.float32)
    z[:len(ids), 0] = np.hypot(d[:, 0], d[:, 1]) + rng.normal(size=len(ids)) * 0.1
    z[:len(ids), 1] = np.arctan2(d[:, 1], d[:, 0]) - x[2] + rng.normal(size=len(ids)) * 0.01
    all_ids = np.full(nz, -1, np.int32)
    all_ids[:len(ids)] = ids
    return z, all_ids, all_ids >= 0


def _both_states(arrays):
    return (jekf.EKFState(*(jnp.asarray(a) for a in arrays)),
            ekf.state_from_numpy(*arrays, device="cpu"))


def _assert_state_close(got, ref, x_atol=1e-4, p_atol=1e-5):
    gx, gp, gn, gt = ekf.state_to_numpy(got)
    np.testing.assert_allclose(gx, np.asarray(ref.x), rtol=0, atol=x_atol)
    np.testing.assert_allclose(gp, np.asarray(ref.p), rtol=1e-4, atol=p_atol)
    assert gn == int(ref.n_active)
    np.testing.assert_array_equal(gt, np.asarray(ref.table))


def test_cholesky_and_joseph_updates_match_reference():
    rng = np.random.default_rng(1)
    d, m = 13, 4
    x = rng.normal(size=d).astype(np.float32)
    p = _spd(rng, d)
    h = rng.normal(size=(m, d)).astype(np.float32)
    h[2:] = 0.0                                  # two masked rows
    v = rng.normal(size=m).astype(np.float32) * 0.1
    v[2:] = 0.0
    r = np.eye(m, dtype=np.float32)
    r[:2, :2] = _spd(rng, 2, 0.01)
    ref = jchol.cholesky_update(*(jnp.asarray(a) for a in (x, p, v, r, h)), return_nis=True)
    got = tchol.cholesky_update(*(_t(a) for a in (x, p, v, r, h)), return_nis=True)
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-6)
    ref = jchol.joseph_update(*(jnp.asarray(a) for a in (x, p, v[:2], r[:2, :2], h[:2])))
    got = tchol.joseph_update(*(_t(a) for a in (x, p, v[:2], r[:2, :2], h[:2])))
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-6)
    ref = jchol.joseph_update_scalar(jnp.asarray(x), jnp.asarray(p), 0.03, 1e-4, idx=2)
    got = tchol.joseph_update_scalar(_t(x), _t(p), 0.03, 1e-4, idx=2)
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-6)
    # All rows masked: the update leaves x exactly and P up to sym().
    x2, p2 = tchol.cholesky_update(_t(x), _t(p), torch.zeros(m), torch.eye(m), torch.zeros(m, d))
    assert torch.equal(x2, _t(x)) and torch.equal(p2, 0.5 * (_t(p) + _t(p).T))


def test_predict_and_observe_heading_match_reference():
    arrays, _ = _map_state(2)
    jst, st = _both_states(arrays)
    q = np.diag([0.6**2, (2 * np.pi / 180) ** 2]).astype(np.float32)
    for k in range(5):
        v, swa = 83.33 + 0.1 * k, 0.05 - 0.03 * k
        jst = jekf.predict(jst, jnp.float32(v), jnp.float32(swa), jnp.asarray(q), 73.0, 0.01)
        st = ekf.predict(st, torch.tensor(v), torch.tensor(swa), _t(q), 73.0, 0.01)
        _assert_state_close(st, jst, 1e-5, 1e-5)
        phi = 0.05 + 0.002 * k
        jst = jekf.observe_heading(jst, jnp.float32(phi), 0.01 * np.pi / 180)
        st = ekf.observe_heading(st, torch.tensor(phi), 0.01 * np.pi / 180)
        _assert_state_close(st, jst, 1e-5, 1e-5)


def test_batch_operator_and_updates_match_reference():
    arrays, lm = _map_state(3)
    jst, st = _both_states(arrays)
    z, ids, mask = _obs(3, lm, arrays[0], [0, 2, 3, 5])
    slots = np.clip(ids, 0, None).astype(np.int64)
    r = np.diag([0.8**2, (2 * np.pi / 180) ** 2]).astype(np.float32)
    ref = j_assemble_operator(jst.pose, jst.features, jnp.asarray(z), jnp.asarray(slots), jnp.asarray(mask),
                              jnp.asarray(r), jst.x.shape[0])
    got = assemble_operator(st.pose, st.features, _t(z), _t(slots), _t(mask), _t(r), st.x.shape[0])
    for g, rf in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(rf), rtol=1e-5, atol=1e-6)
    jobs = JCompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids), mask=jnp.asarray(mask))
    obs = CompactObs(z=_t(z), ids=_t(ids).long(), mask=_t(mask))
    for fn, jfn in ((ekf.batch_update, jekf.batch_update),
                    (ekf.sequential_update, jekf.sequential_update),
                    (lambda *a, **k: ekf.update(*a, True, **k), lambda *a, **k: jekf.update(*a, True, **k)),
                    (lambda *a, **k: ekf.update(*a, False, **k), lambda *a, **k: jekf.update(*a, False, **k))):
        rs, rn = jfn(jst, jobs, jnp.asarray(slots), jnp.asarray(mask), jnp.asarray(r), return_nis=True)
        gs, gn = fn(st, obs, _t(slots), _t(mask), _t(r), return_nis=True)
        _assert_state_close(gs, rs)
        np.testing.assert_allclose(float(gn), float(rn), rtol=1e-4)


@pytest.mark.parametrize("known", [True, False], ids=["known", "gated"])
@pytest.mark.parametrize("batch", [True, False], ids=["batch", "sequential"])
@pytest.mark.parametrize("seen", ["mixed", "only_new", "only_known", "empty"])
def test_observation_step_matches_reference(known, batch, seen):
    # "only_new": no slot associates, so the reference's lax.cond skips the
    # update; "only_known": nothing new, so it skips the augmentation;
    # "empty": both.  The port runs both and must land on the same state.
    arrays, lm = _map_state(4)
    jst, st = _both_states(arrays)
    ids = {"mixed": [0, 1, 4, 7, 9, 12], "only_new": [7, 9, 12], "only_known": [0, 1, 4, 5],
           "empty": []}[seen]
    z, ids, mask = _obs(4, lm, arrays[0], ids)
    r = np.diag([0.8**2, (2 * np.pi / 180) ** 2]).astype(np.float32)
    kw = dict(association_known=known, batch=batch, gate_reject=50.0, gate_augment=1000.0,
              return_nis=True)
    rs, rn = jekf.observation_step(jst, JCompactObs(z=jnp.asarray(z), ids=jnp.asarray(ids),
                                                    mask=jnp.asarray(mask)), jnp.asarray(r), **kw)
    gs, gn = ekf.observation_step(st, CompactObs(z=_t(z), ids=_t(ids).long(), mask=_t(mask)),
                                  _t(r), **kw)
    _assert_state_close(gs, rs)
    np.testing.assert_allclose(float(gn), float(rn), rtol=1e-4, atol=1e-7)
    n_new = {"mixed": 3, "only_new": 3, "only_known": 0, "empty": 0}[seen]
    assert int(gs.n_active) == N_MAPPED + min(n_new, K - N_MAPPED)
    if seen in ("only_new", "empty"):
        assert float(gn) == 0.0


def test_metrics_match_reference():
    rng = np.random.default_rng(6)
    t = 400
    x_true = np.cumsum(rng.normal(size=(t, 3)), 0).astype(np.float32)
    x_est = (x_true + rng.normal(size=(t, 3)) * 0.2).astype(np.float32)
    valid = np.arange(t) < 350
    pairs = ((metrics.aligned_ate_rmse, jmetrics.aligned_ate_rmse, ()),
             (metrics.rpe_rmse, jmetrics.rpe_rmse, (10,)),
             (metrics.heading_rmse, jmetrics.heading_rmse, ()),
             (metrics.ate_rmse, jmetrics.ate_rmse, ()))
    for fn, jfn, extra in pairs:
        for v in (None, valid):
            got = fn(_t(x_true), _t(x_est), *extra, None if v is None else _t(v))
            ref = jfn(jnp.asarray(x_true), jnp.asarray(x_est), *extra,
                      None if v is None else jnp.asarray(v))
            np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)
    lm = rng.normal(size=(12, 2)).astype(np.float32) * 50
    feats = (lm[[3, 0, 7, 1, 9, 2, 5, 4]] + rng.normal(size=(8, 2)) * 0.5).astype(np.float32)
    table = np.full(12, -1, np.int32)
    table[[3, 0, 7, 1, 9, 2]] = np.arange(6)
    active = np.arange(8) < 6
    got = metrics.map_rmse(_t(lm), _t(feats), _t(active), _t(table).long())
    ref = jmetrics.map_rmse(jnp.asarray(lm), jnp.asarray(feats), jnp.asarray(active),
                            jnp.asarray(table))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


@pytest.mark.parametrize("known", [True, False], ids=["known", "gated"])
def test_ekf_sim_step_matches_reference(known):
    # 36 control steps of the per-step loop (six observation updates) from
    # a JAX carry moved across, with the reference's own draws: key,
    # k_ctrl, k_obs = split(carry.key, 3) each step (runner/loop.py:93).
    rng = np.random.default_rng(9)
    lm = rng.uniform(-300, 300, size=(12, 2)).astype(np.float32)
    wp = np.array([[0, 0], [400, 100], [500, -300]], np.float32)
    jworld = JWorld(landmarks=jnp.asarray(lm), waypoints=jnp.asarray(wp))
    world = world_from_numpy(lm, wp, device="cpu")
    jcfg = JSlamConfig(max_landmarks=8, switch_association_known=known)
    cfg = SlamConfig(max_landmarks=8, switch_association_known=known)
    jnoise, noise = jloop.make_noise(jcfg), loop.make_noise(cfg, device="cpu")
    jcarry = jloop.EKFSimCarry(
        steer=jloop.init_steer_state(1), x_true=jnp.zeros(3, jnp.float32),
        state=jekf.init_state(8, 12), step_in_frame=jnp.int32(0), key=jax.random.PRNGKey(9))
    carry = loop.carry_from_numpy(*(jax.tree_util.tree_map(np.asarray, tuple(jcarry)[:4])),
                                  device="cpu")
    jstep = jax.jit(lambda c: jloop.ekf_sim_step(c, None, cfg=jcfg, world=jworld, noise=jnoise))
    for _ in range(36):
        _, k_ctrl, k_obs = jax.random.split(jcarry.key, 3)
        draws = (_t(jax.random.normal(k_ctrl, (2,), jnp.float32)),
                 _t(jax.random.normal(k_obs, (12, 2), jnp.float32)))
        jcarry, jout = jstep(jcarry)
        carry, out = loop.ekf_sim_step(carry, draws, cfg=cfg, world=world, noise=noise)
        np.testing.assert_allclose(out.x_true.numpy(), np.asarray(jout.x_true), rtol=0, atol=1e-4)
        np.testing.assert_allclose(out.x_est.numpy(), np.asarray(jout.x_est), rtol=0, atol=1e-4)
        assert int(out.n_active) == int(jout.n_active) and bool(out.done) == bool(jout.done)
        np.testing.assert_allclose(float(out.consistency), float(jout.consistency), rtol=1e-4,
                                   atol=1e-7)
    assert int(jcarry.state.n_active) > 0
    # The carry crosses back in the JAX package's dtypes.
    steer, x_true, state, step_in_frame = loop.carry_to_numpy(carry)
    for got, ref in zip(steer, jcarry.steer):
        assert got.dtype == np.asarray(ref).dtype
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-5)
    _assert_state_close(carry.state, jcarry.state, x_atol=1e-3)
    assert step_in_frame == int(jcarry.step_in_frame)
