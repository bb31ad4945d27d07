"""Port parity for the sharded runtime (conan_slam_tpu_torch.parallel): each
of tests/test_parallel.py's checks at 2 and 4 gloo ranks on the CPU
(``parallel.launch.RankPool``, one pool of each size for the module),
against the JAX function on a mesh of as many of the conftest's virtual
devices, on the same numpy inputs; then the slice as a whole: the dry run,
the audit's bytes against the reference's HLO, the DCN smoke.

The ranks run in their own processes and import no JAX; the JAX side runs
here, and numpy arrays go between them.  Every replicated output (the
NIS, the pose trace, the broadcast pose) must be the same bits on every
rank.  Tolerances, each with its reason:
  * the sharded EKF functions against the JAX ones: both are re-bracketed
    float32 sums of the same algebra, so test_parallel.py's own bounds
    against the single-device function hold between them (x 1e-4, P 1e-3;
    the observation update's x 2e-3, as there; the frame's NIS rtol 1e-4
    and pose trace 1e-5);
  * the particle functions: tests/test_torch_pf.py's bounds of the port's
    single-device PF against the JAX one (rtol 1e-5; pose 1e-4 m, feature
    means 2e-3 m, covariances 1e-4 of their largest entry, log weights
    1e-3), and against the port's own single-device step on the same draws
    rtol 1e-6 (test_parallel.py's sharded-against-single-device bound: the
    same per-particle code, only the particle-axis sums reassociated).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.filters import pf as jpf
from conan_slam_tpu.filters.common import CompactObs as JObs
from conan_slam_tpu.models import sensor as jsensor
from conan_slam_tpu.parallel import dist_ekf as jdist_ekf
from conan_slam_tpu.parallel import dist_fastframe as jdist_ff
from conan_slam_tpu.parallel import dist_pf as jdist_pf
from conan_slam_tpu.parallel.mesh import PARTICLE_AXIS, STATE_AXIS
from conan_slam_tpu.parallel.mesh import make_mesh as jmake_mesh
from conan_slam_tpu_torch.filters import pf as tpf
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.parallel import dist_ekf, dist_fastframe, dist_pf, launch, tasks

torch.set_num_threads(2)

RANKS = [2, 4]
Q = np.diag([0.18, 0.0006]).astype(np.float32)
R = np.diag([0.08, 0.0024]).astype(np.float32)


@pytest.fixture(scope="module")
def pools():
    made = {}

    def get(n):
        if n not in made or made[n].closed:
            made[n] = launch.RankPool(n, "cpu", timeout=300.0)
        return made[n]

    yield get
    for p in made.values():
        p.close()


def _jmesh(n, axis=STATE_AXIS):
    return jmake_mesh({axis: n}, devices=jax.devices()[:n])


def _rows(results, key="x"):
    return np.concatenate([r[key] for r in results])


def _same_bits(results, get):
    """Every rank's replicated value is rank 0's, bit for bit."""
    ref = np.ascontiguousarray(get(results[0]))
    for r in results[1:]:
        assert np.ascontiguousarray(get(r)).tobytes() == ref.tobytes()


def _random_system(rng, d, m):
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.1
    p = a @ a.T + np.eye(d, dtype=np.float32)
    x = rng.normal(size=(d,)).astype(np.float32)
    h = rng.normal(size=(m, d)).astype(np.float32)
    r = np.eye(m, dtype=np.float32) * 0.05
    v = rng.normal(size=(m,)).astype(np.float32)
    return x, p, v, r, h


def _mapped_state(rng, cap, sigma_a=0.05, diag=0.1, pose=(0.0, 0.0, 0.0)):
    d = 3 + 2 * cap
    feats = rng.uniform(-500, 500, size=(cap, 2)).astype(np.float32)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = pose
    x0[3:] = feats.reshape(-1)
    a = rng.normal(size=(d, d)).astype(np.float32) * sigma_a
    return feats, x0, a @ a.T + np.eye(d, dtype=np.float32) * diag


@pytest.mark.parametrize("n", RANKS)
def test_sharded_cholesky_update_matches_reference(pools, n):
    rng = np.random.default_rng(0)
    d, m = 64, 6
    x, p, v, r, h = _random_system(rng, d, m)
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x), jnp.asarray(p))
    jx, jp = jax.jit(functools.partial(jdist_ekf.sharded_cholesky_update, mesh))(
        xs, ps, jnp.asarray(v), jnp.asarray(r), jnp.asarray(h))
    res = pools(n).run(tasks.state_steps, {"state": n}, x, p,
                       [(dist_ekf.sharded_cholesky_update, (v, r, h), {})])
    np.testing.assert_allclose(_rows(res), np.asarray(jx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_rows(res, "p"), np.asarray(jp), rtol=1e-3, atol=1e-3)
    # One psum of the (m, m) partial S, one all-gather of the (m, Dp) strip.
    assert [c[1] for c in res[0]["collectives"]] == ["psum", "all_gather"]


@pytest.mark.parametrize("n", RANKS)
def test_sharded_predict_and_heading_match_reference(pools, n):
    rng = np.random.default_rng(1)
    cap = 30                      # d = 63 -> padded 64
    d = 3 + 2 * cap
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.1
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.2
    x0 = rng.normal(size=(d,)).astype(np.float32)
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))

    @jax.jit
    def ref(xs, ps):
        xs, ps = jdist_ekf.sharded_predict(mesh, xs, ps, 80.0, 0.05, jnp.asarray(Q), 73.0, 0.01)
        return jdist_ekf.sharded_observe_heading(mesh, xs, ps, 0.3, 0.001)

    xs, ps = ref(xs, ps)
    res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_ekf.sharded_predict, (80.0, 0.05, Q, 73.0, 0.01), {}),
        (dist_ekf.sharded_observe_heading, (0.3, 0.001), {})])
    np.testing.assert_allclose(_rows(res), np.asarray(xs), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_rows(res, "p"), np.asarray(ps), rtol=1e-3, atol=1e-3)
    # The pose broadcasts and the P[:, 2] gather: 12 + 12 + 4 Dp bytes.
    assert [c[4] for c in res[0]["collectives"]] == [12, 12, 4 * 64]


@pytest.mark.parametrize("n", RANKS)
def test_sharded_observation_update_matches_reference(pools, n):
    rng = np.random.default_rng(2)
    cap = 30
    feats, x0, p0 = _mapped_state(rng, cap)
    zp, _, _ = jsensor.observe(jnp.asarray(x0[:3]), jnp.asarray(feats[:4]))
    z = (np.asarray(zp) + rng.normal(size=(4, 2)).astype(np.float32) * [0.3, 0.01]).astype(
        np.float32)
    slots = np.asarray([0, 1, 2, 0], np.int32)
    mask = np.asarray([True, True, True, False])
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    jx, jp = jax.jit(functools.partial(jdist_ekf.sharded_observation_update, mesh, capacity=cap))(
        xs, ps, jnp.asarray(z), jnp.asarray(slots), jnp.asarray(mask), jnp.asarray(R))
    res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_ekf.sharded_observation_update, (z, slots.astype(np.int64), mask, R),
         {"capacity": cap})])
    np.testing.assert_allclose(_rows(res), np.asarray(jx), rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(_rows(res, "p"), np.asarray(jp), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_augment_matches_reference(pools, n):
    rng = np.random.default_rng(9)
    cap = 30
    d = 3 + 2 * cap
    n_act = 4
    feats = rng.uniform(-300, 300, size=(n_act, 2)).astype(np.float32)
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [2.0, -1.0, 0.3]
    x0[3:3 + 2 * n_act] = feats.reshape(-1)
    na = 3 + 2 * n_act
    a = rng.normal(size=(na, na)).astype(np.float32) * 0.1
    p0 = np.zeros((d, d), np.float32)
    p0[:na, :na] = a @ a.T + np.eye(na, dtype=np.float32) * 0.2
    table = np.full((40,), -1, np.int64)
    table[:n_act] = np.arange(n_act)
    z = np.asarray([[120.0, 0.5], [60.0, -0.9], [0.0, 0.0]], np.float32)
    ids = np.asarray([10, 11, -1], np.int64)
    new_mask = np.asarray([True, True, False])
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    jx, jp, jn, jt = jax.jit(functools.partial(jdist_ekf.sharded_augment, mesh))(
        xs, ps, jnp.asarray(z), jnp.asarray(ids, jnp.int32), jnp.asarray(new_mask),
        jnp.asarray(R), jnp.int32(n_act), jnp.asarray(table, jnp.int32))
    res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_ekf.sharded_augment, (z, ids, new_mask, R, np.asarray(n_act), table), {})])
    np.testing.assert_allclose(_rows(res), np.asarray(jx), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_rows(res, "p"), np.asarray(jp), rtol=1e-3, atol=1e-3)
    for r in res:
        n_new, table_new = r["extras"][0]
        assert int(n_new) == int(jn)
        np.testing.assert_array_equal(table_new, np.asarray(jt))


@pytest.mark.parametrize("n_act", [0, 26, 30])
def test_sharded_augment_window_at_the_edges(pools, n_act):
    # The write window (sharded_augment's W = 2 NZ rows) at an empty map,
    # across the shard boundary of 4 ranks (rows 16, 32, 48) and at the
    # padded state's last slot: against the reference, the map full at
    # (Dp - 3) // 2 = 30 slots dropping what does not fit.
    rng = np.random.default_rng(12 + n_act)
    n, cap, nz = 4, 30, 3
    d = 3 + 2 * cap
    x0 = np.zeros((d,), np.float32)
    x0[:3] = [2.0, -1.0, 0.3]
    x0[3:3 + 2 * n_act] = rng.uniform(-300, 300, size=2 * n_act).astype(np.float32)
    a = rng.normal(size=(d, d)).astype(np.float32) * 0.1
    p0 = a @ a.T + np.eye(d, dtype=np.float32) * 0.2
    table = np.full((40,), -1, np.int64)
    table[:n_act] = np.arange(n_act)
    z = np.asarray([[120.0, 0.5], [60.0, -0.9], [80.0, 1.2]], np.float32)
    ids = np.asarray([33, 35, 37], np.int64)
    new_mask = np.asarray([True, False, True])
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    jx, jp, jn, jt = jax.jit(functools.partial(jdist_ekf.sharded_augment, mesh))(
        xs, ps, jnp.asarray(z), jnp.asarray(ids, jnp.int32), jnp.asarray(new_mask),
        jnp.asarray(R), jnp.int32(n_act), jnp.asarray(table, jnp.int32))
    res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_ekf.sharded_augment, (z, ids, new_mask, R, np.asarray(n_act), table), {})])
    np.testing.assert_allclose(_rows(res), np.asarray(jx), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_rows(res, "p"), np.asarray(jp), rtol=1e-3, atol=1e-3)
    assert int(res[0]["extras"][0][0]) == int(jn) == min(n_act + 2, cap)
    np.testing.assert_array_equal(res[0]["extras"][0][1], np.asarray(jt))


def _frame_problem(seed):
    rng = np.random.default_rng(seed)
    cap = 30
    feats, x0, p0 = _mapped_state(rng, cap, pose=(5.0, -2.0, 0.4))
    s_steps = 6
    vns = (80.0 + rng.normal(size=(s_steps,))).astype(np.float32)
    swans = (rng.normal(size=(s_steps,)) * 0.03).astype(np.float32)
    phis = (0.4 + np.cumsum(rng.normal(size=(s_steps,)) * 0.005)).astype(np.float32)
    nz = 5
    zp, _, _ = jsensor.observe(jnp.asarray(x0[:3]), jnp.asarray(feats[:nz]))
    z = (np.asarray(zp) + rng.normal(size=(nz, 2)) * [0.3, 0.01]).astype(np.float32)
    return cap, x0, p0, (vns, swans, phis), z


def _frame_args(ctrl, act, z, slots, mask):
    return (*ctrl, act, Q, z, slots, mask, R, 73.0, 0.01, 0.000175, True)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_frame_update_matches_reference(pools, n):
    # The one-function distributed frame against the reference's sharded
    # frame (and, as test_parallel.py does it, the single-device fused frame
    # through the reference's jnp route); an all-inactive, all-masked frame
    # is an exact no-op.
    from conan_slam_tpu.filters.ekf.fastframe import frame_factors
    from conan_slam_tpu.filters.ekf.update import fused_frame_update

    cap, x0, p0, ctrl, z = _frame_problem(4)
    slots = np.asarray([0, 1, 2, 3, 0], np.int64)
    mask = np.asarray([True, True, True, True, False])
    act = np.ones((6,), bool)
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in _frame_args(ctrl, act, z, slots.astype(np.int32), mask)]
    jx, jp, jnis, jpt = jax.jit(lambda xs, ps: jdist_ff.sharded_frame_update(mesh, xs, ps, *jargs))(
        xs, ps)
    state = jekf.init_state(cap, 40)._replace(x=jnp.asarray(x0), p=jnp.asarray(p0),
                                              n_active=jnp.int32(cap))
    st1, pt_ref, vmat, bmat = frame_factors(state, *jargs[:5], 73.0, 0.01, 0.000175, True)
    obs = JObs(z=jnp.asarray(z), ids=jnp.arange(5, dtype=jnp.int32), mask=jnp.asarray(mask))
    ref, nis_ref = fused_frame_update(st1, vmat, bmat, obs, jnp.asarray(slots, jnp.int32),
                                      jnp.asarray(mask), jnp.asarray(R), use_pallas=False,
                                      return_nis=True)
    off = (np.zeros((6,), bool), np.zeros((5,), bool))
    res = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_fastframe.sharded_frame_update, _frame_args(ctrl, act, z, slots, mask), {})])
    noop = pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_fastframe.sharded_frame_update, _frame_args(ctrl, off[0], z, slots, off[1]), {})])
    d = x0.shape[0]
    for want_x, want_p, want_nis, want_pt in ((jx, jp, jnis, jpt),
                                              (ref.x, ref.p, nis_ref, pt_ref)):
        np.testing.assert_allclose(_rows(res)[:d], np.asarray(want_x)[:d], rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_rows(res, "p")[:d, :d], np.asarray(want_p)[:d, :d],
                                   rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(float(res[0]["extras"][0][0]), float(want_nis), rtol=1e-4)
        np.testing.assert_allclose(res[0]["extras"][0][1], np.asarray(want_pt), rtol=1e-5,
                                   atol=1e-5)
    _same_bits(res, lambda r: r["extras"][0][0])
    _same_bits(res, lambda r: r["extras"][0][1])
    # Exactly three collective rounds: the [x, P e2] gather, the strip's
    # psum, the gain strip's gather.
    assert [c[1] for c in res[0]["collectives"]] == ["all_gather", "psum", "all_gather"]
    xs_pad = np.zeros((_rows(res).shape[0],), np.float32)
    xs_pad[:d] = x0
    np.testing.assert_allclose(_rows(noop), xs_pad, atol=1e-6)
    p_pad = np.zeros((xs_pad.shape[0],) * 2, np.float32)
    p_pad[:d, :d] = p0
    np.testing.assert_array_equal(_rows(noop, "p"), p_pad)
    assert float(noop[0]["extras"][0][0]) == 0.0


@pytest.mark.parametrize("n", RANKS)
def test_sharded_frame_update_i16_gain_wire(pools, n):
    # gain_wire="i16" against the reference's i16 frame and within the
    # quantisation bound of the exact f32 wire, the downdate symmetric from
    # the shared decode; R3 mirrored: the mean correction uses the exact
    # local strip, so x equals the f32 wire's bit for bit, while P moves
    # by the decoded strip.
    cap, x0, p0, ctrl, z = _frame_problem(9)
    slots = np.arange(5, dtype=np.int64)
    mask = np.ones((5,), bool)
    act = np.ones((6,), bool)
    args = _frame_args(ctrl, act, z, slots, mask)
    mesh = _jmesh(n)
    xs, ps = jdist_ekf.shard_state(mesh, jnp.asarray(x0), jnp.asarray(p0))
    jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a
             for a in _frame_args(ctrl, act, z, slots.astype(np.int32), mask)]
    jq = jax.jit(lambda xs, ps: jdist_ff.sharded_frame_update(mesh, xs, ps, *jargs,
                                                              gain_wire="i16"))(xs, ps)
    f32, i16 = (pools(n).run(tasks.state_steps, {"state": n}, x0, p0, [
        (dist_fastframe.sharded_frame_update, args, {"gain_wire": w})]) for w in ("f32", "i16"))
    d = x0.shape[0]
    p_f, p_q = _rows(f32, "p")[:d, :d], _rows(i16, "p")[:d, :d]
    np.testing.assert_allclose(_rows(i16)[:d], np.asarray(jq[0])[:d], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(p_q, np.asarray(jq[1])[:d, :d], rtol=1e-3, atol=1e-4)
    assert np.abs(p_q - p_f).max() < 1e-3 * np.abs(p_f).max()
    assert np.abs(p_q - p_f).max() > 0.0                        # the downdate is the decoded one
    np.testing.assert_array_equal(_rows(i16), _rows(f32))        # R3: the mean is the exact one
    assert float(i16[0]["extras"][0][0]) == float(f32[0]["extras"][0][0])
    asym_q, asym_f = np.abs(p_q - p_q.T).max(), np.abs(p_f - p_f.T).max()
    assert asym_q <= asym_f + 1e-6, (asym_q, asym_f)
    # The wire: a pmax of the (m,) row scales, then the int16 strip (2 bytes
    # an element, half the f32 strip's logical bytes).
    q_rows = [c for c in i16[0]["collectives"] if c[3] == "int16"]
    f_rows = [c for c in f32[0]["collectives"] if c[2] == (10, 64 // n)]
    assert len(q_rows) == 1 and 2 * q_rows[0][4] == f_rows[0][4]


def _ensemble(rng, n, k, num_ids, **leaves):
    ens = tpf.init_ensemble(n, k, num_ids, device="cpu")
    ens = ens._replace(**{name: torch.as_tensor(v) for name, v in leaves.items()})
    return tuple(t.numpy() for t in ens)


def _jens(arrays):
    names = jpf.ParticleEnsemble._fields
    return jpf.ParticleEnsemble(**{
        k: jnp.asarray(v, jnp.int32 if k in ("n_active", "table") else None)
        for k, v in zip(names, arrays)})


def _port_ens(results):
    """The ensemble from every rank's block, in rank order."""
    blocks = [r["ens"] for r in results]
    split = ("log_w", "pose", "pose_cov", "xf", "pf")
    return {k: np.concatenate([getattr(b, k) for b in blocks]) if k in split
            else getattr(blocks[0], k) for k in tpf.ParticleEnsemble._fields}


def _ens_np(arrays):
    return tpf.ParticleEnsemble(*(np.asarray(a) for a in arrays))


@pytest.mark.parametrize("n", RANKS)
def test_sharded_pf_pipeline_matches_reference(pools, n):
    # Per-particle predict and heading on each rank's block, then the sharded
    # resample, against the reference's GSPMD-sharded single-device step.
    rng = np.random.default_rng(3)
    n_p, k = 64, 4
    arrays = _ensemble(rng, n_p, k, 8, pose=rng.normal(size=(n_p, 3)).astype(np.float32),
                       log_w=rng.normal(size=(n_p,)).astype(np.float32))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def step(e, key):
        e = jpf.predict(e, 80.0, 0.05, jnp.asarray(Q), 73.0, 0.01)
        e = jpf.observe_heading(e, 0.1, 0.001)
        return jpf.resample(e, key, num_effective=float(n_p), enabled=True)

    ref = step(jdist_pf.shard_ensemble(_jmesh(n, PARTICLE_AXIS), _jens(arrays)), key)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[0], (n_p,), jnp.float32))
    v, swa = np.asarray(80.0, np.float32), np.asarray(0.05, np.float32)
    res = pools(n).run(tasks.ensemble_steps, {"particles": n}, _ens_np(arrays), [
        (tpf.predict, (v, swa, Q, 73.0, 0.01), {}, False),
        (tpf.observe_heading, (0.1, 0.001), {}, False),
        (dist_pf.sharded_resample, (u, float(n_p)), {}, True)])
    got = _port_ens(res)
    np.testing.assert_allclose(got["pose"], np.asarray(ref.pose), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got["pose_cov"], np.asarray(ref.pose_cov), rtol=1e-5,
                               atol=1e-4 * np.abs(np.asarray(ref.pose_cov)).max())
    np.testing.assert_allclose(got["log_w"], np.asarray(ref.log_w), rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("kind", ["stratified", "systematic"])
def test_sharded_resample_matches_reference(pools, n, kind):
    # Same uniforms => same strata => the same particles selected as the
    # reference's ring resample and the port's single-device resample; a
    # high-Neff ensemble is left as it is.
    rng = np.random.default_rng(7)
    n_p, k = 64, 4
    arrays = _ensemble(rng, n_p, k, 8, pose=rng.normal(size=(n_p, 3)).astype(np.float32),
                       log_w=(rng.normal(size=(n_p,)) * 2.0).astype(np.float32),
                       xf=rng.normal(size=(n_p, k, 2)).astype(np.float32))
    key = jax.random.PRNGKey(5)
    mesh = _jmesh(n, PARTICLE_AXIS)
    ref = jax.jit(lambda e: jdist_pf.sharded_resample(mesh, e, key, num_effective=float(n_p),
                                                      kind=kind))(
        jdist_pf.shard_ensemble(mesh, _jens(arrays)))
    shape = () if kind == "systematic" else (n_p,)
    u = np.asarray(jax.random.uniform(jax.random.split(key)[0], shape, jnp.float32))
    res = pools(n).run(tasks.ensemble_steps, {"particles": n}, _ens_np(arrays), [
        (dist_pf.sharded_resample, (u, float(n_p), kind), {}, True)])
    got = _port_ens(res)
    single = tpf.resample(tpf.ParticleEnsemble(*(torch.as_tensor(a) for a in arrays)),
                          torch.as_tensor(u), None, float(n_p), True, kind=kind)
    for name in ("pose", "pose_cov", "xf", "pf", "log_w"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(ref, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{kind}:{name}")
        np.testing.assert_array_equal(got[name], getattr(single, name).numpy(),
                                      err_msg=f"{kind}:{name}")
    flat = list(arrays)
    flat[0] = np.zeros((n_p,), np.float32)
    res = pools(n).run(tasks.ensemble_steps, {"particles": n}, _ens_np(flat), [
        (dist_pf.sharded_resample, (u, 0.5 * n_p, kind), {}, True)])
    np.testing.assert_array_equal(_port_ens(res)["pose"], flat[1])


def _reference_step_draws(key, n_p, kind, roughening):
    """The reference observation step's draws from its key (filters/pf/
    __init__.py:58, resample.py:62): the proposal's and the prior's
    per-particle normals, the strata, the roughening's normals."""
    k_prop, k_res, k_samp = jax.random.split(key, 3)
    k_idx, k_rough = jax.random.split(k_res)

    def per_particle(k):
        return np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (3,), jnp.float32))(
            jax.random.split(k, n_p)))

    shape = () if kind == "systematic" else (n_p,)
    return tpf.ObservationDraws(
        prop=per_particle(k_prop),
        res_u=np.asarray(jax.random.uniform(k_idx, shape, jnp.float32)),
        rough=np.asarray(jax.random.normal(k_rough, (n_p, 3), jnp.float32)) if roughening else None,
        samp=per_particle(k_samp))


_PF_STEPS = [
    dict(num_effective=48.0, sample_proposal_on=True, resample_on=True),
    dict(num_effective=48.0, sample_proposal_on=True, resample_on=True,
         resample_kind="systematic", roughening=0.02),
    dict(num_effective=48.0, sample_proposal_on=False, resample_on=True),
]


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("kw", _PF_STEPS, ids=["stratified", "systematic-rough", "no-proposal"])
def test_sharded_pf_observation_step_matches_reference(pools, n, kw):
    # The whole observation block (proposal, feature updates, sharded resample,
    # founding, the table) on each rank's particles against the reference's
    # sharded step on the same draws, and against the port's single-device
    # step.
    rng = np.random.default_rng(11)
    n_p, cap = 64, 8
    feats = rng.uniform(-200, 200, size=(4, 2)).astype(np.float32)
    xf = np.zeros((n_p, cap, 2), np.float32)
    xf[:, :4] = feats + rng.normal(size=(n_p, 4, 2)).astype(np.float32) * 0.5
    pfc = np.broadcast_to(np.eye(2, dtype=np.float32) * 0.4, (n_p, cap, 2, 2)).copy()
    table = np.full((16,), -1, np.int64)
    table[:4] = np.arange(4)
    arrays = _ensemble(
        rng, n_p, cap, 16,
        pose=(rng.normal(size=(n_p, 3)) * [2.0, 2.0, 0.2]).astype(np.float32),
        pose_cov=np.broadcast_to(np.eye(3, dtype=np.float32) * 0.01, (n_p, 3, 3)).copy(),
        log_w=rng.normal(size=(n_p,)).astype(np.float32), xf=xf, pf=pfc,
        n_active=np.asarray(4), table=table)
    zp, _, _ = jsensor.observe(jnp.zeros(3), jnp.asarray(feats))
    z = np.zeros((6, 2), np.float32)
    z[:4] = np.asarray(zp) + rng.normal(size=(4, 2)).astype(np.float32) * [0.1, 0.005]
    z[4] = [150.0, 0.7]                       # founds a new landmark (id 9)
    ids = np.asarray([0, 1, 2, 3, 9, -1], np.int64)
    mask = np.asarray([True] * 5 + [False])
    key = jax.random.PRNGKey(3)
    mesh = _jmesh(n, PARTICLE_AXIS)
    jobs = JObs(z=jnp.asarray(z), ids=jnp.asarray(ids, jnp.int32), mask=jnp.asarray(mask))
    ref = jax.jit(lambda e: jdist_pf.sharded_observation_step(mesh, e, jobs, jnp.asarray(R), key,
                                                              **kw))(
        jdist_pf.shard_ensemble(mesh, _jens(arrays)))
    draws = _reference_step_draws(key, n_p, kw.get("resample_kind", "stratified"),
                                  kw.get("roughening", 0.0))
    obs = CompactObs(z=z, ids=ids, mask=mask)
    res = pools(n).run(tasks.ensemble_steps, {"particles": n}, _ens_np(arrays), [
        (dist_pf.sharded_observation_step, (obs, R, draws), kw, True)])
    got = _port_ens(res)
    single = tpf.observation_step(
        tpf.ParticleEnsemble(*(torch.as_tensor(a) for a in arrays)),
        CompactObs(*(torch.as_tensor(a) for a in obs)), torch.as_tensor(R),
        tpf.ObservationDraws(*(None if a is None else torch.as_tensor(a) for a in draws)), **kw)
    scale = {"pose": 1e-4, "xf": 2e-3, "log_w": 1e-3}
    for name in ("pose", "pose_cov", "xf", "pf", "log_w"):
        want = np.asarray(getattr(ref, name))
        atol = scale.get(name, 1e-4 * np.abs(want).max())
        np.testing.assert_allclose(got[name], want, rtol=1e-5, atol=atol, err_msg=f"{kw}:{name}")
        np.testing.assert_allclose(got[name], getattr(single, name).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{kw}:{name}")
    assert int(got["n_active"]) == int(ref.n_active)
    np.testing.assert_array_equal(got["table"], np.asarray(ref.table))
    _same_bits(res, lambda r: r["ens"].table)
    _same_bits(res, lambda r: r["ens"].n_active)


def test_build_is_safe_from_two_processes(tmp_path):
    # Two processes build one library at once into one build directory (as
    # the ranks of the sharded runtime do on one card): the second waits on
    # the build directory's lock and finds the library current, so the
    # sources compile once.  A stand-in nvcc logs each compile and takes a
    # second over it.
    import subprocess
    import sys
    import textwrap

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu"):
        (csrc / name).write_text("// a source\n")
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys, time
        out = sys.argv[sys.argv.index("-o") + 1]
        if "-c" in sys.argv:
            with open({str(log)!r}, "a") as f:
                f.write("compile\\n")
            time.sleep(1.0)
        open(out, "w").write("built")
        """))
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    code = textwrap.dedent(f"""\
        import os, sys, time
        from pathlib import Path
        from conan_slam_tpu_torch.ops import cuda
        me = sys.argv[1]
        Path({str(tmp_path)!r}, "ready-" + me).touch()
        while not all(Path({str(tmp_path)!r}, "ready-" + k).exists() for k in "01"):
            time.sleep(0.01)
        lib, secs, _ = cuda.build(csrc=Path({str(csrc)!r}), build_dir=Path({str(build_dir)!r}),
                                  nvcc={str(nvcc)!r})
        print(lib.name, secs > 0)
        """)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i)], stdout=subprocess.PIPE,
                              text=True, cwd=str(__import__("pathlib").Path(__file__).parent.parent))
             for i in range(2)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert log.read_text().count("compile") == 2            # two sources, compiled once
    assert sorted(o[1] for o in outs) == ["False", "True"]   # one built, one found it current
    assert (build_dir / "libconan_slam_kernels.so").read_text() == "built"
    assert (build_dir / ".lock").exists()


@pytest.mark.parametrize("n", RANKS)
def test_collective_routes_agree(pools, n):
    # Every collective on gloo's native CPU route and on the zero-filled
    # all-reduce route that gloo takes for CUDA tensors on one card: the
    # same values on both, those of numpy's definitions, int16 (the i16
    # wire's element, carried as an int32 bit view) exact.
    res = {route: pools(n).run(tasks.collectives, {"state": n}, route)
           for route in (None, "all_reduce")}
    f = [np.arange(6, dtype=np.float32).reshape(2, 3) * (i + 1) - 2.5 for i in range(n)]
    q = [(np.arange(8, dtype=np.int16) * (i + 1) - 3).reshape(2, 4) for i in range(n)]
    want = {"psum": functools.reduce(np.add, f), "pmax": np.max(f, 0), "pmin": np.min(f, 0),
            "gather0": np.concatenate(f), "gather1": np.concatenate(f, 1),
            "gather_i16": np.concatenate(q, 1)}
    for route, ranks in res.items():
        for i, r in enumerate(ranks):
            assert r["index"] == i
            for key, w in want.items():
                np.testing.assert_array_equal(r[key], w, err_msg=f"{route}:{key}")
                assert r[key].dtype == w.dtype
            np.testing.assert_array_equal(r["shift"], f[(i - 1) % n])
            np.testing.assert_array_equal(r["shift_i16"], q[(i - 1) % n])
