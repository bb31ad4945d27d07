"""Port parity for FastSLAM 2.0 (conan_slam_tpu_torch.filters.pf and the
particle filter's linear algebra in core.linalg): every function against
the JAX package on numpy-seeded inputs with the reference's own draws
(its keys' normals and uniforms, passed to the port as tensors), then the
JAX package's own PF tests (tests/test_pf.py) on the port.

Tolerances, each with its reason:
  * the closed forms of core.linalg: the same float32 operations in the
    same order, so a few ulps of each result's scale (rtol 1e-6, atol a
    few ulps of the inputs' scale), where the frameworks' sqrt/log differ;
  * the gather and the masked write of the measurements' map slots:
    copies, bit for bit the reference's one-hot contractions;
  * predict, the heading update, the feature updates, new features and
    the proposal: float32 formulas over poses of ~100 m and features of
    ~1 km, in which sin/cos/atan2 differ in the last bit between the
    frameworks' libm: rtol 1e-5 with atol at the ulps of each scale
    (pose 1e-4 m, features 2e-3 m, covariances 1e-4 of their largest
    entry); a log weight to 1e-3, the rounding of densities of km-scale
    poses under cm-scale covariances;
  * resampling: the ancestor indices equal, given the reference's own
    weights and uniforms; the gathered tensors bit for bit;
  * particle-axis sums (normalised weights, Neff, the mean pose): N terms
    summed in another order than XLA's, rtol 1e-5.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.core import linalg as jlin
from conan_slam_tpu.filters import pf as jpf
from conan_slam_tpu.filters.common import CompactObs as JObs
from conan_slam_tpu.filters.pf import state as jstate
from conan_slam_tpu.filters.pf.resample import systematic_indices as j_systematic
from conan_slam_tpu.models import sensor as jsensor
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.core import linalg as tlin
from conan_slam_tpu_torch.filters import pf
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.pf.recording import recording, resampling_flip
from conan_slam_tpu_torch.models import motion, sensor
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import run_pf_slam
from conan_slam_tpu_torch.sim.world import default_world

torch.set_num_threads(2)

R = np.diag([0.02, 2.0 * (math.pi / 180.0) ** 2]).astype(np.float32)   # the PF's RE = 2 R


def _t(a):
    return torch.as_tensor(np.array(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


def _close(got, ref, rtol, atol, **kw):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, **kw)


def _spd(rng, shape, d, scale):
    a = rng.normal(size=shape + (d, d))
    return (scale * (a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(d))).astype(np.float32)


def _normals(key, n):
    """The reference's per-particle draws: one normal(k, (3,)) per split key."""
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (3,), jnp.float32))(
        jax.random.split(key, n)))


def _problem(seed, n=12, k=10, nz=8, n_active=6, num_ids=20, known_mask=None, new=None):
    """An ensemble of ``n`` particles with ``n_active`` of ``k`` slots mapped
    (ids 0..n_active-1 at slots in shuffled order), ~100 m poses, features
    at 20-900 m, and a measurement buffer of ``nz`` slots: the mapped ids
    in ``known_mask``'s slots, unmapped ids in ``new``'s, the rest empty.
    Returns ``(jax ensemble, port ensemble, jax obs, port obs)``."""
    rng = np.random.default_rng(seed)
    pose = np.c_[rng.uniform(-100, 100, (n, 2)), rng.uniform(-3, 3, n)].astype(np.float32)
    base = rng.uniform(-100, 100, 2)
    rngs = rng.uniform(20, 900, k)
    ang = rng.uniform(-math.pi, math.pi, k)
    xf = (base + np.c_[rngs * np.cos(ang), rngs * np.sin(ang)])[None] + rng.normal(0, 0.5, (n, k, 2))
    pfc = _spd(rng, (n, k), 2, 2.0)
    table = np.full(num_ids, -1, np.int64)
    table[:n_active] = rng.permutation(n_active)
    known_mask = np.arange(nz) < min(nz, n_active) if known_mask is None else known_mask
    new = np.zeros(nz, bool) if new is None else new
    ids = np.full(nz, -1, np.int64)
    kn = np.flatnonzero(known_mask)
    ids[kn] = rng.permutation(n_active)[:len(kn)]
    nw = np.flatnonzero(new)
    ids[nw] = n_active + np.arange(len(nw))
    mask = ids >= 0
    z = np.zeros((nz, 2), np.float32)
    for i in np.flatnonzero(mask):
        if ids[i] < n_active:
            zp = np.asarray(jsensor.observe(_j(pose[0]), _j(xf[0, table[ids[i]]].astype(np.float32)))[0])
            z[i] = zp + rng.normal(0, [0.1, 0.01])
        else:
            z[i] = [rng.uniform(20, 900), rng.uniform(-1.5, 1.5)]
    arrays = dict(log_w=rng.normal(0, 2, n).astype(np.float32), pose=pose,
                  pose_cov=_spd(rng, (n,), 3, 1e-3), xf=xf.astype(np.float32), pf=pfc)
    jens = jpf.ParticleEnsemble(**{a: _j(v) for a, v in arrays.items()},
                                n_active=jnp.int32(n_active), table=_j(table.astype(np.int32)))
    tens = pf.ParticleEnsemble(**{a: _t(v) for a, v in arrays.items()},
                               n_active=torch.tensor(n_active), table=_t(table))
    return (jens, tens, JObs(_j(z), _j(ids.astype(np.int32)), _j(mask)),
            CompactObs(_t(z), _t(ids), _t(mask)))


def _ens_close(got, ref, log_w=1e-3):
    """The port's ensemble against the reference's, at the module tolerances."""
    _close(got.pose, ref.pose, 1e-5, 1e-4)
    scale = float(np.abs(np.asarray(ref.pose_cov)).max())
    _close(got.pose_cov, ref.pose_cov, 1e-5, 1e-4 * scale + 1e-12)
    _close(got.xf, ref.xf, 1e-5, 2e-3)
    _close(got.pf, ref.pf, 1e-5, 1e-4 * float(np.abs(np.asarray(ref.pf)).max()))
    _close(got.log_w, ref.log_w, 1e-5, log_w)
    assert int(got.n_active) == int(ref.n_active)
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(ref.table))


# ------------------------------------------------------------ core.linalg


def test_small_products_and_closed_forms_match_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 5, 3, 2)).astype(np.float32)
    b = rng.normal(size=(7, 5, 2, 3)).astype(np.float32)
    v = rng.normal(size=(7, 5, 3)).astype(np.float32)
    p = _spd(rng, (7, 5), 2, 1.0)
    r = _spd(rng, (), 3, 0.1)
    for got, ref in ((tlin.bmm_small(_t(a), _t(b)), jlin.bmm_small(_j(a), _j(b))),
                     (tlin.bmv_small(_t(a), _t(v[..., :2])), jlin.bmv_small(_j(a), _j(v[..., :2]))),
                     (tlin.quad_small(_t(a), _t(p)), jlin.quad_small(_j(a), _j(p))),
                     (tlin.quad_small(_t(a), _t(p), _t(r)), jlin.quad_small(_j(a), _j(p), _j(r)))):
        _close(got, ref, 1e-6, 1e-6)


def test_inv3_det3_chol3_match_reference_including_singular_inputs():
    rng = np.random.default_rng(1)
    m = _spd(rng, (40,), 3, 1.0)
    m[0] = [[1, 2, 3], [2, 4, 6], [3, 6, 10]]            # singular: det 0, inverse zero
    m[1] = np.diag([1.0, 1e-4, 1e-8])                    # near singular
    m[2] = [[1, 0, 0], [0, -1, 0], [0, 0, 1]]            # not PD: chol3's zero guard
    m[3] = 0.0                                            # zero: chol3 gives zeros, jitter
    m = m.astype(np.float32)
    got, ref = tlin.inv3(_t(m)), jlin.inv3(_j(m))
    np.testing.assert_array_equal(got[0].numpy(), 0.0)
    _close(got, ref, 1e-5, 1e-6)
    _close(tlin.det3(_t(m)), jlin.det3(_j(m)), 1e-6, 1e-6)
    for jitter in (0.0, 1e-8):
        got, ref = tlin.chol3(_t(m), jitter), jlin.chol3(_j(m), jitter)
        np.testing.assert_array_equal(got[2].numpy(), 0.0)
        np.testing.assert_array_equal(got[3].numpy() == 0.0, np.asarray(ref[3]) == 0.0)
        _close(got, ref, 1e-6, 1e-7)


def test_gaussian_densities_and_solves_match_reference():
    rng = np.random.default_rng(2)
    s2, s3 = _spd(rng, (30,), 2, 0.5), _spd(rng, (30,), 3, 0.5)
    v2 = rng.normal(size=(30, 2)).astype(np.float32)
    v3 = rng.normal(size=(30, 3)).astype(np.float32)
    for jitter in (0.0, 1e-8):
        _close(tlin.mvn_logpdf2(_t(v2), _t(s2), jitter), jlin.mvn_logpdf2(_j(v2), _j(s2), jitter),
               1e-6, 1e-5)
        _close(tlin.mvn_logpdf3(_t(v3), _t(s3), jitter), jlin.mvn_logpdf3(_j(v3), _j(s3), jitter),
               1e-6, 1e-5)
        _close(tlin.mvn_logpdf(_t(v3), _t(s3), jitter), jlin.mvn_logpdf(_j(v3), _j(s3), jitter),
               1e-5, 1e-5)
    b = rng.normal(size=(30, 3, 2)).astype(np.float32)
    _close(tlin.solve_psd(_t(s3), _t(b)), jlin.solve_psd(_j(s3), _j(b)), 1e-4, 1e-5)
    key = jax.random.PRNGKey(5)
    mean, cov = v3[0], s3[0]
    for num in (None, 64):
        eps = np.asarray(jax.random.normal(key, (3,) if num is None else (num, 3), jnp.float32))
        _close(tlin.sample_mvn(_t(eps), _t(mean), _t(cov), num),
               jlin.sample_mvn(key, _j(mean), _j(cov), num), 1e-5, 1e-6)
    gen = torch.Generator().manual_seed(0)
    draw = tlin.sample_mvn(gen, _t(mean), _t(cov), 4000)
    _close(torch.cov(draw.T.double()), cov, 0.0, 0.15 * float(np.abs(cov).max()))


# ------------------------------------------------------------ state


def test_slot_gather_and_masked_write_are_bit_exact_to_the_one_hot_forms():
    rng = np.random.default_rng(3)
    n, k, nz = 9, 12, 10
    xf = rng.normal(size=(n, k, 2)).astype(np.float32)
    pfc = rng.normal(size=(n, k, 2, 2)).astype(np.float32)
    xf_new = rng.normal(size=(n, nz, 2)).astype(np.float32)
    pf_new = rng.normal(size=(n, nz, 2, 2)).astype(np.float32)
    # Unique masked-true slots; masked-false ones repeat slot 0 and a
    # masked-true slot, as clamped association slots do.
    slots = np.array([3, 0, 7, 11, 0, 5, 7, 2, 0, 9])
    mask = np.array([1, 1, 1, 1, 0, 1, 0, 1, 0, 0], bool)
    sel = jstate.slot_selector(_j(slots), k)
    for got, ref in zip(pf.gather_slots(_t(xf), _t(pfc), _t(slots)),
                        jstate.gather_slots(_j(xf), _j(pfc), sel)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for m in (mask, np.zeros_like(mask)):
        got = pf.scatter_slots(_t(xf), _t(pfc), _t(slots), _t(m), _t(xf_new), _t(pf_new))
        ref = jstate.scatter_slots(_j(xf), _j(pfc), sel, _j(m), _j(xf_new), _j(pf_new))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(got[0].numpy(), xf)       # nothing masked: unchanged


def test_weights_mean_and_best_pose_match_reference():
    jens, tens, _, _ = _problem(4, n=200)
    _close(pf.normalized_weights(tens), jpf.normalized_weights(jens), 1e-5, 1e-9)
    _close(pf.effective_count(pf.normalized_weights(tens)),
           jpf.effective_count(jpf.normalized_weights(jens)), 1e-5, 0.0)
    _close(pf.mean_pose(tens), jpf.mean_pose(jens), 1e-5, 1e-5)
    np.testing.assert_array_equal(pf.best_pose(tens).numpy(), np.asarray(jpf.best_pose(jens)))
    ens = pf.init_ensemble(10, 4, 12, device="cpu")
    for got, ref in zip(ens, jpf.init_ensemble(10, 4, 12)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------ predict, updates


def test_predict_and_heading_update_match_reference():
    jens, tens, _, _ = _problem(5)
    q = np.diag([0.09, 2.0 * (3 * math.pi / 180) ** 2]).astype(np.float32)
    v, swa = np.float32(3.2), np.float32(0.21)
    jout = jpf.predict(jens, _j(v), _j(swa), _j(q), 73.0, 0.01)
    tout = pf.predict(tens, _t(v), _t(swa), _t(q), 73.0, 0.01)
    _ens_close(tout, jout)
    sigma = 0.01 * math.pi / 180.0
    _ens_close(pf.observe_heading(tout, _t(np.float32(0.4)), sigma),
               jpf.observe_heading(jout, _j(np.float32(0.4)), sigma))


def test_feature_update_matches_reference():
    jens, tens, jobs, tobs = _problem(6)
    jk, js, _ = jpf.associate_known(jens, jobs)
    tk, ts, _ = pf.associate_known(tens, tobs)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _ens_close(pf.feature_update(tens, tobs, ts, tk, _t(R)),
               jpf.feature_update(jens, jobs, js, jk, _j(R)))
    # Nothing known: the maps come back unchanged, bit for bit.
    out = pf.feature_update(tens, tobs, ts, torch.zeros_like(tk), _t(R))
    assert torch.equal(out.xf, tens.xf) and torch.equal(out.pf, tens.pf)


@pytest.mark.parametrize("n_active,n_new", [(3, 4), (8, 4)], ids=["room", "overflow"])
def test_add_new_features_matches_reference(n_active, n_new):
    # Capacity 10: with 8 mapped only two of the four new features fit; the
    # rest are dropped (the reference's mode="drop" scatter).
    nz = 8
    new = np.zeros(nz, bool)
    new[2:2 + n_new] = True
    known = np.zeros(nz, bool)
    known[:2] = True
    jens, tens, jobs, tobs = _problem(7, n_active=n_active, known_mask=known, new=new)
    _, _, jn = jpf.associate_known(jens, jobs)
    _, _, tn = pf.associate_known(tens, tobs)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    got = pf.add_new_features(tens, tobs, tn, _t(R))
    ref = jpf.add_new_features(jens, jobs, jn, _j(R))
    _ens_close(got, ref)
    assert int(got.n_active) == min(n_active + n_new, 10)
    out = pf.add_new_features(tens, tobs, torch.zeros_like(tn), _t(R))
    for a, b in zip(out, tens):
        assert torch.equal(a, b)


@pytest.mark.parametrize("relinearize", [False, True], ids=["one-shot", "relinearized"])
def test_sample_proposal_matches_reference(relinearize):
    jens, tens, jobs, tobs = _problem(8)
    jk, js, _ = jpf.associate_known(jens, jobs)
    tk, ts, _ = pf.associate_known(tens, tobs)
    key = jax.random.PRNGKey(11)
    ref = jpf.sample_proposal(jens, jobs, js, jk, _j(R), key, relinearize=relinearize)
    got = pf.sample_proposal(tens, tobs, ts, tk, _t(R), _t(_normals(key, 12)),
                             relinearize=relinearize)
    _ens_close(got, ref)


# ------------------------------------------------------------ resampling


@pytest.mark.parametrize("n", [5, 1000, 1024, 3 * 1024, 3 * 1024 + 17, 100_000])
def test_cumulative_weights_within_an_ulp_of_float64(n):
    # The resample's fixed-order CDF (blocked, float64 doubling scans) lies
    # no further from a float64 cumsum of the same float32 weights than
    # torch.cumsum does, plus one float32 ulp of the value: at N that is
    # and is not a multiple of pf.resample.CDF_BLOCK (1,024), one block
    # and many.
    from conan_slam_tpu_torch.filters.pf.resample import CDF_BLOCK

    assert CDF_BLOCK == 1024
    rng = np.random.default_rng(n)
    w = torch.as_tensor(rng.exponential(size=n).astype(np.float32))
    w = w / w.sum()
    got = pf.cumulative_weights(w)
    assert got.dtype == torch.float32 and got.shape == (n,)
    exact = torch.cumsum(w.double(), 0)
    own = (torch.cumsum(w, 0).double() - exact).abs()
    ulp = torch.nextafter(exact.float(), torch.tensor(math.inf)).double() - exact.float().double()
    assert bool(((got.double() - exact).abs() <= own + ulp).all())
    assert torch.equal(got, pf.cumulative_weights(w.clone()))


def test_resample_indices_equal_on_reference_weights_and_uniforms():
    rng = np.random.default_rng(9)
    for n in (7, 100, 1000):
        w = np.asarray(jpf.normalized_weights(jpf.ParticleEnsemble(
            _j(rng.normal(0, 3, n).astype(np.float32)), *([None] * 6))))
        for s in range(4):
            key = jax.random.PRNGKey(100 * n + s)
            u = np.asarray(jax.random.uniform(key, (n,), jnp.float32))
            np.testing.assert_array_equal(pf.stratified_indices(_t(u), _t(w), n).numpy(),
                                          np.asarray(jpf.stratified_indices(key, _j(w), n)))
            u0 = np.asarray(jax.random.uniform(key, (), jnp.float32))
            np.testing.assert_array_equal(pf.systematic_indices(_t(u0), _t(w), n).numpy(),
                                          np.asarray(j_systematic(key, _j(w), n)))


@pytest.mark.parametrize("kind,roughening", [("stratified", 0.0), ("systematic", 0.0),
                                             ("stratified", 0.05), ("systematic", 0.02)])
@pytest.mark.parametrize("fires", [True, False], ids=["neff-low", "neff-high"])
def test_resample_matches_reference(kind, roughening, fires):
    jens, tens, _, _ = _problem(10, n=16)
    if not fires:   # equal weights: Neff = N, no resample
        jens = jens._replace(log_w=jnp.zeros(16))
        tens = tens._replace(log_w=torch.zeros(16))
    key = jax.random.PRNGKey(3)
    k_idx, k_rough = jax.random.split(key)
    u = np.asarray(jax.random.uniform(k_idx, () if kind == "systematic" else (16,), jnp.float32))
    rough = np.asarray(jax.random.normal(k_rough, (16, 3), jnp.float32))
    ref = jpf.resample(jens, key, 12.0, True, kind=kind, roughening=roughening)
    got = pf.resample(tens, _t(u), _t(rough), 12.0, True, kind=kind, roughening=roughening)
    for name in ("pose_cov", "xf", "pf", "log_w"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    if roughening:
        _close(got.pose, ref.pose, 1e-6, 1e-5)
    else:
        np.testing.assert_array_equal(got.pose.numpy(), np.asarray(ref.pose))
    assert fires != bool(torch.equal(got.pose_cov, tens.pose_cov))
    # Disabled, or gated off: the ensemble as it was.
    off = pf.resample(tens, _t(u), _t(rough), 12.0, False, kind=kind, roughening=roughening)
    gated = pf.resample(tens, _t(u), _t(rough), 12.0, True, kind=kind, roughening=roughening,
                        gate=torch.tensor(False))
    for a, b, c in zip(off, gated, tens):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.parametrize("kind", ["stratified", "systematic"])
def test_recording_hook_replays_resample_and_explains_flips(kind):
    # recording() resamples bit for bit as resample does, and on forced
    # ancestors as resample_ancestors does; resampling_flip finds no flip
    # between equal records, and explains one whose weights straddle a
    # stratum's boundary by less than their difference.
    _, tens, _, _ = _problem(10, n=16)
    g = torch.Generator().manual_seed(4)
    u = torch.rand(() if kind == "systematic" else (16,), generator=g)
    rough = torch.randn((16, 3), generator=g)
    seen: dict = {}
    got = recording(seen)(tens, u, rough, 12.0, True, kind=kind, roughening=0.02,
                          gate=torch.tensor(True))
    ref = pf.resample(tens, u, rough, 12.0, True, kind=kind, roughening=0.02,
                      gate=torch.tensor(True))
    assert seen["gate"] and seen["neff"] < 12.0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    flipped = torch.roll(seen["idx"], 1)
    forced = recording({}, (flipped, True))(tens, u, rough, 12.0, True, kind=kind,
                                            roughening=0.02, gate=torch.tensor(True))
    direct = pf.resample_ancestors(tens, flipped, torch.tensor(True), rough, 0.02)
    for a, b in zip(forced, direct):
        assert torch.equal(a, b)
    assert resampling_flip(seen, dict(seen), 12.0) == []
    # Move the weight across the boundary that stratum 0's point lies behind.
    i = int(seen["idx"][0])
    point = float(((torch.arange(16, dtype=torch.float32) + u) / 16)[0])
    gap = float(torch.cumsum(seen["w"], 0)[i]) - point + 1e-3
    w = seen["w"].clone()
    w[i] -= gap
    w[min(i + 1, 15)] += gap
    other = dict(seen, w=w, idx=pf.systematic_indices(u, w, 16) if kind == "systematic"
                 else pf.stratified_indices(u, w, 16))
    flip = resampling_flip(seen, other, 12.0)
    assert flip and all(m <= d for _, m, d in flip), flip
    decided = resampling_flip(seen, dict(seen, neff=13.0), 12.0)
    assert len(decided) == 1 and decided[0][1] <= decided[0][2]


# ------------------------------------------------------------ the observation step


CASES = {"known only": (np.arange(8) < 5, np.zeros(8, bool)),
         "new only": (np.zeros(8, bool), np.arange(8) >= 5),
         "both": (np.arange(8) < 4, (np.arange(8) >= 4) & (np.arange(8) < 7)),
         "neither": (np.zeros(8, bool), np.zeros(8, bool))}


@pytest.mark.parametrize("relinearize", [False, True], ids=["one-shot", "relinearized"])
@pytest.mark.parametrize("case", list(CASES))
def test_observation_step_matches_reference(case, relinearize):
    known, new = CASES[case]
    jens, tens, jobs, tobs = _problem(12, n=16, known_mask=known, new=new)
    key = jax.random.PRNGKey(21)
    k_prop, k_res, k_samp = jax.random.split(key, 3)
    k_idx, _ = jax.random.split(k_res)
    draws = pf.ObservationDraws(
        prop=_t(_normals(k_prop, 16)), samp=_t(_normals(k_samp, 16)), rough=None,
        res_u=_t(jax.random.uniform(k_idx, (16,), jnp.float32)))
    kw = dict(num_effective=12.0, sample_proposal_on=True, resample_on=True,
              proposal_relinearize=relinearize)
    ref = jpf.observation_step(jens, jobs, _j(R), key, **kw)
    got = pf.observation_step(tens, tobs, _t(R), draws, **kw)
    _ens_close(got, ref)
    if case == "neither":
        for a, b in zip(got, tens):
            assert torch.equal(a, b)
    if case == "new only":      # the prior sample: covariances zeroed, weights kept
        assert not torch.equal(got.pose, tens.pose) and not got.pose_cov.any()
        assert torch.equal(got.log_w, tens.log_w)


# ------------------------------------------------------------ tests/test_pf.py on the port


def _ens_with_features(n=8, k=4, feats=None, num_ids=12):
    ens = pf.init_ensemble(n, k, num_ids, device="cpu")
    if feats is not None:
        nf = feats.shape[0]
        xf = torch.zeros((n, k, 2))
        xf[:, :nf] = _t(feats)
        pfc = torch.zeros((n, k, 2, 2))
        pfc[:, :nf] = torch.eye(2) * 0.5
        table = torch.full((num_ids,), -1)
        table[:nf] = torch.arange(nf)
        ens = ens._replace(xf=xf, pf=pfc, n_active=torch.tensor(nf), table=table)
    return ens


def test_init_ensemble_uniform_weights():
    ens = pf.init_ensemble(10, 4, 12, device="cpu")
    _close(pf.normalized_weights(ens), np.full(10, 0.1), 1e-6, 0.0)
    assert int(ens.n_active) == 0


def test_predict_propagates_pose_cov():
    ens = pf.init_ensemble(4, 2, 6, device="cpu")
    q = _t(np.diag([0.09, 0.0003]).astype(np.float32))
    v, swa = torch.tensor(50.0), torch.tensor(0.1)
    out = pf.predict(ens, v, swa, q, 73.0, 0.01)
    # All particles identical; covariance = Gu Q Gu^T after one step from P=0.
    _, gu = motion.jacobians(torch.zeros(3), v, swa, 73.0, 0.01)
    _close(out.pose_cov[0], (gu @ q @ gu.T).numpy(), 1e-4, 1e-8)
    assert not torch.allclose(out.pose, torch.zeros(3))


def test_feature_update_reduces_uncertainty_and_matches_kf():
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    ens = _ens_with_features(n=3, feats=feats)
    zp, _, _ = sensor.observe(torch.zeros(3), _t(feats))
    obs = CompactObs(z=zp + _t(np.float32([[0.3, 0.01], [-0.2, 0.005]])),
                     ids=torch.tensor([0, 1]), mask=torch.tensor([True, True]))
    r = _t(np.diag([0.01, 0.0003]).astype(np.float32))
    out = pf.feature_update(ens, obs, torch.tensor([0, 1]), torch.tensor([True, True]), r)
    # NumPy closed-form KF on feature 0 of particle 0.
    x0, p0 = feats[0], np.eye(2, dtype=np.float32) * 0.5
    zp0, _, hf = sensor.observe(torch.zeros(3), _t(x0))
    hf = hf.numpy()
    v = obs.z[0].numpy() - zp0.numpy()
    kk = p0 @ hf.T @ np.linalg.inv(hf @ p0 @ hf.T + r.numpy())
    _close(out.xf[0, 0], x0 + kk @ v, 1e-3, 1e-3)
    _close(out.pf[0, 0], (np.eye(2) - kk @ hf) @ p0, 1e-3, 1e-4)
    np.testing.assert_array_equal(out.xf[0, 2:].numpy(), 0.0)     # untouched slots


def test_add_new_features_assigns_shared_slots():
    ens = _ens_with_features(n=3, feats=np.asarray([[30.0, 10.0]], np.float32))
    obs = CompactObs(z=_t(np.float32([[50.0, 0.3], [80.0, -0.7]])), ids=torch.tensor([5, 6]),
                     mask=torch.tensor([True, True]))
    r = _t(np.diag([0.01, 0.0003]).astype(np.float32))
    out = pf.add_new_features(ens, obs, torch.tensor([True, True]), r)
    assert int(out.n_active) == 3
    assert int(out.table[5]) == 1 and int(out.table[6]) == 2
    xf_exp, _, gz = sensor.init_feature(torch.zeros(3), obs.z)
    _close(out.xf[1, 1:3], xf_exp, 1e-4, 0.0)
    _close(out.pf[1, 1:3], (gz @ r @ gz.transpose(-1, -2)).numpy(), 1e-3, 1e-6)


def test_sample_proposal_pulls_pose_towards_measurements():
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    n = 64
    ens = _ens_with_features(n=n, feats=feats)
    # Particles start at a perturbed pose with a broad prior; the true pose
    # is the origin and the measurements exact from it.
    ens = ens._replace(pose=torch.tensor([2.0, -1.5, 0.05]).repeat(n, 1),
                       pose_cov=torch.diag(torch.tensor([4.0, 4.0, 0.01])).repeat(n, 1, 1))
    zp, _, _ = sensor.observe(torch.zeros(3), _t(feats))
    obs = CompactObs(z=zp, ids=torch.tensor([0, 1]), mask=torch.tensor([True, True]))
    r = _t(np.diag([0.01, 0.0003]).astype(np.float32))
    eps = torch.randn((n, 3), generator=torch.Generator().manual_seed(0))
    out = pf.sample_proposal(ens, obs, torch.tensor([0, 1]), torch.tensor([True, True]), r, eps)
    d_after = torch.linalg.norm(out.pose[:, :2], dim=1).mean()
    assert float(d_after) < 0.5 * math.hypot(2.0, -1.5)
    assert bool(torch.isfinite(out.log_w).all())
    assert not out.pose_cov.any()          # zeroed after sampling (reference PF.cpp:537)


def test_stratified_resample_statistics():
    gen = torch.Generator().manual_seed(1)
    w = torch.tensor([0.5, 0.25, 0.125, 0.125])
    counts = torch.zeros(4)
    for _ in range(200):
        counts += torch.bincount(pf.stratified_indices(torch.rand(4, generator=gen), w, 4),
                                 minlength=4)
    _close(counts / counts.sum(), w, 0.0, 0.05)


def test_systematic_resample_statistics_and_roughening():
    gen = torch.Generator().manual_seed(2)
    w = torch.tensor([0.5, 0.25, 0.125, 0.125])
    counts = torch.zeros(4)
    for _ in range(200):
        counts += torch.bincount(pf.systematic_indices(torch.rand((), generator=gen), w, 4),
                                 minlength=4)
    _close(counts / counts.sum(), w, 0.0, 0.05)
    # Systematic draws are sorted (one shared offset).
    assert bool((torch.diff(pf.systematic_indices(torch.rand((), generator=gen), w, 4)) >= 0).all())

    # Roughening jitters resampled poses (heading stays wrapped).
    ens = pf.init_ensemble(8, 2, 4, device="cpu")
    lw = torch.full((8,), -30.0)
    lw[3] = 0.0
    spread = torch.linspace(-3.0, 4.0, 8)
    ens = ens._replace(log_w=lw, pose=torch.stack([spread] * 3, dim=1))
    out = pf.resample(ens, torch.rand((), generator=gen), torch.randn((8, 3), generator=gen),
                      num_effective=6.0, enabled=True, kind="systematic", roughening=0.05)
    # Dominant particle (index 3, pose 0.0) cloned everywhere, then jittered:
    # std = 0.05 * spread(7) * 8^(-1/3) ~ 0.18, small but nonzero.
    assert not bool((out.pose[:, 0] == 0.0).all())
    assert float(out.pose[:, 0].abs().max()) < 1.5
    assert bool((out.pose[:, 2].abs() <= math.pi + 1e-6).all())


def test_resample_triggers_on_degenerate_weights():
    ens = pf.init_ensemble(8, 2, 4, device="cpu")
    lw = torch.full((8,), -30.0)
    lw[3] = 0.0   # one dominant particle
    marker = torch.arange(8, dtype=torch.float32)
    ens = ens._replace(log_w=lw, pose=torch.stack([marker] * 3, dim=1))
    u = torch.rand(8, generator=torch.Generator().manual_seed(0))
    out = pf.resample(ens, u, None, num_effective=6.0, enabled=True)
    # Dominant particle cloned everywhere; weights reset.
    assert bool((out.pose[:, 0] == 3.0).all())
    _close(pf.normalized_weights(out), np.full(8, 0.125), 1e-5, 0.0)
    # Neff above the threshold: no resample.
    out2 = pf.resample(ens._replace(log_w=torch.zeros(8)), u, None, num_effective=6.0,
                       enabled=True)
    assert torch.equal(out2.pose, ens.pose)


def test_e2e_pf_noise_free_tracks_truth():
    cfg = SlamConfig(switch_control_noise=False, switch_sensor_noise=False,
                     switch_inflate_noise=False, num_particles=20)
    carry, outs = run_pf_slam(default_world(device="cpu"), cfg, torch.Generator().manual_seed(0),
                              2000)
    ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    assert ate < 1.0, f"noise-free PF ATE too high: {ate}"
    assert int(carry.ens.n_active) > 0


def test_sample_proposal_relinearized_path():
    """The reference's iterated fusion runs too, and broadly agrees with the
    one-shot fusion."""
    feats = np.asarray([[30.0, 10.0], [-20.0, 25.0]], np.float32)
    n = 16
    ens = _ens_with_features(n=n, feats=feats)
    ens = ens._replace(pose=torch.tensor([1.0, -0.5, 0.02]).repeat(n, 1),
                       pose_cov=torch.diag(torch.tensor([1.0, 1.0, 0.01])).repeat(n, 1, 1))
    zp, _, _ = sensor.observe(torch.zeros(3), _t(feats))
    obs = CompactObs(z=zp, ids=torch.tensor([0, 1]), mask=torch.tensor([True, True]))
    r = _t(np.diag([0.01, 0.0003]).astype(np.float32))
    eps = torch.randn((n, 3), generator=torch.Generator().manual_seed(0))
    args = (ens, obs, torch.tensor([0, 1]), torch.tensor([True, True]), r, eps)
    out_seq = pf.sample_proposal(*args, relinearize=True)
    out_bat = pf.sample_proposal(*args, relinearize=False)
    assert bool(torch.isfinite(out_seq.log_w).all())
    # Same draws, a nearly linear problem: the fused poses are close.
    _close(out_seq.pose, out_bat.pose, 0.0, 0.2)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pf.init_ensemble(4, 2, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_pf_slam(default_world(), SlamConfig(num_particles=4), None, 6)


def test_bench_pf_and_the_example_run_on_cpu(capsys):
    from conan_slam_tpu_torch.benchmarks import bench_pf
    from conan_slam_tpu_torch.examples import valet_loop

    res = bench_pf.main(["4", "8"], device="cpu", steps=12)
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    for n in (4, 8):
        line = next(ln for ln in out if ln.startswith(f"N={n:6d}:"))
        assert "steps/s" in line and "particle-steps/s" in line and "ATE=" in line
        assert res[n]["particle_steps_per_s"] == pytest.approx(n * res[n]["steps_per_s"])
    res = valet_loop.main(["--pf", "--steps", "12", "--device", "cpu"])
    assert res["done_at"] == 12 and res["mapped"] > 0
    assert "FastSLAM 2.0" in capsys.readouterr().out


def test_pf_modules_import_no_jax():
    import os
    import subprocess
    import sys
    import textwrap

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = textwrap.dedent("""
        import sys
        import conan_slam_tpu_torch.filters.pf
        import conan_slam_tpu_torch.runner.loop
        import conan_slam_tpu_torch.benchmarks.bench_pf
        import conan_slam_tpu_torch.examples.valet_loop
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "conan_slam_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
