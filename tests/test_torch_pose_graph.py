"""Port parity for the pose graph (conan_slam_tpu_torch.graph): the six tests
of tests/test_pose_graph.py on the port, each function against the JAX
package on the same numpy-seeded inputs (masked garbage nodes at 1e6
included), the fixed-order scatter against index_add_, and R1.

Tolerances, each with its reason:
  * relative_pose, compose_pose, residuals and Jacobians: rtol 1e-5,
    atol 2e-3 on positions of up to ~5 km (float32 spacing 4.9e-4 m; sin
    and cos of the two libms differ by an ulp, times a ~5 km lever), atol
    1e-5 on unit-scale terms, 2e-6 rad on wrapped angles.
  * chi^2: rtol 1e-4 (a sum of E squared residuals, each a few ulps of its
    inputs apart).
  * one Gauss-Newton step's gradient and block-Jacobi diagonal: 1e-4 of
    the largest entry of each node's block (sums over a node's edges of
    products of information up to 1e4 with Jacobians of km lever arms and
    residuals; the anchor's 1e6 entries on node 0).
  * a few CG steps of optimize: 2e-3 m / 2e-5 rad (the CG's scalars are
    ratios of sums over all nodes, rounded in another order).
Whole solves (chordal initialisation and tens of Gauss-Newton steps) are
held by the float64 witness rule of tests/test_torch_longloop.py: the bench
graph there, R1's two rounds here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.graph import frontend as jfe
from conan_slam_tpu.graph import pose_graph as jpg
from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.graph import frontend as tfe
from conan_slam_tpu_torch.graph import pose_graph as pg

torch.set_num_threads(2)


def t(a):
    return torch.as_tensor(np.array(a))


def _simulate_loop(n=40, drift=0.02, seed=0):
    """Square-ish loop: ground truth and odometry with heading drift (the
    reference test's helper, in the port)."""
    rng = np.random.default_rng(seed)
    truth = np.zeros((n, 3), np.float32)
    step_len = 10.0
    for i in range(1, n):
        turn = (np.pi / 2) if i % (n // 4) == 0 else 0.0
        th = truth[i - 1, 2] + turn
        truth[i] = [truth[i - 1, 0] + step_len * np.cos(th),
                    truth[i - 1, 1] + step_len * np.sin(th), th]
    truth[:, 2] = wrap_angle(t(truth[:, 2])).numpy()
    meas = []
    for i in range(n - 1):
        rel = pg.relative_pose(t(truth[i]), t(truth[i + 1])).numpy()
        noise = rng.normal(size=3).astype(np.float32) * [0.05, 0.05, drift]
        meas.append(rel + noise)
    guess = np.zeros_like(truth)
    for i in range(n - 1):
        c, s = np.cos(guess[i, 2]), np.sin(guess[i, 2])
        guess[i + 1, 0] = guess[i, 0] + c * meas[i][0] - s * meas[i][1]
        guess[i + 1, 1] = guess[i, 1] + s * meas[i][0] + c * meas[i][1]
        guess[i + 1, 2] = guess[i, 2] + meas[i][2]
    return truth, np.asarray(meas, np.float32), guess


def _build_graph(truth, odo_meas, guess, closures) -> pg.PoseGraph:
    n = truth.shape[0]
    edges = [np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)]
    meas = [odo_meas]
    infos = [np.tile(np.diag([100.0, 100.0, 400.0]).astype(np.float32), (n - 1, 1, 1))]
    if closures:
        pairs = np.asarray(closures, np.int64)
        edges.append(pairs)
        meas.append(np.stack([pg.relative_pose(t(truth[i]), t(truth[j])).numpy()
                              for i, j in pairs]).astype(np.float32))
        infos.append(np.tile(np.diag([400.0, 400.0, 1600.0]).astype(np.float32),
                             (len(pairs), 1, 1)))
    edges = np.concatenate(edges)
    return pg.PoseGraph(nodes=t(guess), node_mask=torch.ones(n, dtype=torch.bool),
                        edges=t(edges).long(), meas=t(np.concatenate(meas)),
                        info=t(np.concatenate(infos)),
                        edge_mask=torch.ones(edges.shape[0], dtype=torch.bool))


def _padded(g: pg.PoseGraph) -> pg.PoseGraph:
    """``g`` with 5 masked garbage nodes at 1e6 and 4 masked edges between
    them (the reference test's padding)."""
    n = g.nodes.shape[0]
    return pg.PoseGraph(
        torch.cat([g.nodes, torch.full((5, 3), 1e6)]),
        torch.cat([g.node_mask, torch.zeros(5, dtype=torch.bool)]),
        torch.cat([g.edges, torch.tensor([[n + 1, n + 3]] * 4)]),
        torch.cat([g.meas, torch.ones(4, 3)]),
        torch.cat([g.info, torch.eye(3)[None].repeat(4, 1, 1)]),
        torch.cat([g.edge_mask, torch.zeros(4, dtype=torch.bool)]))


def _random_graph(seed: int, t_nodes: int = 60, n_closures: int = 25) -> pg.PoseGraph:
    """A drifted chain over a ~5 km square with random closures and
    anisotropic information, padded with masked garbage (_padded)."""
    rng = np.random.default_rng(seed)
    nodes = np.concatenate([rng.uniform(-5000, 5000, (t_nodes, 2)),
                            rng.uniform(-np.pi, np.pi, (t_nodes, 1))], 1).astype(np.float32)
    chain = np.stack([np.arange(t_nodes - 1), np.arange(1, t_nodes)], 1)
    cl = rng.integers(0, t_nodes, (n_closures, 2))
    edges = np.concatenate([chain, cl])
    e = edges.shape[0]
    meas = np.concatenate([rng.normal(0, 30, (e, 2)), rng.uniform(-3, 3, (e, 1))], 1)
    info = np.zeros((e, 3, 3), np.float32)
    info[:, [0, 1, 2], [0, 1, 2]] = rng.uniform(1, 1e4, (e, 3))
    mask = rng.uniform(size=e) > 0.1
    g = pg.PoseGraph(t(nodes), torch.ones(t_nodes, dtype=torch.bool), t(edges).long(),
                     t(meas.astype(np.float32)), t(info), t(mask))
    return _padded(g)


def to_jax(g: pg.PoseGraph):
    return jpg.PoseGraph(*(jnp.asarray(a.numpy().astype(np.int32) if a.dtype == torch.int64
                                       else a.numpy()) for a in g))


# --- the reference's six tests, on the port ---

def test_relative_pose_roundtrip():
    a = torch.tensor([1.0, 2.0, 0.7])
    b = torch.tensor([4.0, -1.0, -0.9])
    np.testing.assert_allclose(tfe.compose_pose(a, pg.relative_pose(a, b)).numpy(), b.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_optimize_reduces_error_and_recovers_loop():
    truth, odo, guess = _simulate_loop()
    g = _build_graph(truth, odo, guess, [(0, 39), (1, 38)])
    err0 = float(pg.graph_error(g))
    g_opt = pg.optimize(g, iterations=15, cg_iterations=60)
    err1 = float(pg.graph_error(g_opt))
    assert err1 < 0.1 * err0, (err0, err1)
    drift_before = np.linalg.norm(guess[-1, :2] - truth[-1, :2])
    drift_after = np.linalg.norm(g_opt.nodes.numpy()[-1, :2] - truth[-1, :2])
    assert drift_after < 0.5 * drift_before, (drift_before, drift_after)


def test_optimize_respects_masks():
    truth, odo, guess = _simulate_loop(n=20)
    g = _build_graph(truth, odo, guess, [])
    out_ref = pg.optimize(g, iterations=5, cg_iterations=30)
    out_pad = pg.optimize(_padded(g), iterations=5, cg_iterations=30)
    np.testing.assert_allclose(out_pad.nodes.numpy()[:20], out_ref.nodes.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_dead_reckoned_valet_chain_recovers_with_closures():
    """Config 4's regime end to end: the dead-reckoned keyframe chain on the
    star tour drifts without bound; closures and relaxation recover its
    shape (aligned ATE drops several-fold), at the reference test's own
    budget of 15 Gauss-Newton iterations of T CG steps."""
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner import metrics
    from conan_slam_tpu_torch.sim.precompute import rollout_truth
    from conan_slam_tpu_torch.sim.world import star_waypoints

    roll = rollout_truth(star_waypoints(), SlamConfig(), 60000)
    truth, valid = t(roll.x_true), t(~roll.done)
    ccfg = tfe.ClosureConfig(odo_sigma_xy=0.5, odo_sigma_th=0.01, max_closures=256,
                             min_index_gap=60)
    g = tfe.simulate_odometry_graph(truth, valid, ccfg, torch.Generator().manual_seed(0))
    g_opt = pg.optimize(g, iterations=15, cg_iterations=g.nodes.shape[0], chordal_init=True)
    n = g.nodes.shape[0]
    kf_true, kf_valid = truth[::ccfg.keyframe_stride][:n], valid[::ccfg.keyframe_stride][:n]

    def ate(nodes):
        return float(metrics.aligned_ate_rmse(kf_true, nodes, kf_valid))

    before, after = ate(g.nodes), ate(g_opt.nodes)
    assert before > 20.0, before
    assert after < 0.35 * before, (before, after)
    assert float(pg.graph_error(g_opt)) < float(pg.graph_error(g))


def test_detect_loop_closures_finds_revisit():
    n = 30
    s = np.linspace(0, 2 * np.pi, n).astype(np.float32)
    nodes = np.stack([100 * np.sin(s), 100 * (1 - np.cos(s)), s], axis=1)
    pairs, mask = pg.detect_loop_closures(t(nodes), torch.ones(n, dtype=torch.bool),
                                          max_candidates=8, radius=30.0, min_index_gap=15)
    found = {tuple(p) for p, m in zip(pairs.tolist(), mask.tolist()) if m}
    assert found, "no closures found"
    for i, j in found:
        assert j - i >= 15
        assert np.linalg.norm(nodes[i, :2] - nodes[j, :2]) < 30.0


def _figure_eight():
    rng = np.random.default_rng(3)
    steps = 4000
    ang = np.linspace(0, 4 * np.pi, steps)
    xy = np.stack([600 * np.sin(ang), 300 * np.sin(2 * ang)], axis=1)
    th = np.arctan2(*np.gradient(xy, axis=0).T[::-1])
    truth = np.concatenate([xy, th[:, None]], axis=1).astype(np.float32)
    drift = np.cumsum(rng.normal(size=(steps, 3)) * [1.2, 1.2, 0.0004], axis=0)
    est = (truth + drift).astype(np.float32)
    cfg = dict(keyframe_stride=20, radius=40.0, min_index_gap=15, max_closures=512,
               odo_sigma_xy=0.3, odo_sigma_th=0.005)
    return truth, est, np.ones(steps, bool), cfg


def test_iterated_redetection_recovers_closures_without_oracle():
    from conan_slam_tpu_torch.runner import metrics

    truth, est, valid, kw = _figure_eight()
    cfg = tfe.ClosureConfig(**kw)
    truth, est, valid = t(truth), t(est), t(valid)

    def relax(rounds, on_est):
        return tfe.relax_trajectory(est, truth, valid, cfg, torch.Generator().manual_seed(0),
                                    iterations=12, rounds=rounds, detect_on_estimate=on_est)

    (g1, g1_opt), (g3, g3_opt), (go, go_opt) = relax(1, True), relax(3, True), relax(1, False)
    n = g1.nodes.shape[0]
    ncl1, ncl3 = int(g1.edge_mask[n - 1:].sum()), int(g3.edge_mask[n - 1:].sum())
    assert ncl3 > ncl1, (ncl1, ncl3)
    kf_true, kf_valid = truth[::cfg.keyframe_stride][:n], valid[::cfg.keyframe_stride][:n]

    def ate(nodes):
        return float(metrics.aligned_ate_rmse(kf_true, nodes, kf_valid))

    a1, a3, ao = ate(g1_opt.nodes), ate(g3_opt.nodes), ate(go_opt.nodes)
    assert a3 < a1, (a1, a3)
    assert a3 < 1.5 * ao + 0.5, (a3, ao)


# --- each function against the JAX package ---

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_residuals_jacobians_and_error_match_reference(seed):
    g = _random_graph(seed)
    jg = to_jax(g)
    r, a, b = pg._edge_residual_jacobians(g.nodes, g.edges, g.meas)
    jr, ja, jb = (np.asarray(v) for v in jpg._edge_residual_jacobians(jg.nodes, jg.edges, jg.meas))
    np.testing.assert_allclose(r[:, :2].numpy(), jr[:, :2], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(r[:, 2].numpy(), jr[:, 2], rtol=0, atol=2e-6)
    np.testing.assert_allclose(a[:, :2, 2].numpy(), ja[:, :2, 2], rtol=1e-5, atol=2e-3)
    a_rest, ja_rest = a.numpy().copy(), ja.copy()
    a_rest[:, :2, 2] = ja_rest[:, :2, 2] = 0.0
    np.testing.assert_allclose(a_rest, ja_rest, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), jb, rtol=1e-5, atol=1e-5)
    rel = pg.relative_pose(g.nodes[g.edges[:, 0]], g.nodes[g.edges[:, 1]])
    jrel = np.asarray(jpg.relative_pose(jg.nodes[jg.edges[:, 0]], jg.nodes[jg.edges[:, 1]]))
    np.testing.assert_allclose(rel[:, :2].numpy(), jrel[:, :2], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(rel[:, 2].numpy(), jrel[:, 2], rtol=0, atol=2e-6)
    np.testing.assert_allclose(float(pg.graph_error(g)), float(jpg.graph_error(jg)), rtol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_compose_pose_matches_reference(seed):
    rng = np.random.default_rng(seed)
    pose = np.concatenate([rng.uniform(-5000, 5000, (200, 2)), rng.uniform(-4, 4, (200, 1))],
                          1).astype(np.float32)
    rel = np.concatenate([rng.normal(0, 50, (200, 2)), rng.uniform(-4, 4, (200, 1))],
                         1).astype(np.float32)
    got = tfe.compose_pose(t(pose), t(rel)).numpy()
    ref = np.asarray(jfe.compose_pose(jnp.asarray(pose), jnp.asarray(rel)))
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=1e-5, atol=2e-3)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=2e-6)


def _reference_normal_equations(jg, nodes, anchor0, damping=1e-3, anchor_weight=1e6):
    """The reference's gradient and block-Jacobi diagonal at ``nodes``
    (conan_slam_tpu/graph/pose_graph.py:227-252, its own jnp lines: the
    step is a closure inside optimize)."""
    r, a, b = jpg._edge_residual_jacobians(nodes, jg.edges, jg.meas)
    omega = jg.info
    omega_r = jnp.where(jg.edge_mask[:, None], jnp.einsum("eab,eb->ea", omega, r), 0.0)
    i, j = jg.edges[:, 0], jg.edges[:, 1]
    grad = jnp.zeros_like(nodes)
    grad = grad.at[i].add(jnp.einsum("eba,eb->ea", a, omega_r))
    grad = grad.at[j].add(jnp.einsum("eba,eb->ea", b, omega_r))
    grad = grad.at[0].add(anchor_weight * (nodes[0] - anchor0))
    em = jg.edge_mask[:, None, None].astype(nodes.dtype)
    diag = jnp.zeros((nodes.shape[0], 3, 3), nodes.dtype)
    diag = diag.at[i].add(em * jnp.einsum("eba,ebc,ecd->ead", a, omega, a))
    diag = diag.at[j].add(em * jnp.einsum("eba,ebc,ecd->ead", b, omega, b))
    diag = diag + damping * jnp.eye(3, dtype=nodes.dtype)
    diag = diag.at[0].add(anchor_weight * jnp.eye(3, dtype=nodes.dtype))
    return np.asarray(-grad), np.asarray(diag)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gauss_newton_system_matches_reference(seed):
    g = _random_graph(seed)
    jg = to_jax(g)
    rng = np.random.default_rng(seed + 10)
    anchor0 = (g.nodes[0] + t(rng.normal(0, [1.0, 1.0, 0.01]).astype(np.float32)))
    plan = pg.scatter_plan(g.edges, g.nodes.shape[0])
    _, rhs, diag = pg._normal_equations(g, g.nodes, plan, anchor0, 1e-3, 1e6)
    jrhs, jdiag = _reference_normal_equations(jg, jg.nodes, jnp.asarray(anchor0.numpy()))
    # Each node's sums against the largest of its own block (the terms'
    # scale; a node of garbage edges only is exactly damping and zeros).
    for got, ref in ((rhs.numpy(), jrhs), (diag.numpy(), jdiag)):
        scale = np.abs(ref).reshape(ref.shape[0], -1).max(1)
        err = np.abs(got - ref).reshape(ref.shape[0], -1).max(1)
        assert np.all(err <= 1e-4 * scale), float((err / np.maximum(scale, 1e-30)).max())


@pytest.mark.parametrize("cg", [1, 3])
def test_a_few_cg_steps_match_reference(cg):
    # One Gauss-Newton iteration of a few CG steps from the same start:
    # the whole step (system, preconditioner, hvp, CG scalars) end to end.
    truth, odo, guess = _simulate_loop()
    g = _padded(_build_graph(truth, odo, guess, [(0, 39), (1, 38), (5, 33)]))
    got = pg.optimize(g, iterations=1, cg_iterations=cg).nodes.numpy()
    ref = np.asarray(jpg.optimize(to_jax(g), iterations=1, cg_iterations=cg).nodes)
    np.testing.assert_allclose(got[:, :2], ref[:, :2], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=0, atol=2e-5)


@pytest.mark.parametrize("shape", [(3,), (2,), (3, 3)])
def test_scatter_nodes_equals_index_add(shape):
    # On the CPU the fixed-order sum is index_add_'s sequential order (the
    # i ends in edge order, then the j ends), bit for bit; nodes no edge
    # reaches get 0.
    rng = np.random.default_rng(4)
    edges = t(rng.integers(0, 37, (300, 2))).long()
    edges[edges == 11] = 12                              # node 11: no edge
    rows = t(rng.normal(size=(300, 2) + shape).astype(np.float32) * 1e3)
    plan = pg.scatter_plan(edges, 40)
    got = pg.scatter_nodes(plan, rows)
    ref = torch.zeros((40,) + shape).index_add_(0, edges[:, 0], rows[:, 0])
    ref = ref.index_add_(0, edges[:, 1], rows[:, 1])
    assert torch.equal(got, ref)
    assert not got[11].any() and not got[37:].any()


def _kth_tie(score: np.ndarray, k: int) -> str:
    """A tie among finite scores at the k-th place, with its distance, or ''."""
    top = np.sort(score[np.isfinite(score)])[::-1]
    if len(top) <= k or top[k - 1] != top[k]:
        return ""
    return f"tie at place {k}: squared distance {-top[k - 1]}"


@pytest.mark.parametrize("seed,k", [(0, 16), (1, 64), (2, 400)])
def test_detect_loop_closures_matches_reference(seed, k):
    # The valid pairs equal as sets and in count; the masked slots hold
    # arbitrary pairs in both packages.
    rng = np.random.default_rng(seed)
    n = 120
    s = np.linspace(0, 6 * np.pi, n)
    nodes = np.stack([300 * np.sin(s) + rng.normal(0, 20, n),
                      300 * np.sin(2 * s / 3) + rng.normal(0, 20, n), s], 1).astype(np.float32)
    mask = rng.uniform(size=n) > 0.05
    kw = dict(max_candidates=k, radius=60.0, min_index_gap=10)
    pairs, pmask = pg.detect_loop_closures(t(nodes), t(mask), **kw)
    jpairs, jmask = jpg.detect_loop_closures(jnp.asarray(nodes), jnp.asarray(mask), **kw)
    got = {tuple(p) for p, m in zip(pairs.tolist(), pmask.tolist()) if m}
    ref = {tuple(p) for p, m in zip(np.asarray(jpairs).tolist(), np.asarray(jmask)) if m}
    assert int(pmask.sum()) == int(np.asarray(jmask).sum())
    d2 = ((nodes[:, None, :2] - nodes[None, :, :2]) ** 2).sum(-1)
    ii = np.arange(n)
    valid = ((d2 < 60.0**2) & (np.abs(ii[:, None] - ii[None]) >= 10) & mask[:, None]
             & mask[None] & (ii[:, None] < ii[None]))
    assert got == ref, _kth_tie(np.where(valid, -d2, -np.inf).ravel(), k) or "no tie at k"


@pytest.mark.parametrize("det", [False, True])
def test_build_graph_matches_reference(det):
    # On the reference's own closure draw; the valid closures equal as
    # sets, each valid edge's measurement and every node and mask equal.
    truth, est, valid, kw = _figure_eight()
    cfg, jcfg = tfe.ClosureConfig(**kw), jfe.ClosureConfig(**kw)
    key = jax.random.PRNGKey(5)
    det_nodes = est[::cfg.keyframe_stride] if det else None
    jg = jfe.build_graph(jnp.asarray(est), jnp.asarray(truth), jnp.asarray(valid), jcfg, key,
                         det_nodes=None if det_nodes is None else jnp.asarray(det_nodes))
    noise = t(jax.random.normal(key, (cfg.max_closures, 3), jnp.float32))
    g = tfe.build_graph(t(est), t(truth), t(valid), cfg, noise,
                        det_nodes=None if det_nodes is None else t(det_nodes))
    n = g.nodes.shape[0]
    np.testing.assert_array_equal(g.nodes.numpy(), np.asarray(jg.nodes))
    np.testing.assert_array_equal(g.node_mask.numpy(), np.asarray(jg.node_mask))
    np.testing.assert_array_equal(g.info.numpy(), np.asarray(jg.info))
    em, jem = g.edge_mask.numpy(), np.asarray(jg.edge_mask)
    assert em.sum() == jem.sum()
    np.testing.assert_array_equal(em[:n - 1], jem[:n - 1])
    np.testing.assert_array_equal(g.edges[:n - 1].numpy(), np.asarray(jg.edges)[:n - 1])
    np.testing.assert_allclose(g.meas[:n - 1].numpy(), np.asarray(jg.meas)[:n - 1], rtol=1e-5,
                               atol=2e-5)

    def closures(edges, meas, mask):
        return {tuple(e): m for e, m, k in zip(edges[n - 1:].tolist(), meas[n - 1:], mask[n - 1:])
                if k}

    got = closures(g.edges.numpy(), g.meas.numpy(), em)
    ref = closures(np.asarray(jg.edges), np.asarray(jg.meas), jem)
    assert got.keys() == ref.keys()
    # The draws follow the slot, and slots of equal pairs may differ in
    # order: compare each pair's measurement less its draw.
    sig = np.asarray([cfg.closure_sigma_xy] * 2 + [cfg.closure_sigma_th], np.float32)
    slot = {tuple(e): s for s, e in enumerate(g.edges[n - 1:].tolist())}
    jslot = {tuple(e): s for s, e in enumerate(np.asarray(jg.edges)[n - 1:].tolist())}
    for pair in got:
        np.testing.assert_allclose(got[pair] - noise.numpy()[slot[pair]] * sig,
                                   ref[pair] - noise.numpy()[jslot[pair]] * sig,
                                   rtol=1e-5, atol=2e-5)


def test_relax_rounds_rederive_odometry_from_relaxed_nodes():
    # R1 (conan_slam_tpu/graph/frontend.py:70-78), mirrored: with
    # init_nodes, the keyframe estimates are replaced before the odometry is
    # derived, so round 2's odometry measurements are the relative poses of
    # round 1's relaxed nodes.  Each round's result (one round, and two) is
    # held by the witness rule of tests/test_torch_longloop.py: the port's
    # own functions in float64 are the witness, the JAX package's float32
    # run of the same rounds the reference, and its spread the last round's
    # solve with the edges permuted.  Observed: round 1 nodes 7.0e-5 m
    # from the witness (JAX 1.0e-4), round 2 0.0131 m (JAX 0.0128).
    from test_torch_longloop import check_witness_rule

    from conan_slam_tpu.runner import metrics as jmetrics
    from conan_slam_tpu_torch.runner import metrics

    truth, est, valid, kw = _figure_eight()
    cfg = tfe.ClosureConfig(**kw)
    key = jax.random.PRNGKey(0)
    draws = t(np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, r),
                                                     (cfg.max_closures, 3), jnp.float32))
                        for r in range(2)]))

    def relax(dtype, rounds):
        return tfe.relax_trajectory(t(est).to(dtype), t(truth).to(dtype), t(valid), cfg,
                                    draws.to(dtype), iterations=4, rounds=rounds,
                                    detect_on_estimate=True)

    def pairs(g, n):
        edges, mask = np.asarray(g.edges)[n - 1:], np.asarray(g.edge_mask)[n - 1:]
        return {tuple(e) for e, m in zip(edges.tolist(), mask) if m}

    g1_opt = None
    for rounds in (1, 2):
        g, g_opt = relax(torch.float32, rounds)
        w, w_opt = relax(torch.float64, rounds)
        jg, jg_opt = jfe.relax_trajectory(jnp.asarray(est), jnp.asarray(truth),
                                          jnp.asarray(valid), jfe.ClosureConfig(**kw), key,
                                          iterations=4, rounds=rounds, detect_on_estimate=True)
        n = g.nodes.shape[0]
        if g1_opt is not None:
            assert torch.equal(g.nodes, g1_opt.nodes)
            assert torch.equal(g.meas[:n - 1],
                               pg.relative_pose(g1_opt.nodes[:-1], g1_opt.nodes[1:]))
        g1_opt = g_opt
        assert pairs(g, n) == pairs(w, n) == pairs(jg, n)
        perm = np.random.default_rng(0).permutation(jg.edges.shape[0])
        jg_perm = jg._replace(edges=jg.edges[perm], meas=jg.meas[perm], info=jg.info[perm],
                              edge_mask=jg.edge_mask[perm])
        jg_perm_opt = jpg.optimize(jg_perm, iterations=4, cg_iterations=max(60, n),
                                   chordal_init=rounds == 1)
        kf_true, kf_valid = truth[::cfg.keyframe_stride][:n], valid[::cfg.keyframe_stride][:n]

        def ate(nodes):
            return float(metrics.aligned_ate_rmse(t(kf_true).to(nodes.dtype), nodes,
                                                  t(kf_valid)))

        def jscores(gg):
            return (float(jpg.graph_error(gg)),
                    float(jmetrics.aligned_ate_rmse(jnp.asarray(kf_true), gg.nodes,
                                                    jnp.asarray(kf_valid))))

        (rc, ra), (pc, pa) = jscores(jg_opt), jscores(jg_perm_opt)
        check_witness_rule(g_opt.nodes.numpy(), float(pg.graph_error(g_opt)), ate(g_opt.nodes),
                           np.asarray(jg_opt.nodes), rc, ra, w_opt.nodes.numpy(),
                           float(pg.graph_error(w_opt)), ate(w_opt.nodes), abs(pc - rc),
                           abs(pa - ra))
