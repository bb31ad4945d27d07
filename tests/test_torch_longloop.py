"""Port parity for BASELINE config 4, the long loop: the star tour's truth
and worlds, the bench's stage 2 (the dead-reckoned chain, its closures and
the relaxation) by the float64 witness rule, the committed full-budget
JAX outputs, stage 1 on the first 500 landmarks against the JAX driver,
and the port-side bench_longloop, probe_closure and the example's
--loop-closure at tiny sizes on the CPU.

The witness rule (whole solves amplify float32 rounding: at the bench's
budget the JAX package's own float32 relaxation lies 5.61 m (largest) /
3.84 m (median) from its float64 one, tests/longloop_reference.py): the
port's float32 nodes lie no further from a float64 witness than twice the
JAX package's float32 nodes do, in the largest and the median node
distance, x/y and heading apart; chi^2 and the aligned keyframe ATE no
further than the larger of twice the JAX run's distance and the JAX
package's own float32 spread, measured as its float32 solve against the
same solve with the edges in another order (``permuted``; the same
problem summed in another order).  At the bench's budget that spread is
0.0046 in chi^2 and 0.0032 m in ATE (nodes 0.073 m; the committed runs of
tests/longloop_reference.py), far under twice the JAX run's distance from
the witness (1.30 and 0.289 m), which therefore sets those bounds; the
reduced-budget test measures its own.  Here the witness is the port's own
functions in float64 on every float leaf of the same graph (its functions
are held to the JAX package one by one in tests/test_torch_pose_graph.py);
the committed one is the JAX package's (jax_enable_x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import longloop_reference as ref
from conan_slam_tpu.config import SlamConfig as JSlamConfig
from conan_slam_tpu.runner.loop import run_ekf_slam_precomputed as j_run
from conan_slam_tpu.sim.precompute import rollout_observations as j_rollout_observations
from conan_slam_tpu.sim.world import World as JWorld, random_world as j_random_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.graph import frontend as fe
from conan_slam_tpu_torch.graph import pose_graph as pg
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed
from conan_slam_tpu_torch.sim.precompute import rollout_observations, rollout_truth
from conan_slam_tpu_torch.sim.world import longloop_world, star_waypoints

torch.set_num_threads(2)

CFG4 = dict(max_landmarks=5000, max_obs=64)


def t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def truth():
    roll = rollout_truth(star_waypoints(), SlamConfig(**CFG4), ref.STEPS)
    return roll


@pytest.fixture(scope="module")
def data():
    return np.load(ref.DATA)


def bench_graph(roll, data) -> pg.PoseGraph:
    """The bench's graph in the port, on the JAX run's own draws."""
    ccfg = ref.bench_closure_config(fe.ClosureConfig)
    return fe.simulate_odometry_graph(t(roll.x_true), t(~roll.done), ccfg,
                                      fe.GraphDraws(t(data["odo"]), t(data["closure"])))


def node_distances(a, b) -> dict:
    """The largest and median node distance of two (T, 3) node sets, in x/y
    (m) and heading (rad, wrapped)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dxy = np.linalg.norm(a[:, :2] - b[:, :2], axis=1)
    dth = np.abs((a[:, 2] - b[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return {"xy_max": dxy.max(), "xy_median": np.median(dxy), "th_max": dth.max(),
            "th_median": np.median(dth)}


def check_witness_rule(nodes, chi2, ate, ref_nodes, ref_chi2, ref_ate, wit_nodes, wit_chi2,
                       wit_ate, spread_chi2, spread_ate) -> dict:
    """The witness rule (module docstring); returns every distance."""
    got, lim = node_distances(nodes, wit_nodes), node_distances(ref_nodes, wit_nodes)
    out = {"nodes": got, "reference_nodes": lim}
    for k in got:
        assert got[k] <= 2.0 * lim[k], (k, got[k], lim[k])
    for name, v, r, w, s in (("chi2", chi2, ref_chi2, wit_chi2, spread_chi2),
                             ("ate", ate, ref_ate, wit_ate, spread_ate)):
        bound = max(2.0 * abs(r - w), s)
        out[name] = (abs(v - w), bound)
        assert abs(v - w) <= bound, (name, v, r, w, s)
    return out


def as_f64(g):
    return type(g)(*(a.double() if a.is_floating_point() else a for a in g))


def test_star_truth_and_worlds_match_reference(truth):
    # The port's rollout is the reference's numpy path, bit for bit, over
    # the whole 56,004-step tour.  The reference's native rollout (where it
    # builds) rounds sin and cos in another libm: observed 0.0117 m and
    # 5.8e-5 rad from the numpy path at ~5 km over the tour (the steering
    # loop keeps the ulps from growing), bound 0.05 m and 5e-4 rad; its
    # course flags equal.
    jt = ref.star_truth(use_native=False)
    for a, b in zip(truth, jt):
        np.testing.assert_array_equal(a, b)
    jn = ref.star_truth(use_native=True)
    np.testing.assert_allclose(truth.x_true[:, :2], jn.x_true[:, :2], rtol=0, atol=0.05)
    np.testing.assert_allclose(truth.x_true[:, 2], jn.x_true[:, 2], rtol=0, atol=5e-4)
    np.testing.assert_array_equal(truth.done, jn.done)
    from benchmarks.bench_longloop import star_waypoints as j_star

    np.testing.assert_array_equal(star_waypoints(), j_star())
    for n in ref.SIZES:
        lm = np.asarray(j_random_world(jax.random.PRNGKey(ref.WORLD_KEY), n).landmarks)
        np.testing.assert_array_equal(longloop_world(n, "cpu").landmarks.numpy(), lm)
    with pytest.raises(ValueError, match="random_world"):
        longloop_world(500, "cpu")


def test_chunked_observation_rollout_equals_reference(truth):
    # The observation rollout, formed a chunk of frames at a time, equals
    # the reference's whole-array numpy path bit for bit (the first 700
    # frames of the tour at 5,000 landmarks, a ragged last chunk).
    lm = np.load(ref.world_path(5000))
    x = truth.x_true[:700 * 6]
    got = rollout_observations(x, lm, 2000.0, 64, 6)
    jo = j_rollout_observations(x, lm, 2000.0, 64, 6, use_native=False)
    for a, b in zip(got, jo):
        np.testing.assert_array_equal(a, b)


def test_bench_graph_matches_reference(truth, data):
    # The bench's graph on the JAX run's draws: the dead-reckoned chain
    # within float32 ulps of the JAX one (sin and cos of the two libms,
    # 1,120 compositions at ~5 km: observed 6.1e-4 m), the closures equal
    # as a set and in count, the graph's chi^2 within rtol 1e-4.
    g = bench_graph(truth, data)
    n = g.nodes.shape[0]
    assert n == data["nodes_dr"].shape[0] == 1121
    np.testing.assert_allclose(g.nodes[:, :2].numpy(), data["nodes_dr"][:, :2], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(g.nodes[:, 2].numpy(), data["nodes_dr"][:, 2], rtol=0, atol=2e-5)
    got = {tuple(p) for p, m in zip(g.edges[n - 1:].tolist(), g.edge_mask[n - 1:].tolist()) if m}
    want = {tuple(p) for p, m in zip(data["pairs"].tolist(), data["pair_mask"]) if m}
    assert got == want and len(got) == int(data["pair_mask"].sum()) == 191
    np.testing.assert_allclose(float(pg.graph_error(g)), float(data["chi2_dr"]), rtol=1e-4)


def test_committed_outputs_are_consistent(truth, data):
    # The full budget's committed JAX outputs: shapes, and each chi^2 and
    # aligned ATE equal to the port's on the committed nodes (rtol 1e-4: a
    # sum of 1,376 residual terms; 1e-4 m on an ATE of ~30 m); the float64
    # witness's distances from the float32 runs as the module says.
    g = bench_graph(truth, data)
    n = g.nodes.shape[0]
    kf_true, kf_valid = t(truth.x_true[::50][:n]), t(~truth.done[::50][:n])
    assert data["odo"].shape == (n - 1, 3) and data["closure"].shape == (256, 3)
    assert data["pairs"].shape == (256, 2) and data["pair_mask"].shape == (256,)
    for name in ("dr", "f32", "perm", "f64"):
        nodes = data[f"nodes_{name}"]
        assert nodes.shape == (n, 3) and np.isfinite(nodes).all()
        gg = g._replace(nodes=t(nodes)) if name != "f64" else as_f64(g)._replace(nodes=t(nodes))
        np.testing.assert_allclose(float(pg.graph_error(gg)), float(data[f"chi2_{name}"]),
                                   rtol=1e-4)
        ate = float(metrics.aligned_ate_rmse(kf_true.to(gg.nodes.dtype), gg.nodes, kf_valid))
        np.testing.assert_allclose(ate, float(data[f"ate_{name}"]), rtol=0, atol=1e-4)
    assert data["nodes_f64"].dtype == np.float64
    assert float(data["ate_f32"]) < 0.2 * float(data["ate_dr"])
    d32 = node_distances(data["nodes_f32"], data["nodes_f64"])
    dperm = node_distances(data["nodes_f32"], data["nodes_perm"])
    assert 1.0 < d32["xy_max"] < 20.0 and dperm["xy_max"] < 0.1 * d32["xy_max"], (d32, dperm)


@pytest.mark.parametrize("iterations,cg_per_node", [(3, 1)])
def test_bench_stage2_against_witness(truth, data, iterations, cg_per_node):
    # Stage 2 at a reduced budget (3 Gauss-Newton iterations of T CG steps
    # after the three chordal passes), the port's float32 against the
    # port's float64 witness, by the witness rule against the JAX package's
    # float32 solve at the same budget (its spread: the same solve with the
    # edges permuted).
    g = bench_graph(truth, data)
    n = g.nodes.shape[0]
    budget = dict(iterations=iterations, cg_iterations=cg_per_node * n, chordal_init=True)
    kf_true, kf_valid = t(truth.x_true[::50][:n]), t(~truth.done[::50][:n])

    def scores(gg, nodes):
        gg = gg._replace(nodes=nodes)
        return (float(pg.graph_error(gg)),
                float(metrics.aligned_ate_rmse(kf_true.to(nodes.dtype), nodes, kf_valid)))

    got = pg.optimize(g, **budget).nodes
    wit = pg.optimize(as_f64(g), **budget).nodes
    jg = ref.bench_graph(truth.x_true, ~truth.done)
    jnodes = t(ref.solve(jg, iterations, cg_per_node * n))
    jperm = t(ref.solve(ref.permuted(jg), iterations, cg_per_node * n))
    (c, a), (rc, ra), (pc, pa) = (scores(g, x) for x in (got, jnodes, jperm))
    wc, wa = scores(as_f64(g), wit)
    out = check_witness_rule(got.numpy(), c, a, jnodes.numpy(), rc, ra, wit.numpy(), wc, wa,
                             abs(pc - rc), abs(pa - ra))
    print(out)


def test_stage1_first_500_landmarks_match_reference(monkeypatch):
    # Stage 1's path (known association, mapping from scratch, max_obs 64)
    # on the first 500 landmarks of the committed world and the star tour,
    # 600 steps, on the JAX run's own draws: equal map sizes every step
    # and the pose trace within 2e-3 m (the slice test's bound).  Features
    # founded at 1-2 km carry float32 rounding through their lever arm
    # (after 5 frames the two packages' map means already differ by 0.06
    # m), so the means and P are held by a float64 witness, the port's own
    # plain versions in float64: the port no further from it than twice the
    # JAX run, in the pose trace, the mean and P (each entry over its scale
    # sqrt(P_ii P_jj)).  Observed: port 3.1e-4 m / 0.022 m / 0.023, JAX
    # 1.2e-3 / 0.067 / 0.029.
    from conan_slam_tpu_torch.filters.ekf.state import init_state
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.sim.world import world_from_numpy

    lm = np.load(ref.world_path(5000))[:500]
    wp = star_waypoints()
    kw = dict(max_landmarks=500, max_obs=64)
    cfg, jcfg = SlamConfig(**kw), JSlamConfig(**kw)
    world = world_from_numpy(lm, wp, "cpu")
    roll = precompute_rollout(world, cfg, 600)
    jroll = tuple(tuple(jnp.asarray(a.numpy()) for a in part) for part in roll)
    key = jax.random.PRNGKey(0)
    jstate, jouts = j_run(JWorld(jnp.asarray(lm), jnp.asarray(wp)), jcfg, key, n_steps=600,
                          precomputed=jroll)
    nz = roll[1][0].shape[1]
    k_ctrl, k_obs = jax.random.split(key)
    ctrl = t(jax.random.normal(k_ctrl, (100, 6, 2), jnp.float32))
    obs = t(jax.random.normal(k_obs, (100, nz, 2), jnp.float32))
    state, outs = run_ekf_slam_precomputed(world, cfg, None, 600, None, roll, ctrl_noise=ctrl,
                                           obs_noise=obs)
    assert state.x.shape[0] == np.asarray(jstate.x).shape[0] == 1024
    np.testing.assert_array_equal(outs.n_active.numpy(), np.asarray(jouts.n_active))
    assert int(state.n_active) > 0
    np.testing.assert_allclose(outs.x_est.numpy(), np.asarray(jouts.x_est), rtol=0, atol=2e-3)

    make_noise = loop.make_noise
    monkeypatch.setattr(loop, "make_noise", lambda *a, **k: type(make_noise(*a, **k))(
        *(v.double() for v in make_noise(*a, **k))))
    st0 = init_state(500, 500, device="cpu")
    wit, wouts = run_ekf_slam_precomputed(
        world, cfg, None, 600, st0._replace(x=st0.x.double(), p=st0.p.double()),
        tuple(tuple(a.double() if a.is_floating_point() else a for a in part) for part in roll),
        ctrl_noise=ctrl.double(), obs_noise=obs.double(), plain=True)
    assert wit.p.dtype == torch.float64
    np.testing.assert_array_equal(wouts.n_active.numpy(), outs.n_active.numpy())
    w = wit.p.numpy()
    scale = np.sqrt(np.outer(np.diag(w), np.diag(w))) + 1e-6
    for name, got, jref, wv, sc in (
            ("pose trace", outs.x_est.numpy(), np.asarray(jouts.x_est), wouts.x_est.numpy(), 1.0),
            ("mean", state.x.numpy(), np.asarray(jstate.x), wit.x.numpy(), 1.0),
            ("P", state.p.numpy(), np.asarray(jstate.p), w, scale)):
        d_port, d_ref = (np.abs(got - wv) / sc).max(), (np.abs(jref - wv) / sc).max()
        assert d_port <= 2.0 * d_ref, (name, d_port, d_ref)
    # P's asymmetry: augmentation forms a new feature's blocks (i, j) and
    # (j, i) as separate products, rounded apart, in both packages (the
    # reference's asym(P) < 1e-4 gate is the full map's, where nothing is
    # augmented).  The port's no larger than twice the JAX run's, absolute
    # and over each entry's scale.  Observed: port 1.1e-3 / 0.020, JAX
    # 7.0e-4 / 0.026.
    p, jp = state.p.numpy(), np.asarray(jstate.p)
    jscale = np.sqrt(np.outer(np.diag(jp), np.diag(jp))) + 1e-6
    pscale = np.sqrt(np.outer(np.diag(p), np.diag(p))) + 1e-6
    for d_port, d_ref in ((np.abs(p - p.T).max(), np.abs(jp - jp.T).max()),
                          ((np.abs(p - p.T) / pscale).max(), (np.abs(jp - jp.T) / jscale).max())):
        assert 0.0 < d_port <= 2.0 * d_ref, (d_port, d_ref)


def test_port_scripts_run_on_the_cpu(capsys):
    # The port-side bench_longloop (a stored world and a drawn one),
    # probe_closure and the example's --loop-closure at tiny sizes.
    from conan_slam_tpu_torch.benchmarks import bench_longloop, probe_closure
    from conan_slam_tpu_torch.examples import valet_loop

    # At least 16 keyframes (800 steps): the closure search takes the top
    # 256 of the T^2 pairs, in both packages.
    res = bench_longloop.main(["--steps", "900", "--landmarks", "1000", "--device", "cpu"])
    assert res["finite"] and res["mapped"] > 0 and res["relax_s"] > 0
    assert res["chi2_relaxed"] <= res["chi2_dead_reckoned"]
    res = bench_longloop.main(["--steps", "900", "--landmarks", "40", "--device", "cpu"])
    assert res["finite"]
    cap = capsys.readouterr()
    assert "no stored reference world" in cap.err and "longloop 1000lm star tour" in cap.out
    res = probe_closure.main(["--landmarks", "40", "--steps", "900", "--iterations", "2",
                              "--cg", "5", "--device", "cpu"])
    assert set(res["configs"]) == {name for name, _ in probe_closure.CONFIGS}
    assert all(np.isfinite(r["chi2_after"]) for r in res["configs"].values())
    res = valet_loop.main(["--loop-closure", "--steps", "1200", "--device", "cpu"])
    assert res["chi2_after"] <= res["chi2_before"] + 1e-6
    out = capsys.readouterr().out
    assert "pose graph     : chi2" in out
