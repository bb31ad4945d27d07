"""The JAX package's loop closure (BASELINE config 4), as the port's parity
data.

``benchmarks/bench_longloop.py`` drives the 5,000-landmark star tour
(``random_world(PRNGKey(11), 5000)``, ``star_waypoints()``, 56,004 steps)
and relaxes a dead-reckoned keyframe chain with closures on its truth:

    g = simulate_odometry_graph(truth, valid, ClosureConfig(odo_sigma_xy=0.5,
            odo_sigma_th=0.01, max_closures=256, min_index_gap=60), PRNGKey(2))
    optimize(g, iterations=50, cg_iterations=4 T, chordal_init=True)

whose draws are ``k_odo, k_cl = split(PRNGKey(2))``, ``normal(k_odo,
(T - 1, 3))`` and ``normal(k_cl, (C, 3))`` (graph/frontend.py:164-199).
``bench_graph`` rebuilds that graph and its draws; the truth is the numpy
rollout (``use_native=False``), which the port's rollout equals bit for bit,
so both packages solve the same problem.  ``python
tests/longloop_reference.py`` writes ``conan_slam_tpu_torch/sim/data/``:

* ``random_world_key11_5000.npy``, ``random_world_key11_1000.npy``: the
  landmarks of ``random_world(PRNGKey(11), n)`` (bench_longloop.py:68,
  probe_closure.py:38, smoke_compile.py:292);
* ``longloop_key2.npz``: the bench graph's draws (``odo``, ``closure``),
  its pairs and their mask, the dead-reckoned nodes and the relaxed ones
  at the bench's budget in float32 (``nodes_f32``), in float32 with the
  edges in a permuted order (``nodes_perm``: the same problem summed in
  another order, the package's own float32 spread) and in float64 (the
  witness: every float leaf of the float32 graph cast, solved with
  ``jax_enable_x64``), each one's chi^2 and aligned keyframe ATE; and the
  valet example's ``--loop-closure`` on the seed-42 run
  (``valet_seed42.npz``'s known ``x_est``): its closure draw
  ``normal(fold_in(PRNGKey(1), 0), (64, 3))``, chi^2 before and after.

Takes ~3 min on the CPU (each bench solve ~30-40 s).
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "conan_slam_tpu_torch", "sim", "data")
DATA = os.path.join(DATA_DIR, "longloop_key2.npz")
WORLD_KEY = 11
SIZES = (5000, 1000)
STEPS = 56_004           # bench_longloop's 56,000 steps, rounded up to whole frames
GRAPH_KEY = 2
VALET_KEY = 1
PERM_SEED = 0


def world_path(n: int) -> str:
    return os.path.join(DATA_DIR, f"random_world_key{WORLD_KEY}_{n}.npy")


def bench_closure_config(cls):
    """bench_longloop.py's ClosureConfig, from the package's class ``cls``."""
    return cls(odo_sigma_xy=0.5, odo_sigma_th=0.01, max_closures=256, min_index_gap=60)


def star_truth(steps: int = STEPS, use_native: bool = False):
    """The JAX package's truth rollout of the star tour at config 4's
    SlamConfig: ``TruthRollout``."""
    from benchmarks.bench_longloop import star_waypoints
    from conan_slam_tpu.config import SlamConfig
    from conan_slam_tpu.sim.precompute import rollout_truth

    return rollout_truth(star_waypoints(), SlamConfig(max_landmarks=5000, max_obs=64), steps,
                         use_native=use_native)


def graph_draws(t: int, c: int, key: int = GRAPH_KEY):
    """``simulate_odometry_graph``'s draws from PRNGKey(key): (odo (t-1, 3),
    closure (c, 3)) float32 numpy arrays."""
    import jax
    import jax.numpy as jnp

    k_odo, k_cl = jax.random.split(jax.random.PRNGKey(key))
    return (np.asarray(jax.random.normal(k_odo, (t - 1, 3), jnp.float32)),
            np.asarray(jax.random.normal(k_cl, (c, 3), jnp.float32)))


def relax_draws(c: int, rounds: int = 1, key: int = VALET_KEY):
    """``relax_trajectory``'s closure draws from PRNGKey(key): (rounds, c, 3)."""
    import jax
    import jax.numpy as jnp

    k = jax.random.PRNGKey(key)
    return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(k, r), (c, 3), jnp.float32))
                     for r in range(rounds)])


def bench_graph(truth, valid):
    """The JAX bench graph on ``truth`` (T, 3) / ``valid`` (T,) numpy arrays."""
    import jax
    import jax.numpy as jnp

    from conan_slam_tpu.graph.frontend import ClosureConfig, simulate_odometry_graph

    ccfg = bench_closure_config(ClosureConfig)
    return simulate_odometry_graph(jnp.asarray(truth), jnp.asarray(valid), ccfg,
                                   jax.random.PRNGKey(GRAPH_KEY))


def permuted(g, seed: int = PERM_SEED):
    """``g`` with its edges (and their measurements, information and mask)
    in a fixed random order: the same problem, summed in another order."""
    perm = np.random.default_rng(seed).permutation(g.edges.shape[0])
    return g._replace(edges=g.edges[perm], meas=g.meas[perm], info=g.info[perm],
                      edge_mask=g.edge_mask[perm])


def as_f64(g):
    """``g`` with every float leaf in float64 (needs jax_enable_x64)."""
    import jax.numpy as jnp

    return type(g)(*(jnp.asarray(np.asarray(a), jnp.float64) if np.asarray(a).dtype == np.float32
                     else a for a in g))


def solve(g, iterations: int, cg_iterations: int):
    """``optimize(g, iterations, cg_iterations, chordal_init=True)``'s nodes (numpy)."""
    from conan_slam_tpu.graph import pose_graph as pg

    return np.asarray(pg.optimize(g, iterations=iterations, cg_iterations=cg_iterations,
                                  chordal_init=True).nodes)


def scores(g, nodes, kf_true, kf_valid):
    """(chi^2, aligned ATE) of ``g`` at ``nodes``, in float64 numpy."""
    import jax.numpy as jnp

    from conan_slam_tpu.graph import pose_graph as pg
    from conan_slam_tpu.runner import metrics

    gg = g._replace(nodes=jnp.asarray(nodes, g.nodes.dtype))
    return (float(pg.graph_error(gg)),
            float(metrics.aligned_ate_rmse(jnp.asarray(kf_true, gg.nodes.dtype), gg.nodes,
                                           jnp.asarray(kf_valid))))


def main() -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, REPO)
    import time

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from conan_slam_tpu.graph.frontend import ClosureConfig, relax_trajectory
    from conan_slam_tpu.graph.pose_graph import graph_error
    from conan_slam_tpu.sim.world import random_world

    for n in SIZES:
        lm = np.asarray(random_world(jax.random.PRNGKey(WORLD_KEY), n).landmarks, np.float32)
        np.save(world_path(n), lm)
        print(world_path(n), os.path.getsize(world_path(n)), "bytes")

    roll = star_truth()
    truth, valid = roll.x_true, ~roll.done
    g = bench_graph(truth, valid)
    t, c = g.nodes.shape[0], 256
    stride = ClosureConfig().keyframe_stride
    kf_true, kf_valid = truth[::stride][:t], valid[::stride][:t]
    odo, closure = graph_draws(t, c)
    out = {"odo": odo, "closure": closure, "pairs": np.asarray(g.edges[t - 1:], np.int16),
           "pair_mask": np.asarray(g.edge_mask[t - 1:]), "nodes_dr": np.asarray(g.nodes)}
    out["chi2_dr"], out["ate_dr"] = scores(g, out["nodes_dr"], kf_true, kf_valid)
    budget = (50, 4 * t)
    for name, gg in (("f32", g), ("perm", permuted(g))):
        t0 = time.perf_counter()
        out[f"nodes_{name}"] = solve(gg, *budget)
        out[f"chi2_{name}"], out[f"ate_{name}"] = scores(g, out[f"nodes_{name}"], kf_true,
                                                         kf_valid)
        print(f"{name}: chi2 {out[f'chi2_{name}']:.2f}, ATE {out[f'ate_{name}']:.3f} m "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # The valet example's --loop-closure on the seed-42 run (known association).
    valet = np.load(os.path.join(DATA_DIR, "valet_seed42.npz"))
    ccfg = ClosureConfig()
    vg, vopt = relax_trajectory(jnp.asarray(valet["x_est_known"]), jnp.asarray(valet["x_true"]),
                                jnp.asarray(~valet["done_known"]), ccfg,
                                jax.random.PRNGKey(VALET_KEY))
    out["valet_closure"] = relax_draws(ccfg.max_closures)
    out["valet_chi2"] = np.asarray([float(graph_error(vg)), float(graph_error(vopt))])
    out["valet_nodes"] = np.asarray(vopt.nodes)
    print(f"valet example: chi2 {out['valet_chi2'][0]:.1f} -> {out['valet_chi2'][1]:.1f}")

    # The float64 witness, last: jax_enable_x64 changes the package's
    # default dtypes, so every float32 result above is computed first.
    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    g64 = as_f64(g)
    out["nodes_f64"] = solve(g64, *budget)
    out["chi2_f64"], out["ate_f64"] = scores(g64, out["nodes_f64"], kf_true, kf_valid)
    print(f"f64: chi2 {out['chi2_f64']:.2f}, ATE {out['ate_f64']:.3f} m "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    for k in [k for k in out if k.startswith(("chi2", "ate"))]:
        out[k] = np.float64(out[k])
    np.savez_compressed(DATA, **out)
    print(DATA, os.path.getsize(DATA), "bytes")


if __name__ == "__main__":
    main()
