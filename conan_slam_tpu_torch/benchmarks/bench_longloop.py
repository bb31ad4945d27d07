"""BASELINE config 4 (port of benchmarks/bench_longloop.py): the long valet
tour, 5,000 landmarks, loop closure and pose-graph relaxation.

    python -m conan_slam_tpu_torch.benchmarks.bench_longloop [--steps N]
        [--landmarks N] [--device cuda|cpu]

Two stages, on the card unless ``--device cpu``:
  1. FILTER: the vehicle drives the star tour (``sim.world.star_waypoints``,
     a path that crosses itself many times) through the 5,000-landmark
     world (``sim.world.longloop_world``: the reference's
     ``random_world(PRNGKey(11), 5000)``; joint state D = 10,003, padded
     10,240, a dense P of ~420 MB), mapping from scratch with known
     association (``run_ekf_slam_precomputed``; H9 a frame).  Reports
     control steps/s, the filter's ATE and the mapped count.  Another size
     draws its world from ``random_world`` and says so.
  2. POSE GRAPH: a dead-reckoned keyframe odometry chain on the same tour's
     truth with simulated scan-match closures at its self-crossings
     (``graph.frontend.simulate_odometry_graph``), relaxed by chordal
     initialisation and Gauss-Newton (``graph.pose_graph.optimize``, 50
     iterations of 4 T CG steps).  Reports the closures, the aligned
     keyframe ATE and chi^2 before and after, and the relaxation's wall
     time.

Stage 1 times the run after a 60-step warm-up (the first launches); the
rollout (host numpy) is timed on its own.  The draws come from
``torch.Generator`` seeds 1 (the filter) and 2 (the graph).  Prints the
reference's line and returns its numbers as a dict.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

N_LANDMARKS = 5000
STEPS = 56_000
SEED = 11
CLOSURE = dict(odo_sigma_xy=0.5, odo_sigma_th=0.01, max_closures=256, min_index_gap=60)
GN_ITERATIONS = 50
CG_PER_NODE = 4


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def world_of(n_landmarks: int, device, waypoints=None):
    """The reference's stored world of ``n_landmarks`` where there is one,
    else one drawn from ``random_world`` (a different world, logged)."""
    from conan_slam_tpu_torch.sim.world import (
        LONGLOOP_SIZES,
        longloop_world,
        random_world,
        star_waypoints,
    )

    if n_landmarks in LONGLOOP_SIZES:
        return longloop_world(n_landmarks, device, waypoints)
    log(f"{n_landmarks} landmarks: no stored reference world; drawing one from "
        f"random_world(torch.Generator().manual_seed({SEED}))")
    world = random_world(torch.Generator().manual_seed(SEED), n_landmarks, device=device)
    wp = star_waypoints() if waypoints is None else waypoints
    return world._replace(waypoints=torch.as_tensor(wp, dtype=torch.float32, device=device))


def relax_bench_graph(truth, valid, noise=None, iterations: int = GN_ITERATIONS):
    """Stage 2 on ``truth`` (T, 3) / ``valid`` (T,): the bench's graph
    (``noise``: its ``GraphDraws`` or a generator) and its relaxation;
    returns ``(graph, relaxed graph, wall seconds)``."""
    from conan_slam_tpu_torch.graph import pose_graph as pg
    from conan_slam_tpu_torch.graph.frontend import ClosureConfig, simulate_odometry_graph

    sync = torch.cuda.synchronize if truth.is_cuda else (lambda: None)
    sync()
    t0 = time.perf_counter()
    g = simulate_odometry_graph(truth, valid, ClosureConfig(**CLOSURE), noise)
    g_opt = pg.optimize(g, iterations=iterations, cg_iterations=CG_PER_NODE * g.nodes.shape[0],
                        chordal_init=True)
    sync()
    return g, g_opt, time.perf_counter() - t0


def keyframe_ate(truth, valid, nodes) -> float:
    """Aligned ATE of keyframe ``nodes`` against the keyframes of the truth."""
    from conan_slam_tpu_torch.graph.frontend import ClosureConfig
    from conan_slam_tpu_torch.runner import metrics

    stride = ClosureConfig().keyframe_stride
    t = nodes.shape[0]
    return float(metrics.aligned_ate_rmse(truth[::stride][:t], nodes, valid[::stride][:t]))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--landmarks", type=int, default=N_LANDMARKS)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from conan_slam_tpu_torch.benchmarks import card_line
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.device import default_device
    from conan_slam_tpu_torch.graph import pose_graph as pg
    from conan_slam_tpu_torch.runner import metrics
    from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed

    device = torch.device(args.device) if args.device else default_device()
    print(card_line(device), flush=True)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    n_lm = args.landmarks
    world = world_of(n_lm, device)
    cfg = SlamConfig(max_landmarks=n_lm, max_obs=64)
    d = 3 + 2 * n_lm
    log(f"device {device}; D={d} (P ~{d * d * 4 / 2**30:.2f} GiB unpadded)")

    # Stage 1: the filter at the largest single-card state.
    t0 = time.perf_counter()
    roll = precompute_rollout(world, cfg, args.steps)
    rollout_s = time.perf_counter() - t0
    steps = roll[0][0].shape[0]
    warm = min(60, steps)
    run_ekf_slam_precomputed(world, cfg, torch.Generator(device=device).manual_seed(0), warm,
                             None, (tuple(a[:warm] for a in roll[0]),
                                    tuple(a[:warm // cfg.observe_interval] for a in roll[1])))
    sync()
    t0 = time.perf_counter()
    state, outs = run_ekf_slam_precomputed(
        world, cfg, torch.Generator(device=device).manual_seed(1), steps, None, roll)
    sync()
    wall = time.perf_counter() - t0
    ate_filter = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))

    # Stage 2: the dead-reckoned chain, its closures and the relaxation.
    truth, valid = outs.x_true, ~outs.done
    g, g_opt, relax_s = relax_bench_graph(truth, valid,
                                          torch.Generator(device=device).manual_seed(2))
    t = g.nodes.shape[0]
    n_closures = int(g.edge_mask[t - 1:].sum())
    res = {
        "filter_steps_per_s": steps / wall,
        "filter_ate_m": ate_filter,
        "mapped": int(state.n_active),
        "finite": bool(torch.isfinite(state.x).all() and torch.isfinite(outs.x_est).all()),
        "closures": n_closures,
        "aligned_ate_dead_reckoned_m": keyframe_ate(truth, valid, g.nodes),
        "aligned_ate_relaxed_m": keyframe_ate(truth, valid, g_opt.nodes),
        "chi2_dead_reckoned": float(pg.graph_error(g)),
        "chi2_relaxed": float(pg.graph_error(g_opt)),
        "relax_s": relax_s,
        "rollout_s": rollout_s,
    }
    print(f"longloop {n_lm}lm star tour: filter {res['filter_steps_per_s']:,.0f} steps/s "
          f"({wall:.2f}s), mapped={res['mapped']}, filter ATE={ate_filter:.2f} m; "
          f"pose-graph: {n_closures} closures, dead-reckoned alignedATE "
          f"{res['aligned_ate_dead_reckoned_m']:.1f} -> {res['aligned_ate_relaxed_m']:.1f} m "
          f"(chi2 {res['chi2_dead_reckoned']:.0f} -> {res['chi2_relaxed']:.0f}, "
          f"{relax_s:.1f}s)", flush=True)
    return res


if __name__ == "__main__":
    main()
