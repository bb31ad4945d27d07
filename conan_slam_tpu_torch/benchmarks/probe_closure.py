"""How much does pose-graph relaxation improve a drifted run without the
heading update? (port of benchmarks/probe_closure.py): one filter run,
then ``graph.frontend.relax_trajectory`` under five ClosureConfigs.

    python -m conan_slam_tpu_torch.benchmarks.probe_closure [--landmarks N]
        [--steps N] [--iterations N] [--cg N] [--device cuda|cpu]

The world is the reference's ``random_world(PRNGKey(11), 1000)``
(``sim.world.longloop_world``; another size draws one and says so) on the
default valet waypoints with the origin appended; ``SlamConfig(max_obs=64,
switch_heading_known=False)``, 28,000 steps through
``run_ekf_slam_precomputed`` (H9 a frame: D 2,003, padded 2,048) from
``torch.Generator`` seed 1, on the card unless ``--device cpu``.  Each
relaxation runs ``--iterations`` Gauss-Newton iterations (10) of ``--cg``
CG steps (50) on closure draws from generator seed 2 (the reference reads
these budgets from PG_ITERS / PG_CG).  One line a config: its closures,
the aligned keyframe ATE and chi^2 before and after.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

CONFIGS = (
    ("default", {}),
    ("loose-odo", dict(odo_sigma_xy=5.0, odo_sigma_th=0.1)),
    ("tight-closure", dict(closure_sigma_xy=0.1, closure_sigma_th=0.002)),
    ("more-closures", dict(max_closures=256, radius=300.0)),
    ("loose+more", dict(odo_sigma_xy=5.0, odo_sigma_th=0.1, max_closures=256, radius=300.0)),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--landmarks", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=28_000)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--cg", type=int, default=50)
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from conan_slam_tpu_torch.benchmarks import card_line
    from conan_slam_tpu_torch.benchmarks.bench_longloop import world_of
    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.device import default_device
    from conan_slam_tpu_torch.graph.frontend import ClosureConfig, relax_trajectory
    from conan_slam_tpu_torch.graph.pose_graph import graph_error
    from conan_slam_tpu_torch.runner import metrics
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam_precomputed
    from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y

    device = torch.device(args.device) if args.device else default_device()
    print(card_line(device), flush=True)
    wp = np.concatenate([np.stack([_WP_X, _WP_Y], axis=1), np.zeros((1, 2))]).astype(np.float32)
    world = world_of(args.landmarks, device, wp)
    cfg = SlamConfig(max_landmarks=args.landmarks, max_obs=64, switch_heading_known=False)
    _, outs = run_ekf_slam_precomputed(world, cfg, torch.Generator(device=device).manual_seed(1),
                                       args.steps)
    est, true, valid = outs.x_est, outs.x_true, ~outs.done
    res = {"ate_raw_m": float(metrics.ate_rmse(true, est, valid)), "configs": {}}
    print(f"full ATE raw: {res['ate_raw_m']:.2f} m", flush=True)

    for tag, kw in CONFIGS:
        ccfg = ClosureConfig(**kw)
        g, g_opt = relax_trajectory(est, true, valid, ccfg,
                                    torch.Generator(device=device).manual_seed(2),
                                    iterations=args.iterations, cg_iterations=args.cg)
        stride = ccfg.keyframe_stride
        n = g_opt.nodes.shape[0]
        kf_true, kf_valid = true[::stride][:n], valid[::stride][:n] & g_opt.node_mask

        def kf_ate(nodes):
            return float(metrics.aligned_ate_rmse(kf_true, nodes[:kf_true.shape[0]], kf_valid))

        ncl = int(g.edge_mask.sum()) - int(g_opt.node_mask.sum() - 1)
        r = dict(closures=ncl, ate_before_m=kf_ate(g.nodes), ate_after_m=kf_ate(g_opt.nodes),
                 chi2_before=float(graph_error(g)), chi2_after=float(graph_error(g_opt)))
        res["configs"][tag] = r
        print(f"{tag:14s}: closures={ncl:4d} alignedkfATE {r['ate_before_m']:7.2f} -> "
              f"{r['ate_after_m']:7.2f} m, chi2 {r['chi2_before']:9.1f} -> "
              f"{r['chi2_after']:9.1f}", flush=True)
    return res


if __name__ == "__main__":
    main()
