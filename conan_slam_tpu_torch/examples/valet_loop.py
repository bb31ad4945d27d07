"""Example: the canonical valet-parking loop through the port's EKF or,
with ``--pf``, FastSLAM 2.0.

    python -m conan_slam_tpu_torch.examples.valet_loop [--pf] [--gated]
        [--no-heading] [--steps N] [--seed S] [--loop-closure]
        [--device cuda|cpu]

Runs ``runner.loop.run_ekf_slam`` (``run_pf_slam`` with ``--pf``) on the
default world (the card unless ``--device cpu``), with noise drawn from a
``torch.Generator`` seeded with ``--seed``, and prints when the course
ended, the ATE, the mapped landmarks and the wall time.  With
``--loop-closure`` it then relaxes the estimated trajectory with the pose
graph (``graph.frontend.relax_trajectory`` at the default ClosureConfig,
closure draws from generator seed 1) and prints chi^2 before and after.

``main(argv, ctrl_noise=, obs_noise=, closure_noise=)`` takes the EKF's
draws (as ``run_ekf_slam`` does) and the closure draws (as
``relax_trajectory`` does) in place of the generators'.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None, ctrl_noise=None, obs_noise=None, closure_noise=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--pf", action="store_true", help="run FastSLAM 2.0 instead of the EKF")
    ap.add_argument("--gated", action="store_true",
                    help="gated nearest-neighbour association (EKF)")
    ap.add_argument("--no-heading", action="store_true", help="no heading observation")
    ap.add_argument("--steps", type=int, default=25_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loop-closure", action="store_true",
                    help="relax the trajectory with the pose-graph back end")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.device import default_device
    from conan_slam_tpu_torch.runner import metrics
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam, run_pf_slam
    from conan_slam_tpu_torch.sim.world import default_world

    device = torch.device(args.device) if args.device else default_device()
    cfg = SlamConfig(switch_association_known=not args.gated,
                     switch_heading_known=not args.no_heading)
    world = default_world(device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    t0 = time.perf_counter()
    if args.pf:
        carry, outs = run_pf_slam(world, cfg, gen, args.steps)
    else:
        carry, outs = run_ekf_slam(world, cfg, gen, args.steps, ctrl_noise=ctrl_noise,
                                   obs_noise=obs_noise)
    done = outs.done.cpu()
    wall = time.perf_counter() - t0

    res = dict(done_at=int(done.to(torch.int8).argmax()) if bool(done.any()) else args.steps,
               ate=float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done)),
               mapped=int(carry.ens.n_active if args.pf else carry.state.n_active), wall_s=wall)
    print("estimator      : " + ("FastSLAM 2.0" if args.pf else "EKF-SLAM"
                                 + (" (gated association)" if args.gated else "")))
    print(f"course complete: step {res['done_at']} / {args.steps}")
    print(f"ATE RMSE       : {res['ate']:.3f} m")
    print(f"mapped features: {res['mapped']} / {world.num_landmarks}")
    print(f"wall           : {wall:.1f} s on {device}")

    if args.loop_closure:
        from conan_slam_tpu_torch.graph.frontend import ClosureConfig, relax_trajectory
        from conan_slam_tpu_torch.graph.pose_graph import graph_error

        noise = (closure_noise if closure_noise is not None
                 else torch.Generator(device=device).manual_seed(1))
        t0 = time.perf_counter()
        g, g_opt = relax_trajectory(outs.x_est, outs.x_true, ~outs.done, ClosureConfig(), noise)
        res.update(chi2_before=float(graph_error(g)), chi2_after=float(graph_error(g_opt)),
                   relax_s=time.perf_counter() - t0, graph=g, relaxed=g_opt)
        print(f"pose graph     : chi2 {res['chi2_before']:.1f} -> {res['chi2_after']:.1f}")
    return res


if __name__ == "__main__":
    main()
