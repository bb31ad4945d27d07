"""Example: the canonical valet-parking loop through the port's EKF or,
with ``--pf``, FastSLAM 2.0.

    python -m conan_slam_tpu_torch.examples.valet_loop [--pf] [--gated]
        [--no-heading] [--steps N] [--seed S] [--device cuda|cpu]

Runs ``runner.loop.run_ekf_slam`` (``run_pf_slam`` with ``--pf``) on the
default world (the card unless ``--device cpu``), with noise drawn from a
``torch.Generator`` seeded with ``--seed``, and prints when the course
ended, the ATE, the mapped landmarks and the wall time.
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--pf", action="store_true", help="run FastSLAM 2.0 instead of the EKF")
    ap.add_argument("--gated", action="store_true",
                    help="gated nearest-neighbour association (EKF)")
    ap.add_argument("--no-heading", action="store_true", help="no heading observation")
    ap.add_argument("--steps", type=int, default=25_000)
    ap.add_argument("--seed", type=int, default=0)
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
    carry, outs = (run_pf_slam if args.pf else run_ekf_slam)(world, cfg, gen, args.steps)
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
    return res


if __name__ == "__main__":
    main()
