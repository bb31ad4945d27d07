"""Config-2 ATE seed sweep (port of benchmarks/seed_sweep_gated.py): gated
NN association, 500 landmarks, mapping from scratch, the port on the card
against the defect-fixed native C++ gated baseline on the same world.

    python -m conan_slam_tpu_torch.benchmarks.seed_sweep_gated [n_seeds]

N seeds (default 12) of ``bench_gated``'s world (``benchmarks.world.
gated_world``: the reference's ``random_world(PRNGKey(7), 500)``) through
the port's precomputed driver (H15 then H10 a frame; the noise from a
``torch.Generator`` seeded with the seed, where the reference took
``PRNGKey(seed)``) and through the native baseline
(``conan_slam_tpu_torch.native.run_ekf_baseline``: SIMD, gated with the
config's gates, ``max_obs`` 64).  As in ``seed_sweep``, the claim under
test is distributional.  Prints the reference's table, P(port seed beats
native seed), the per-seed lists and the port's mapped counts.

The native runs go on SWEEP_WORKERS threads (default 1) beside the port's
runs, as in ``seed_sweep``.  Knobs, as the reference's: GATED_STEPS
(25,000), GATED_LANDMARKS (500); and SWEEP_WORKERS.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.benchmarks.seed_sweep import log, native_beside, report
from conan_slam_tpu_torch.benchmarks.world import gated_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.native import run_ekf_baseline
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed

N_SEEDS = 12


def main(argv=None, device="cuda") -> dict:
    n_seeds = int(argv[0]) if argv else N_SEEDS
    n_landmarks = int(os.environ.get("GATED_LANDMARKS", "500"))
    steps = int(os.environ.get("GATED_STEPS", "25000"))
    workers = int(os.environ.get("SWEEP_WORKERS", "1"))
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    world = gated_world(n_landmarks, dev)
    cfg = SlamConfig(max_landmarks=n_landmarks, max_obs=64, switch_association_known=False)
    roll = precompute_rollout(world, cfg, steps)

    lm = world.landmarks.cpu().numpy()
    wp = world.waypoints.cpu().numpy()

    def native(s):
        return run_ekf_baseline(lm, wp, steps, seed=s, with_noise=True, opt=True, gated=True,
                                gate_reject=cfg.gate_reject, gate_augment=cfg.gate_augment,
                                max_obs=cfg.max_obs)
    t0 = time.perf_counter()
    port, mapped, port_s = [], [], []
    with native_beside(n_seeds, workers, native) as native_results:
        for s in range(n_seeds):
            t1 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(s)
            state, outs = run_ekf_slam_precomputed(world, cfg, gen, steps, precomputed=roll)
            ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
            port.append(ate)
            mapped.append(int(state.n_active))
            port_s.append(time.perf_counter() - t1)
            log(f"port   seed {s}: ATE {ate:.4f} m, mapped {mapped[-1]} ({port_s[-1]:.1f}s)")
        nat_res = native_results()
    native_s = time.perf_counter() - t0
    for s, res in enumerate(nat_res):
        log(f"native seed {s}: ATE {res.ate_rmse:.4f} m ({res.steps_per_s:,.0f} steps/s)")
    nat = [r.ate_rmse for r in nat_res]
    out = report(f"# Config-2 gated-NN ATE, {n_seeds} seeds x {steps} steps "
                 f"({n_landmarks} landmarks, mapping from scratch)",
                 ("port gated (torch.Generator)", "native C++ gated (mt19937)"), port, nat)
    print(f"# port mapped per seed: {mapped}", flush=True)
    return dict(out, port=port, native=nat, mapped=mapped, steps=steps, port_seconds=port_s,
                seconds=native_s, native_steps_per_s=[r.steps_per_s for r in nat_res],
                workers=workers)


if __name__ == "__main__":
    main(sys.argv[1:])
