"""Particle-filter throughput bench (port of benchmarks/bench_pf.py, BASELINE
config 3): FastSLAM 2.0 (``runner.loop.run_pf_slam``) on the default valet
world, 1,200 steps at each ensemble size of the sweep.

    python -m conan_slam_tpu_torch.benchmarks.bench_pf [N ...]

Defaults: N = 100, 1,000, 10,000 and 100,000, 1,200 steps a run (``main``'s
``steps``).  Each size runs once from generator seed 0 to warm up, then
three times from seeds 1-3; the best of the three gives steps/s and
particle-steps/s, the last its ATE.  One line a size, as the reference
prints it.
"""

from __future__ import annotations

import sys
import time

import torch

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import run_pf_slam
from conan_slam_tpu_torch.sim.world import default_world

DEFAULT = (100, 1000, 10000, 100000)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, device="cuda", steps: int = 1200) -> dict:
    ensembles = [int(a) for a in argv] if argv else list(DEFAULT)
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    world = default_world(device=dev)

    def run(n: int, seed: int):
        gen = torch.Generator(device=dev).manual_seed(seed)
        carry, outs = run_pf_slam(world, SlamConfig(num_particles=n), gen, steps)
        outs.x_est.cpu()            # waits for the run
        return carry, outs

    results = {}
    for n in ensembles:
        t0 = time.perf_counter()
        run(n, 0)
        log(f"N={n}: warm-up run {time.perf_counter() - t0:.1f}s")
        ts = []
        for i in range(3):
            t0 = time.perf_counter()
            _, outs = run(n, i + 1)
            ts.append(time.perf_counter() - t0)
        best = min(ts)
        ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
        print(f"N={n:6d}: {steps / best:8.0f} steps/s  {n * steps / best:12.3e} "
              f"particle-steps/s  ATE={ate:.3f}", flush=True)
        results[n] = {"steps_per_s": steps / best, "particle_steps_per_s": n * steps / best,
                      "ate_m": ate}
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
