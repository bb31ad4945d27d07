"""BASELINE config 2's gated run (500 landmarks, K 500, max_obs 64) through
run_ekf_slam from several seeds: its ATE and map size each, beside
``gated_full`` (ATE < 0.5 m, 270 to 340 mapped;
benchmarks/smoke_compile.py), which holds one realization of the noise.

    python tests/config2_seeds.py jax 0 1 2 ... 11
        the JAX package's run_ekf_slam from PRNGKey(k) on the CPU
    python tests/config2_seeds.py torch 0 --device cuda
        the port's run_ekf_slam from torch.Generator(device).manual_seed(k)

One line per seed: ``<package> seed <k> ATE <m> mapped <n> <seconds>``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_STEPS = 25_000


def jax_runs(seeds: list[int]) -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from conan_slam_tpu.config import SlamConfig
    from conan_slam_tpu.runner import metrics
    from conan_slam_tpu.runner.loop import run_ekf_slam
    from conan_slam_tpu.sim.world import default_world, random_world

    world = random_world(jax.random.PRNGKey(7), 500)._replace(
        waypoints=default_world().waypoints)
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    for seed in seeds:
        t0 = time.perf_counter()
        carry, outs = run_ekf_slam(world, cfg, jax.random.PRNGKey(seed), n_steps=N_STEPS)
        ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
        print(f"jax seed {seed} ATE {ate:.5f} mapped {int(carry.state.n_active)} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def torch_runs(seeds: list[int], device: str) -> None:
    import torch

    from conan_slam_tpu_torch.config import SlamConfig
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam
    from conan_slam_tpu_torch.runner.metrics import ate_rmse
    from conan_slam_tpu_torch.sim.world import config2_world

    world = config2_world(device=device)
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    for seed in seeds:
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        carry, outs = run_ekf_slam(world, cfg, gen, N_STEPS)
        ate = float(ate_rmse(outs.x_true, outs.x_est, ~outs.done))
        print(f"torch ({device}) seed {seed} ATE {ate:.5f} mapped {int(carry.state.n_active)} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("seeds", type=int, nargs="+")
    ap.add_argument("--device", default="cuda", help="the port's device (torch only)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    if args.package == "jax":
        jax_runs(args.seeds)
    else:
        torch_runs(args.seeds, args.device)


if __name__ == "__main__":
    main()
