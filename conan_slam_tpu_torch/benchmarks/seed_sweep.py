"""Headline-config ATE seed sweep (port of benchmarks/seed_sweep.py): the
port on the card against the native C++ baseline on shared seeds.

    python -m conan_slam_tpu_torch.benchmarks.seed_sweep [n_seeds]

N seeds (default 20) of the bench workload (``bench.py``'s: 1024
pre-registered landmarks from numpy seed 42, 19,200 steps,
``benchmarks.world``) through the port's precomputed driver (H9 a frame;
the noise from a ``torch.Generator`` seeded with the seed, where the
reference took ``PRNGKey(seed)``) and through the native C++ baseline
(``conan_slam_tpu_torch.native.run_ekf_baseline``, SIMD path, pre-built
map, the seed its mt19937_64's).  The two stacks draw from different
streams, so per-seed values differ by construction; the claim under test
is that the distributions overlap.  Prints the reference's table, P(port
seed beats native seed) and the per-seed lists (with the port's mapped
counts); the per-seed lines go to stderr.

The native runs go on SWEEP_WORKERS threads (default 1) beside the port's
runs, where the reference ran them after: their ATEs are the same, their
steps/s share the host's cores with the port's loop.  Knobs: SWEEP_STEPS
(19,200: the bench's); SWEEP_WORKERS.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.benchmarks.world import BENCH_STEPS, N_LANDMARKS, SIGMA0, bench_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.native import run_ekf_baseline
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import precompute_rollout, run_ekf_slam_precomputed

N_SEEDS = 20


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@contextlib.contextmanager
def native_beside(n_seeds: int, workers: int, run):
    """Start ``run(seed)`` for every seed on ``workers`` threads (each
    releases the GIL in the native code) and yield a call that waits for
    their results, in seed order."""
    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        futures = [pool.submit(run, s) for s in range(n_seeds)]
        yield lambda: [f.result() for f in futures]


def report(title: str, labels: tuple[str, str], port: list, nat: list) -> dict:
    """The reference's table, P(port seed beats native seed) and the per-seed
    lists, printed; returned as numbers."""
    t, n = np.asarray(port), np.asarray(nat)
    print(title)
    print("| stack | median | mean | p90 | max |")
    print("|---|---|---|---|---|")
    stats = {}
    for name, a in zip(labels, (t, n)):
        print(f"| {name} | {np.median(a):.4f} | {a.mean():.4f} | "
              f"{np.percentile(a, 90):.4f} | {a.max():.4f} |")
        stats[name] = dict(median=float(np.median(a)), mean=float(a.mean()),
                           p90=float(np.percentile(a, 90)), max=float(a.max()))
    # A rank check without scipy: the share of cross pairs where the port's
    # seed is the better one (0.5 = identical distributions).
    wins = float(np.mean(t[:, None] < n[None, :]))
    print(f"# P(port seed beats native seed) = {wins:.3f} (0.5 = indistinguishable)")
    print(f"# per-seed port: {[round(x, 4) for x in port]}")
    print(f"# per-seed nat: {[round(x, 4) for x in nat]}", flush=True)
    return dict(stats=stats, p_port_beats_native=wins)


def main(argv=None, device="cuda") -> dict:
    n_seeds = int(argv[0]) if argv else N_SEEDS
    steps = int(os.environ.get("SWEEP_STEPS", str(BENCH_STEPS)))
    workers = int(os.environ.get("SWEEP_WORKERS", "1"))
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    lm, world, state0 = bench_world(N_LANDMARKS, dev)
    wp = world.waypoints.cpu().numpy()
    cfg = SlamConfig(max_landmarks=N_LANDMARKS, max_obs=64)
    roll = precompute_rollout(world, cfg, steps)

    def native(s):
        return run_ekf_baseline(lm, wp, steps, seed=s, with_noise=True, prebuild_map=True,
                                sigma0=SIGMA0, opt=True)
    t0 = time.perf_counter()
    port, mapped, port_s = [], [], []
    with native_beside(n_seeds, workers, native) as native_results:
        for s in range(n_seeds):
            t1 = time.perf_counter()
            gen = torch.Generator(device=dev).manual_seed(s)
            state, outs = run_ekf_slam_precomputed(world, cfg, gen, steps, state0, roll)
            ate = float(metrics.ate_rmse(outs.x_est, outs.x_true))
            port.append(ate)
            mapped.append(int(state.n_active))
            port_s.append(time.perf_counter() - t1)
            log(f"port   seed {s}: ATE {ate:.4f} m, mapped {mapped[-1]} ({port_s[-1]:.1f}s)")
        nat_res = native_results()
    native_s = time.perf_counter() - t0
    for s, res in enumerate(nat_res):
        log(f"native seed {s}: ATE {res.ate_rmse:.4f} m ({res.steps_per_s:,.0f} steps/s)")
    nat = [r.ate_rmse for r in nat_res]
    out = report(f"# Headline-config ATE, {n_seeds} seeds x {steps} steps "
                 f"({N_LANDMARKS} pre-mapped landmarks)",
                 ("port (torch.Generator)", "native C++ (mt19937)"), port, nat)
    print(f"# port mapped per seed: {mapped}", flush=True)
    return dict(out, port=port, native=nat, mapped=mapped, steps=steps, port_seconds=port_s,
                seconds=native_s, native_steps_per_s=[r.steps_per_s for r in nat_res],
                workers=workers)


if __name__ == "__main__":
    main(sys.argv[1:])
