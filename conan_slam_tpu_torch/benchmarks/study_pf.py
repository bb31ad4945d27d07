"""PF robustness study (port of benchmarks/study_pf.py): the seed variance
of FastSLAM 2.0 at the reference's configuration.

    python -m conan_slam_tpu_torch.benchmarks.study_pf [n_seeds] [n_steps]

The reference runs 100 particles (slam.h:92-93).  This sweeps the
resampling kind, the roughening level and the ensemble size (``CONFIGS``,
the reference's table) over seeds 0 .. n_seeds - 1 (default 36) of
``n_steps`` (default 25,000) on the canonical valet world, through the
port's ``runner.loop.run_pf_slam`` (the draws from a ``torch.Generator``
seeded with the seed, where the reference took ``PRNGKey(seed)``), and
prints the median, p90 and largest ATE and the share of seeds above 1 m a
configuration, in the reference's table; the per-seed lines go to stderr.
``main(..., configs=k)`` runs the first k configurations only.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import run_pf_slam
from conan_slam_tpu_torch.sim.world import default_world

CONFIGS = [
    # (label, resample kind, roughening, num_particles)
    ("reference (stratified, no roughening)", "stratified", 0.0, 100),
    ("systematic", "systematic", 0.0, 100),
    ("systematic + roughening 0.02", "systematic", 0.02, 100),
    ("systematic + roughening 0.05", "systematic", 0.05, 100),
    ("stratified + roughening 0.05", "stratified", 0.05, 100),
    ("systematic, 400 particles", "systematic", 0.0, 400),
    ("systematic, 1000 particles", "systematic", 0.0, 1000),
]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None, device="cuda", configs: int | None = None) -> dict:
    argv = list(argv or [])
    n_seeds = int(argv[0]) if len(argv) > 0 else 36
    n_steps = int(argv[1]) if len(argv) > 1 else 25_000
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    world = default_world(device=dev)
    log(f"seeds={n_seeds} steps={n_steps}")

    rows, results = [], {}
    for label, kind, rough, n_part in CONFIGS[:configs]:
        cfg = SlamConfig(num_particles=n_part, pf_resample_kind=kind, pf_roughening=rough)
        ates = []
        t0 = time.perf_counter()
        for s in range(n_seeds):
            gen = torch.Generator(device=dev).manual_seed(s)
            _, outs = run_pf_slam(world, cfg, gen, n_steps)
            ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
            ates.append(ate)
            log(f"  {label} seed {s}: ATE {ate:.3f} m")
        dt = time.perf_counter() - t0
        a = np.asarray(ates)
        row = (label, float(np.median(a)), float(np.percentile(a, 90)), float(a.max()),
               float(np.mean(a > 1.0)))
        rows.append(row)
        results[label] = dict(ates=ates, median=row[1], p90=row[2], max=row[3],
                              frac_above_1m=row[4], seconds=dt)
        log(f"{label}: median {row[1]:.3f} p90 {row[2]:.3f} max {row[3]:.3f} ({dt:.0f}s)")

    print(f"# PF robustness, {n_seeds} seeds x {n_steps} steps, "
          f"valet world, 100 particles (reference slam.h:92)")
    print("| configuration | median ATE [m] | p90 ATE [m] | max [m] | frac > 1 m |")
    print("|---|---|---|---|---|")
    for label, med, p90, amax, frac in rows:
        print(f"| {label} | {med:.3f} | {p90:.3f} | {amax:.3f} | {frac:.2f} |", flush=True)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
