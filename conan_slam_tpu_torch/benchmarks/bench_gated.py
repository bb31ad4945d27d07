"""BASELINE config 2 (port of benchmarks/bench_gated.py): EKF-SLAM, 500
landmarks, full joint covariance, Mahalanobis-gated NN association,
mapping from scratch.

    python -m conan_slam_tpu_torch.benchmarks.bench_gated [steps]

The vehicle drives the canonical valet waypoint tour through a
500-landmark world with an EMPTY initial map and unknown correspondences:
every frame runs H15 (the factors and the gated association against the
virtual covariance) and H10 (the fused single-P-rewrite update), then
masked augmentation as new landmarks are found.  The world is the
reference's ``random_world(PRNGKey(7), 500)`` (committed,
``benchmarks.world.gated_world``; at GATED_LANDMARKS=10000 the world of
``chip_smoke.py``'s 10k shape).  Reports control steps/s, ATE RMSE and the
mapped count, in the reference's line.

Knobs, as the reference's: GATED_LANDMARKS (500); GATED_CHUNK (0: one
run; else the port's chunked driver, ``run_ekf_slam_precomputed_chunked``,
in chunks of that many steps); GATED_CKPT_DIR (with GATED_CHUNK: a
checkpoint after each chunk of the first run, which a rerun with the same
environment resumes bit for bit).  The rollout is computed once (the
seed-independent workload).  A first run from ``torch.Generator`` seed 0
(the reference's PRNGKey(0)), then three timed runs from seeds 100-102
(its PRNGKey(100 + i)); the best of the three gives steps/s, the last its
ATE and map.  ``smoke_compile.py``'s ``gated_full`` gate (ATE < 0.5 m,
270 <= mapped <= 340) is checked on the last run where it applies (500
landmarks, at least 25,000 steps) and reported.
"""

from __future__ import annotations

import os
import sys
import time

import torch

from conan_slam_tpu_torch.benchmarks import card_line
from conan_slam_tpu_torch.benchmarks.world import gated_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.runner import metrics
from conan_slam_tpu_torch.runner.loop import (
    precompute_rollout,
    run_ekf_slam_precomputed,
    run_ekf_slam_precomputed_chunked,
)

STEPS = 25_000
GATED_FULL = dict(ate_m=0.5, mapped=(270, 340), landmarks=500, steps=25_000)


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def gated_full(ate: float, mapped: int, n_landmarks: int, steps: int) -> bool | None:
    """``smoke_compile.py``'s gated_full gate on a run, or None where it does
    not apply (another world or a shorter run)."""
    if n_landmarks != GATED_FULL["landmarks"] or steps < GATED_FULL["steps"]:
        return None
    lo, hi = GATED_FULL["mapped"]
    return ate < GATED_FULL["ate_m"] and lo <= mapped <= hi


def main(argv=None, device="cuda") -> dict:
    steps = int(argv[0]) if argv else STEPS
    n_landmarks = int(os.environ.get("GATED_LANDMARKS", "500"))
    chunk = int(os.environ.get("GATED_CHUNK", "0"))
    ckpt_dir = os.environ.get("GATED_CKPT_DIR") or None
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    world = gated_world(n_landmarks, dev)
    cfg = SlamConfig(max_landmarks=n_landmarks, max_obs=64, switch_association_known=False)
    roll = precompute_rollout(world, cfg, steps)      # seed-independent workload

    def run(seed: int, checkpoint_dir=None):
        if chunk:
            state, outs = run_ekf_slam_precomputed_chunked(
                world, cfg, seed, steps, chunk, precomputed=roll, checkpoint_dir=checkpoint_dir)
        else:
            gen = torch.Generator(device=dev).manual_seed(seed)
            state, outs = run_ekf_slam_precomputed(world, cfg, gen, steps, precomputed=roll)
        outs.x_est.cpu()
        state.x.cpu()
        return state, outs

    t0 = time.time()
    run(0, ckpt_dir)
    log(f"first run: {time.time() - t0:.1f}s")
    ts = []
    for i in range(3):
        t0 = time.perf_counter()
        state, outs = run(100 + i)
        ts.append(time.perf_counter() - t0)
    best = min(ts)
    ate = float(metrics.ate_rmse(outs.x_true, outs.x_est, ~outs.done))
    mapped = int(state.n_active)
    print(f"gated {n_landmarks}lm from scratch: {steps / best:,.0f} steps/s, "
          f"ATE={ate:.3f} m, mapped={mapped}", flush=True)
    gate = gated_full(ate, mapped, n_landmarks, steps)
    print("gated_full (ATE < 0.5 m, 270 <= mapped <= 340): "
          + {None: "not applicable (the 25,000-step run of the 500-landmark world)",
             True: "PASS", False: "FAIL"}[gate], flush=True)
    return {
        "steps_per_s": round(steps / best, 1),
        "ate_m": round(ate, 4),
        "mapped": mapped,
        "landmarks": n_landmarks,
        "gated_full": gate,
        "seconds": ts,
    }


if __name__ == "__main__":
    main(sys.argv[1:])
