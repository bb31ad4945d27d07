"""The benches' worlds.

``bench_world``: the bench workload's landmarks, world and pre-registered
start state that ``bench_framestep``, ``seed_sweep`` and ``chip_smoke.py``'s
main paths run on: 1024 landmarks by default, drawn from numpy seed 42 over
a 13 km square on the default tour, all pre-registered with sigma 1 m
(``bench.py``'s ``build_world``).

``gated_world``: BASELINE config 2's world at ``bench_gated``'s
GATED_LANDMARKS: the reference's ``random_world(PRNGKey(7), 500)`` at 500
(committed, ``sim.world.config2_world``); at another size, landmarks from
numpy seed 53 over the 10 km square of the reference's ``random_world``
(at 10,000 the world of ``chip_smoke.py``'s 10k-landmark shape).
"""

from __future__ import annotations

import numpy as np

from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y, config2_world, world_from_numpy

SEED = 42
SIGMA0 = 1.0
WORLD_EXTENT = 6500.0   # ~40 landmarks visible a frame at 2000 m range
N_LANDMARKS = 1024      # bench.py's: all pre-registered, D = 3 + 2 * 1024 = 2051
BENCH_STEPS = 19_200    # bench.py's run
NATIVE_STEPS = 2_400    # bench.py's native run (steady state from step 1)
GATED_SEED = 53         # the numpy seed of a gated world at a size with no stored one


def bench_world(n_landmarks: int, device, pad_multiple: int = 256):
    """The bench's landmarks (numpy), world and pre-registered start state
    (P padded to a multiple of ``pad_multiple``)."""
    rng = np.random.default_rng(SEED)
    lm = rng.uniform(-WORLD_EXTENT, WORLD_EXTENT, size=(n_landmarks, 2)).astype(np.float32)
    wp = np.stack([_WP_X, _WP_Y], axis=1).astype(np.float32)
    world = world_from_numpy(lm, wp, device)
    state0 = init_state_with_map(world.landmarks, sigma0=SIGMA0, pad_multiple=pad_multiple,
                                 device=device)
    return lm, world, state0


def gated_world(n_landmarks: int, device):
    """BASELINE config 2's world at ``n_landmarks`` on the default tour
    (module docstring)."""
    if n_landmarks == 500:
        return config2_world(device)
    lm = np.random.default_rng(GATED_SEED).uniform(-5000.0, 5000.0, size=(n_landmarks, 2))
    return world_from_numpy(lm.astype(np.float32), np.stack([_WP_X, _WP_Y], axis=1), device)
