"""The bench workload's world: the landmarks, world and pre-registered start
state that ``bench_framestep`` and ``chip_smoke.py``'s main paths run on.

1024 landmarks by default, drawn from numpy seed 42 over a 13 km square on
the default tour, all pre-registered with sigma 1 m.
"""

from __future__ import annotations

import numpy as np

from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.sim.world import _WP_X, _WP_Y, world_from_numpy

SEED = 42
SIGMA0 = 1.0
WORLD_EXTENT = 6500.0   # ~40 landmarks visible a frame at 2000 m range


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
