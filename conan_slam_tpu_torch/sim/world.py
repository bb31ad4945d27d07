"""World container: landmark and waypoint sets (port of
conan_slam_tpu.sim.world; reference test/main.cpp:24-86)."""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from conan_slam_tpu_torch.device import default_device


class World(NamedTuple):
    landmarks: torch.Tensor  # (num_landmarks, 2) float32
    waypoints: torch.Tensor  # (num_waypoints, 2) float32

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def num_waypoints(self) -> int:
        return self.waypoints.shape[0]


# The canonical valet-loop world (reference test/main.cpp:24-86), the same
# literals as conan_slam_tpu.sim.world.
_LM_X = [
    1286.9623655913983, -16.801075268817204, 2879.7043010752677, 4042.3387096774186,
    2510.0806451612898, -1871.6397849462364, -2120.2956989247314, -3618.9516129032254,
    -4210.349462365592, -4317.876344086021, 534.2741935483871, -910.6182795698924,
    -4290.994623655914, 177.06919945726258, 1044.0976933514303, 506.78426051560746,
    1813.4328358208986, 2656.0379918588915, 3242.1981004070585, 3999.321573948446,
    1532.5644504749034, 1117.367706919953, -152.6458616010823, -2008.8195386702819,
    -3755.0881953867, -3046.8113975576653, -4902.985074626863, 1654.6811397557722,
    4194.708276797832, 3278.83310719132,
]
_LM_Y = [
    203.8216560509554, -1095.5414012738865, -2942.6751592356704, -76.43312101910828,
    3108.28025477707, 4076.4331210191067, 191.0828025477707, -3770.7006369426763,
    -1235.6687898089185, 4089.171974522291, 4789.808917197452, 2420.382165605094,
    1286.624203821655, -164.38356164383562, -1698.6301369863013, -1479.4520547945206,
    -821.9178082191781, -630.1369863013699, 1041.095890410959, 2054.7945205479455,
    2219.178082191782, 1369.8630136986301, 1616.4383561643844, 2109.589041095891,
    1945.2054794520554, 1342.4657534246576, 1917.808219178085, -1616.4383561643826,
    1150.6849315068494, 2000.0,
]
_WP_X = [0.0, 997.9838709677419, 4028.8978494623643, -1058.4677419354839, -4976.478494623656]
_WP_Y = [0.0, -2038.216560509556, 1707.0063694267501, 1987.261146496814, 1464.9681528662404]


def world_from_numpy(landmarks, waypoints, device=None) -> World:
    """A world from (N, 2) numpy arrays, as float32 tensors on ``device``
    (default: the card)."""
    device = default_device() if device is None else device
    return World(
        landmarks=torch.tensor(np.asarray(landmarks, np.float32), device=device),
        waypoints=torch.tensor(np.asarray(waypoints, np.float32), device=device),
    )


def random_world(generator: torch.Generator, num_landmarks: int, num_waypoints: int = 5,
                 extent: float = 5000.0, device=None) -> World:
    """A random world (the reference's, for the scaled benchmark configs):
    landmarks and a waypoint tour uniform over the square of half-side
    ``extent``, waypoint 0 at the origin.  The draws come from
    ``generator`` on its own device; the world goes to ``device``
    (default: the card)."""
    device = default_device() if device is None else device

    def uniform(n):
        u = torch.rand((n, 2), generator=generator, dtype=torch.float32,
                       device=generator.device)
        return ((2.0 * u - 1.0) * extent).to(device)

    lm = uniform(num_landmarks)
    wp = uniform(num_waypoints)
    wp[0] = 0.0
    return World(landmarks=lm, waypoints=wp)


def default_world(device=None) -> World:
    """The reference's 30-landmark, 5-waypoint valet loop, on ``device``
    (default: the card)."""
    return world_from_numpy(
        np.stack([_LM_X, _LM_Y], axis=1), np.stack([_WP_X, _WP_Y], axis=1), device
    )


# BASELINE config 2's landmarks: conan_slam_tpu.sim.world.random_world(
# jax.random.PRNGKey(7), 500).landmarks, stored so that the port needs no JAX.
_CONFIG2_LANDMARKS = Path(__file__).resolve().parent / "data" / "random_world_key7_500.npy"


def config2_world(device=None) -> World:
    """BASELINE config 2 (benchmarks/bench_gated.py): 500 random landmarks
    over a 10 km square, driven along the default valet waypoints, on
    ``device`` (default: the card)."""
    return world_from_numpy(
        np.load(_CONFIG2_LANDMARKS), np.stack([_WP_X, _WP_Y], axis=1), device
    )


# BASELINE config 4's worlds: the landmarks of conan_slam_tpu.sim.world.
# random_world(jax.random.PRNGKey(11), n) at the sizes its scripts use
# (benchmarks/bench_longloop.py: 5,000; probe_closure.py: 1,000), stored by
# tests/longloop_reference.py.
LONGLOOP_SIZES = (5000, 1000)


def star_waypoints(radius: float = 4000.0) -> np.ndarray:
    """The long loop's tour (benchmarks/bench_longloop.py): from the origin
    around an 8-point star polygon and back to its first point, a path
    that crosses itself many times (the geometry loop closure needs)."""
    ang = np.arange(8) * 2 * np.pi / 8
    pts = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    order = [(3 * i) % 8 for i in range(8)] + [0]
    return np.concatenate([np.zeros((1, 2)), pts[order]]).astype(np.float32)


def longloop_world(num_landmarks: int = 5000, device=None, waypoints=None) -> World:
    """The reference's ``random_world(PRNGKey(11), num_landmarks)`` landmarks
    (5,000 or 1,000; any other size raises: take ``random_world`` with a
    generator, which draws another world) on ``waypoints`` (default: the
    star tour), on ``device`` (default: the card)."""
    if num_landmarks not in LONGLOOP_SIZES:
        raise ValueError(f"no stored world of {num_landmarks} landmarks (stored: "
                         f"{LONGLOOP_SIZES}); random_world(generator, n) draws another one")
    path = Path(__file__).resolve().parent / "data" / f"random_world_key11_{num_landmarks}.npy"
    return world_from_numpy(np.load(path), star_waypoints() if waypoints is None else waypoints,
                            device)
