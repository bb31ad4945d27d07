"""The maps the vehicle drives through: landmarks drawn from a numpy seed
over a square, and the reference's five-waypoint valet tour.

Frozen copies of the program's bench worlds (``benchmarks/world.py``:
``bench_world``'s square of half-side 6,500 m from seed 42,
``gated_world``'s 5,000 m from seed 53) and of the reference's waypoints
(test/main.cpp:24-86, ``sim/world.py``)."""

from __future__ import annotations

import numpy as np

WAYPOINTS = np.array(
    [[0.0, 0.0],
     [997.9838709677419, -2038.216560509556],
     [4028.8978494623643, 1707.0063694267501],
     [-1058.4677419354839, 1987.261146496814],
     [-4976.478494623656, 1464.9681528662404]], dtype=np.float32)


def landmarks(n: int, seed: int, extent: float) -> np.ndarray:
    """``n`` landmarks uniform over the square of half-side ``extent`` from
    numpy's ``default_rng(seed)``, each float64 draw rounded to float32."""
    pts = np.random.default_rng(seed).uniform(-extent, extent, size=(n, 2))
    return pts.astype(np.float32)
