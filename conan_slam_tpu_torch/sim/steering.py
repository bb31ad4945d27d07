"""Waypoint-following steering controller (port of
conan_slam_tpu.sim.steering; reference computeSWA, slam.h:279-332, and the
driver's loop restart, test/main.cpp:150-154).

A pure function over a carry of 0-d device tensors with an explicit
``done`` flag: the waypoint is looked up by a device index
(``index_select``), so a tick never waits for the device.  Waypoint
indices are 0-based (the reference's are 1-based, slam.h:294).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.device import default_device


class SteerState(NamedTuple):
    swa: torch.Tensor         # () float32 current steering wheel angle
    iwp: torch.Tensor         # () int64 current waypoint index (0-based)
    loops_left: torch.Tensor  # () int64 remaining passes through the list
    done: torch.Tensor        # () bool final waypoint reached, no loops left


def init_steer_state(number_loops: int, device=None) -> SteerState:
    """The controller at rest before waypoint 0, on ``device`` (default:
    the card)."""
    device = default_device() if device is None else device
    return SteerState(
        swa=torch.zeros((), dtype=torch.float32, device=device),
        iwp=torch.zeros((), dtype=torch.int64, device=device),
        loops_left=torch.full((), number_loops, dtype=torch.int64, device=device),
        done=torch.zeros((), dtype=torch.bool, device=device),
    )


def _waypoint(waypoints, i):
    """Waypoint ``i`` (a 0-d index tensor) as a (2,) tensor."""
    return waypoints.index_select(0, i.reshape(1))[0]


def steer(state: SteerState, pose, waypoints, *, at_waypoint, rate_swa, max_swa, dt) -> SteerState:
    """One controller tick (reference slam.h:291-326): on reaching the
    current waypoint the target advances in the same tick; past the final
    waypoint the controller restarts the list (one tick with the steering
    held, the reference's early return at slam.h:301-303) or finishes."""
    n_wp = waypoints.shape[0]
    d2 = torch.sum((_waypoint(waypoints, state.iwp) - pose[:2]) ** 2)
    reached = d2 < at_waypoint**2

    iwp_next = state.iwp + reached.to(state.iwp.dtype)
    past_end = iwp_next >= n_wp
    restart = past_end & (state.loops_left > 1)
    finished = past_end & ~restart

    loops_left = torch.where(restart, state.loops_left - 1, state.loops_left)
    iwp_new = torch.where(past_end, 0, iwp_next)

    # Steer towards the (possibly advanced) target waypoint.
    target = _waypoint(waypoints, torch.clamp(iwp_next, max=n_wp - 1))
    delta = wrap_angle(
        torch.atan2(target[1] - pose[1], target[0] - pose[0]) - pose[2] - state.swa)
    max_delta = rate_swa * dt
    delta = torch.clamp(delta, -max_delta, max_delta)
    swa_new = torch.clamp(state.swa + delta, -max_swa, max_swa)

    # Hold the steering on the pass-end tick and after the finish.
    hold = past_end | state.done
    return SteerState(
        swa=torch.where(hold, state.swa, swa_new),
        iwp=torch.where(state.done, state.iwp, iwp_new),
        loops_left=loops_left,
        done=state.done | finished,
    )
