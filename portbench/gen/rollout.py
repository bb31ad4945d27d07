"""The replayed log: the vehicle's true trajectory and its noiseless
range-bearing returns, in numpy float32.

A frozen copy of the program's host rollout (``sim/precompute.py``'s numpy
path), so that a later change to the program cannot move the traffic.  The
arithmetic is the same, operation for operation, and gives the same bits
(portbench/tests/test_portbench_gen.py holds the two equal); two things
make it cheaper at the benchmark's lengths:

* the truth loop keeps the pose in three float32 scalars and clips with
  comparisons, where the original builds an array a step and calls
  ``np.clip``;
* each chunk of frames looks only at the landmarks inside the box that its
  poses span, widened by the sensor's range (a landmark outside it fails
  the sensor's own box test), and forms range and bearing only for the
  returns it keeps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_F32 = np.float32
_PI = np.float32(np.pi)
_TWO_PI = np.float32(2 * np.pi)


class Truth(NamedTuple):
    x_true: np.ndarray   # (T, 3) float32 pose after each control step
    swa: np.ndarray      # (T,) float32 steering angle used at each step
    active: np.ndarray   # (T,) bool, the step was driven
    done: np.ndarray     # (T,) bool, the course is complete after the step


class Returns(NamedTuple):
    z_true: np.ndarray   # (F, NZ, 2) float32 noiseless (range, bearing)
    ids: np.ndarray      # (F, NZ) int32 landmark ids, -1 in empty slots
    mask: np.ndarray     # (F, NZ) bool


def _wrap(a):
    return _F32(np.remainder(_F32(a) + _PI, _TWO_PI) - _PI)


def rollout_truth(waypoints: np.ndarray, vehicle: dict, n_steps: int) -> Truth:
    """Steering toward the waypoints (``number_loops`` laps), bicycle
    motion, frozen once the course is complete.  ``vehicle`` holds
    velocity, wheel_base, dt_controls, rate_swa, max_swa, at_waypoint and
    number_loops."""
    wp = np.asarray(waypoints, np.float32)
    n_wp = wp.shape[0]
    wpx = [wp[i, 0] for i in range(n_wp)]
    wpy = [wp[i, 1] for i in range(n_wp)]
    dt = _F32(vehicle["dt_controls"])
    vel = _F32(vehicle["velocity"])
    wb = _F32(vehicle["wheel_base"])
    max_delta = _F32(vehicle["rate_swa"]) * dt
    neg_max_delta = -max_delta
    max_swa = _F32(vehicle["max_swa"])
    neg_max_swa = -max_swa
    at2 = _F32(vehicle["at_waypoint"]) ** 2
    vdt = vel * dt
    arctan2, cos, sin = np.arctan2, np.cos, np.sin

    p0 = p1 = p2 = _F32(0.0)
    swa = _F32(0.0)
    iwp = 0
    loops_left = int(vehicle["number_loops"])
    done = False

    xs = np.zeros((n_steps, 3), np.float32)
    swas = np.zeros((n_steps,), np.float32)
    actives = np.zeros((n_steps,), bool)
    dones = np.zeros((n_steps,), bool)
    for t in range(n_steps):
        was_done = done
        if not done:
            d2 = (wpx[iwp] - p0) ** 2 + (wpy[iwp] - p1) ** 2
            iwp_next = iwp + int(d2 < at2)
            past_end = iwp_next >= n_wp
            restart = past_end and loops_left > 1
            if restart:
                loops_left -= 1
            iwp = 0 if past_end else iwp_next
            if not past_end:
                k = min(iwp_next, n_wp - 1)
                delta = _wrap(_F32(arctan2(wpy[k] - p1, wpx[k] - p0)) - p2 - swa)
                delta = min(max(delta, neg_max_delta), max_delta)
                swa = min(max(swa + delta, neg_max_swa), max_swa)
            done = past_end and not restart
        if not done:
            a = swa + p2
            p0, p1, p2 = (p0 + vdt * _F32(cos(a)), p1 + vdt * _F32(sin(a)),
                          _wrap(p2 + vdt * _F32(sin(swa)) / wb))
        xs[t, 0], xs[t, 1], xs[t, 2] = p0, p1, p2
        swas[t] = swa
        actives[t] = not was_done
        dones[t] = done
    return Truth(x_true=xs, swa=swas, active=actives, done=dones)


CHUNK = 256   # frames whose returns are formed at a time


def rollout_returns(x_true: np.ndarray, landmarks: np.ndarray, max_range: float,
                    nz: int, interval: int) -> Returns:
    """The sensor's returns at each frame's last step: a semicircular field
    of view ahead of the vehicle within ``max_range``, the first ``nz``
    visible landmarks in ascending id order, fixed-size buffers."""
    lm = np.asarray(landmarks, np.float32)
    poses = np.asarray(x_true, np.float32)[interval - 1 :: interval]
    n_frames = poses.shape[0]
    z = np.zeros((n_frames, nz, 2), np.float32)
    ids = np.full((n_frames, nz), -1, np.int32)
    mask = np.zeros((n_frames, nz), bool)
    reach = float(max_range) + 1.0
    for f0 in range(0, n_frames, CHUNK):
        pc = poses[f0:f0 + CHUNK]
        lo, hi = pc[:, :2].min(0).astype(np.float64) - reach, pc[:, :2].max(0) + reach
        (cand,) = np.nonzero((lm[:, 0] > lo[0]) & (lm[:, 0] < hi[0])
                             & (lm[:, 1] > lo[1]) & (lm[:, 1] < hi[1]))
        d = lm[cand][None, :, :] - pc[:, None, :2]
        dx, dy = d[..., 0], d[..., 1]
        in_box = np.logical_and(np.abs(dx) < max_range, np.abs(dy) < max_range)
        ahead = dx * np.cos(pc[:, None, 2]) + dy * np.sin(pc[:, None, 2]) > 0.0
        in_circle = dx * dx + dy * dy < np.float32(max_range) ** 2
        visible = in_box & ahead & in_circle
        for k in range(pc.shape[0]):
            (cols,) = np.nonzero(visible[k])
            cols = cols[:nz]
            n = cols.shape[0]
            f = f0 + k
            ddx, ddy = dx[k, cols], dy[k, cols]
            ids[f, :n] = cand[cols]
            mask[f, :n] = True
            z[f, :n, 0] = np.sqrt(ddx * ddx + ddy * ddy, dtype=np.float32)
            z[f, :n, 1] = (np.arctan2(ddy, ddx).astype(np.float32) - pc[k, 2]
                           + np.float32(np.pi)) % np.float32(2 * np.pi) - np.float32(np.pi)
    return Returns(z_true=z, ids=ids, mask=mask)
