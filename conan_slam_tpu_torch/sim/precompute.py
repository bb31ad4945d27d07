"""Host-side ground-truth rollout (port of conan_slam_tpu.sim.precompute,
its numpy path).

The truth trajectory is deterministic: steering follows waypoints computed
from the true pose, and control/observation noise only enter the filter's
inputs (reference test/main.cpp:140-160).  Rolling it out once on the host
leaves the device loop with filter work only.  The float32 arithmetic is
the reference's numpy path line for line (tests/test_torch_slice.py holds
the two bit-equal), and numpy is the default (~0.9 s for the 19,200-step
bench rollout).  ``use_native=True`` runs the native C++ rollout instead
(``conan_slam_tpu_torch.native``, the reference's switch; within libm's
ulps of numpy, tests/test_torch_native.py): where its build or load fails
the call raises, it does not fall back to numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from conan_slam_tpu_torch.config import SlamConfig


class TruthRollout(NamedTuple):
    x_true: np.ndarray   # (T, 3) float32 pose after each control step
    swa: np.ndarray      # (T,) float32 steering angle used at each step
    active: np.ndarray   # (T,) bool  step executed (False after course done)
    done: np.ndarray     # (T,) bool  done flag after each step


def _wrap(a: np.float32) -> np.float32:
    return np.float32(np.remainder(np.float32(a) + np.float32(np.pi),
                                   np.float32(2 * np.pi)) - np.float32(np.pi))


def rollout_truth(waypoints: np.ndarray, cfg: SlamConfig, n_steps: int,
                  use_native: bool = False) -> TruthRollout:
    """The deterministic truth trajectory: steering toward the waypoints,
    bicycle motion, frozen once the course is complete; ``use_native``: the
    native C++ rollout (raises where it cannot be built or loaded)."""
    if use_native:
        from conan_slam_tpu_torch.native import rollout_truth_native

        return TruthRollout(*rollout_truth_native(waypoints, cfg, n_steps))
    wp = np.asarray(waypoints, np.float32)
    n_wp = wp.shape[0]
    dt = np.float32(cfg.dt_controls)
    vel = np.float32(cfg.velocity)
    wb = np.float32(cfg.wheel_base)
    max_delta = np.float32(cfg.rate_swa) * dt
    max_swa = np.float32(cfg.max_swa)
    at2 = np.float32(cfg.at_waypoint) ** 2

    pose = np.zeros(3, np.float32)
    swa = np.float32(0.0)
    iwp = 0
    loops_left = int(cfg.number_loops)
    done = False

    xs = np.zeros((n_steps, 3), np.float32)
    swas = np.zeros((n_steps,), np.float32)
    actives = np.zeros((n_steps,), bool)
    dones = np.zeros((n_steps,), bool)

    for t in range(n_steps):
        was_done = done
        if not done:
            # steering (sim.steering.steer semantics)
            cwp = wp[iwp]
            d2 = (cwp[0] - pose[0]) ** 2 + (cwp[1] - pose[1]) ** 2
            reached = d2 < at2
            iwp_next = iwp + int(reached)
            past_end = iwp_next >= n_wp
            restart = past_end and loops_left > 1
            finished = past_end and not restart
            if restart:
                loops_left -= 1
            iwp = 0 if past_end else iwp_next
            if not past_end:
                target = wp[min(iwp_next, n_wp - 1)]
                delta = _wrap(
                    np.float32(np.arctan2(target[1] - pose[1], target[0] - pose[0]))
                    - pose[2] - swa
                )
                delta = np.float32(np.clip(delta, -max_delta, max_delta))
                swa = np.float32(np.clip(swa + delta, -max_swa, max_swa))
            done = done or finished
        # Motion freezes as soon as the course completes, including the
        # arrival step itself (runner.loop._advance_truth gates on the
        # post-steer done flag).
        if not done:
            a = swa + pose[2]
            pose = np.asarray(
                [
                    pose[0] + vel * dt * np.float32(np.cos(a)),
                    pose[1] + vel * dt * np.float32(np.sin(a)),
                    _wrap(pose[2] + vel * dt * np.float32(np.sin(swa)) / wb),
                ],
                np.float32,
            )
        xs[t] = pose
        swas[t] = swa
        actives[t] = not was_done
        dones[t] = done

    return TruthRollout(x_true=xs, swa=swas, active=actives, done=dones)


# Frames of the (frames, landmarks) observation arrays formed at a time.
OBS_CHUNK = 256


class ObsRollout(NamedTuple):
    z_true: np.ndarray   # (n_frames, NZ, 2) noiseless (range, bearing)
    ids: np.ndarray      # (n_frames, NZ) int32 landmark ids (-1 = empty slot)
    mask: np.ndarray     # (n_frames, NZ) bool slot validity


def rollout_observations(
    x_true: np.ndarray, landmarks: np.ndarray, max_range: float,
    nz: int, interval: int, use_native: bool = False,
) -> ObsRollout:
    """Noiseless sensor returns at each frame end, in float32: semicircular
    field of view (reference slam.h:644-648), ascending-id slot order,
    fixed-size (z, ids, mask) buffers; the filter loop adds the noise.

    The (frames, landmarks) arrays are formed OBS_CHUNK frames at a time:
    every value is a per-frame, per-landmark elementwise result, so the
    output equals the whole-array form's bit for bit while the peak host
    memory stays at OBS_CHUNK frames (the long loop's 9,334 frames at 5,000
    landmarks are ~190 MB an array whole).  ``use_native``: the native C++
    rollout (raises where it cannot be built or loaded).
    """
    if use_native:
        from conan_slam_tpu_torch.native import rollout_observations_native

        return ObsRollout(*rollout_observations_native(x_true, landmarks, max_range, nz,
                                                       interval))
    lm = np.asarray(landmarks, np.float32)                # (L, 2)
    poses = np.asarray(x_true, np.float32)[interval - 1 :: interval]  # (F, 3)
    n_frames = poses.shape[0]
    z = np.zeros((n_frames, nz, 2), np.float32)
    ids = np.full((n_frames, nz), -1, np.int32)
    mask = np.zeros((n_frames, nz), bool)
    for f0 in range(0, n_frames, OBS_CHUNK):
        pc = poses[f0:f0 + OBS_CHUNK]
        d = lm[None, :, :] - pc[:, None, :2]              # (chunk, L, 2)
        dx, dy = d[..., 0], d[..., 1]
        rng = np.sqrt(dx * dx + dy * dy, dtype=np.float32)
        brg = (
            np.arctan2(dy, dx).astype(np.float32)
            - pc[:, None, 2]
            + np.float32(np.pi)
        ) % np.float32(2 * np.pi) - np.float32(np.pi)
        in_box = np.logical_and(np.abs(dx) < max_range, np.abs(dy) < max_range)
        ahead = dx * np.cos(pc[:, None, 2]) + dy * np.sin(pc[:, None, 2]) > 0.0
        in_circle = dx * dx + dy * dy < np.float32(max_range) ** 2
        visible = in_box & ahead & in_circle              # (chunk, L)
        for k in range(pc.shape[0]):
            f = f0 + k
            (vis_idx,) = np.nonzero(visible[k])
            vis_idx = vis_idx[:nz]
            n = vis_idx.shape[0]
            ids[f, :n] = vis_idx
            mask[f, :n] = True
            z[f, :n, 0] = rng[k, vis_idx]
            z[f, :n, 1] = brg[k, vis_idx]
    return ObsRollout(z_true=z, ids=ids, mask=mask)
