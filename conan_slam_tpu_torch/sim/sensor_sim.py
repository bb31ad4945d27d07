"""Sensor simulation: visibility, observations and noise (port of
conan_slam_tpu.sim.sensor_sim; reference getVisibleLandmarks,
slam.h:608-683, getObservations, slam.h:575-582, addControlNoise,
slam.h:149-159, addObservationNoise, slam.h:168-178).

The sensor returns every landmark with a visibility mask (static shapes;
filters.common.compact packs the visible ones).  The noise functions take
standard-normal draws, a tensor, where the reference takes a key: the
caller draws them (from a ``torch.Generator``, or the reference's own).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import range_bearing


class Observation(NamedTuple):
    z: torch.Tensor        # (num_landmarks, 2) (range, bearing) for every landmark
    visible: torch.Tensor  # (num_landmarks,) bool semicircular-FoV visibility


def visible_mask(pose, landmarks, max_range):
    """Semicircular field of view (reference slam.h:644-648): bounding box,
    heading half-plane and range circle."""
    d = landmarks - pose[:2]
    dx, dy = d[..., 0], d[..., 1]
    in_box = (torch.abs(dx) < max_range) & (torch.abs(dy) < max_range)
    ahead = dx * torch.cos(pose[2]) + dy * torch.sin(pose[2]) > 0.0
    in_circle = dx * dx + dy * dy < max_range**2
    return in_box & ahead & in_circle


def get_observations(pose_true, landmarks, max_range) -> Observation:
    """Exact range-bearing returns to every landmark, with the visibility
    mask (reference getObservations, un-compacted)."""
    rng, brg = range_bearing(pose_true, landmarks)
    return Observation(z=torch.stack([rng, brg], dim=-1),
                       visible=visible_mask(pose_true, landmarks, max_range))


def add_observation_noise(draws, obs: Observation, sigma_r, sigma_b, enabled: bool) -> Observation:
    """Additive N(0, R) noise on every return from standard-normal
    ``draws`` (num_landmarks, 2)."""
    if not enabled:
        return obs
    # Scaled by Python floats, not a (2,) tensor: making one would copy it
    # from the host every frame.
    noise = torch.stack([draws[..., 0] * sigma_r, draws[..., 1] * sigma_b], dim=-1)
    return obs._replace(z=obs.z + noise)


def add_control_noise(draws, v, swa, sigma_v, sigma_swa, enabled: bool):
    """Noisy odometry ``(v, swa)`` as tensors shaped like ``swa``, from
    standard-normal ``draws`` (..., 2)."""
    if not enabled:
        return torch.full_like(swa, v), swa
    return v + draws[..., 0] * sigma_v, swa + draws[..., 1] * sigma_swa
