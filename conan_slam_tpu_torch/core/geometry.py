"""Angle and planar-geometry primitives (port of conan_slam_tpu.core.geometry)."""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap_angle(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to [-pi, pi).

    Same remainder convention as the reference (``jnp.remainder`` takes the
    sign of the divisor, as ``torch.remainder`` does), so the two agree at
    the wrap.
    """
    return torch.remainder(angle + math.pi, TWO_PI) - math.pi


def range_bearing(pose: torch.Tensor, points: torch.Tensor):
    """Range and (unwrapped) bearing of ``points`` (..., 2) from ``pose`` (3,)."""
    d = points - pose[:2]
    rng = torch.sqrt(torch.sum(d * d, dim=-1))
    brg = torch.atan2(d[..., 1], d[..., 0]) - pose[2]
    return rng, brg
