"""Bicycle kinematics and its analytic Jacobians (port of
conan_slam_tpu.models.motion; reference vehicleModel, slam.h:952-966)."""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle


def step(pose, v, swa, wheel_base, dt):
    """One bicycle-model step; ``pose`` is (..., 3) = (x, y, phi)."""
    phi = pose[..., 2]
    a = swa + phi
    return torch.stack(
        [
            pose[..., 0] + v * dt * torch.cos(a),
            pose[..., 1] + v * dt * torch.sin(a),
            wrap_angle(phi + v * dt * torch.sin(swa) / wheel_base),
        ],
        dim=-1,
    )


def jacobians(pose, v, swa, wheel_base, dt):
    """(Gv, Gu): d(step)/d(pose) (..., 3, 3) and d(step)/d(v, swa) (..., 3, 2)."""
    phi = pose[..., 2]
    a = swa + phi
    sa, ca = torch.sin(a), torch.cos(a)
    one = torch.ones_like(phi)
    zero = torch.zeros_like(phi)
    gv = torch.stack(
        [
            torch.stack([one, zero, -v * dt * sa], dim=-1),
            torch.stack([zero, one, v * dt * ca], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )
    gu = torch.stack(
        [
            torch.stack([dt * ca, -v * dt * sa], dim=-1),
            torch.stack([dt * sa, v * dt * ca], dim=-1),
            torch.stack(
                [
                    dt * torch.sin(swa) / wheel_base * one,
                    v * dt * torch.cos(swa) / wheel_base * one,
                ],
                dim=-1,
            ),
        ],
        dim=-2,
    )
    return gv, gu
