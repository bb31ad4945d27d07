"""Range-bearing sensor model (port of conan_slam_tpu.models.sensor;
reference EKF::observeModel, EKF.cpp:354-404).

The pose may carry leading dimensions (the particle filter's (N, 3)
ensemble): they are the features' or measurements' first dimensions, and
the rest of theirs broadcast against one pose (``_pose_part``).
"""

from __future__ import annotations

import torch


def _pose_part(pose, k: int, like):
    """Pose component ``k`` shaped to broadcast against ``like``, whose
    leading dimensions are the pose's: a () tensor for one pose against a
    feature, (1,) against (M,) features, (N, 1) for N poses against
    (N, M) features.  The values, and so every result, are the same as
    indexing one pose."""
    c = pose[..., k]
    return c.reshape(c.shape + (1,) * (like.dim() - c.dim()))


def observe(pose, xf):
    """Predicted measurement and Jacobian blocks for features ``xf`` (..., 2)
    from ``pose`` (..., 3) (see ``_pose_part``).

    Returns ``(zp (..., 2), hv (..., 2, 3), hf (..., 2, 2))``; the bearing
    is unwrapped.
    """
    dx = xf[..., 0] - _pose_part(pose, 0, xf[..., 0])
    dy = xf[..., 1] - _pose_part(pose, 1, xf[..., 1])
    # Guard the r=0 singularity (inactive map slots sit at the origin).
    d2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    d = torch.sqrt(d2)
    xd, yd = dx / d, dy / d
    xd2, yd2 = dx / d2, dy / d2

    zp = torch.stack([d, torch.atan2(dy, dx) - _pose_part(pose, 2, d)], dim=-1)
    zero = torch.zeros_like(d)
    one = torch.ones_like(d)
    hv = torch.stack(
        [
            torch.stack([-xd, -yd, zero], dim=-1),
            torch.stack([yd2, -xd2, -one], dim=-1),
        ],
        dim=-2,
    )
    hf = torch.stack(
        [
            torch.stack([xd, yd], dim=-1),
            torch.stack([-yd2, xd2], dim=-1),
        ],
        dim=-2,
    )
    return zp, hv, hf


def init_feature(pose, z):
    """Inverse sensor model: new-feature position and its Jacobians from
    measurement(s) ``z`` (..., 2) = (range, bearing) from ``pose`` (..., 3)
    (see ``_pose_part``).

    Returns ``(xf (..., 2), gv (..., 2, 3) d(xf)/d(pose), gz (..., 2, 2)
    d(xf)/d(z))`` (reference EKF.cpp:47-64).
    """
    r = z[..., 0]
    ang = _pose_part(pose, 2, r) + z[..., 1]
    s, c = torch.sin(ang), torch.cos(ang)
    xf = torch.stack([_pose_part(pose, 0, r) + r * c, _pose_part(pose, 1, r) + r * s],
                     dim=-1)
    one = torch.ones_like(r)
    zero = torch.zeros_like(r)
    gv = torch.stack([
        torch.stack([one, zero, -r * s], dim=-1),
        torch.stack([zero, one, r * c], dim=-1),
    ], dim=-2)
    gz = torch.stack([
        torch.stack([c, -r * s], dim=-1),
        torch.stack([s, r * c], dim=-1),
    ], dim=-2)
    return xf, gv, gz
