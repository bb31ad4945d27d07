"""Trajectory and consistency metrics (port of
conan_slam_tpu.runner.metrics): ATE, SE(2)-aligned ATE, RPE, heading RMSE
and map RMSE, each over (T, 3) trajectories or the map, optionally over
the steps where ``valid`` (T,) is True."""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle


def _masked_rms(err2, valid):
    if valid is None:
        return torch.sqrt(torch.mean(err2))
    w = valid.to(err2.dtype)
    return torch.sqrt(torch.sum(err2 * w) / torch.clamp(torch.sum(w), min=1.0))


def ate_rmse(x_true: torch.Tensor, x_est: torch.Tensor, valid=None) -> torch.Tensor:
    """Absolute trajectory error: the position RMSE."""
    return _masked_rms(torch.sum((x_true[:, :2] - x_est[:, :2]) ** 2, dim=-1), valid)


def aligned_ate_rmse(x_true: torch.Tensor, x_est: torch.Tensor, valid=None) -> torch.Tensor:
    """ATE after the optimal SE(2) alignment of the estimate to the truth
    (Horn/Umeyama closed form, rotation and translation, no scale)."""
    w = (valid if valid is not None
         else torch.ones(x_true.shape[0], dtype=torch.bool, device=x_true.device)).to(x_true.dtype)
    wsum = torch.clamp(torch.sum(w), min=1.0)
    pt, pe = x_true[:, :2], x_est[:, :2]
    mu_t = torch.sum(pt * w[:, None], dim=0) / wsum
    mu_e = torch.sum(pe * w[:, None], dim=0) / wsum
    ct, ce = pt - mu_t, pe - mu_e
    sxx = torch.sum(w * ce[:, 0] * ct[:, 0])
    syy = torch.sum(w * ce[:, 1] * ct[:, 1])
    sxy = torch.sum(w * ce[:, 0] * ct[:, 1])
    syx = torch.sum(w * ce[:, 1] * ct[:, 0])
    theta = torch.atan2(sxy - syx, sxx + syy)
    c, s = torch.cos(theta), torch.sin(theta)
    rot = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    aligned = ce @ rot.T + mu_t
    err2 = torch.sum((aligned - pt) ** 2, dim=-1)
    return torch.sqrt(torch.sum(err2 * w) / wsum)


def rpe_rmse(x_true: torch.Tensor, x_est: torch.Tensor, delta: int, valid=None) -> torch.Tensor:
    """Relative pose error over ``delta`` steps: the translational RMSE of
    each trajectory's motion from t to t + delta in its own frame at t
    (gauge-free drift)."""
    def rel(x):
        c, s = torch.cos(x[:-delta, 2]), torch.sin(x[:-delta, 2])
        d = x[delta:, :2] - x[:-delta, :2]
        return torch.stack([c * d[:, 0] + s * d[:, 1], -s * d[:, 0] + c * d[:, 1]], dim=-1)

    err2 = torch.sum((rel(x_true) - rel(x_est)) ** 2, dim=-1)
    return _masked_rms(err2, None if valid is None else valid[:-delta] & valid[delta:])


def heading_rmse(x_true: torch.Tensor, x_est: torch.Tensor, valid=None) -> torch.Tensor:
    """RMSE of the wrapped heading error."""
    return _masked_rms(wrap_angle(x_true[:, 2] - x_est[:, 2]) ** 2, valid)


def map_rmse(landmarks_true, features_est, active_mask, table) -> torch.Tensor:
    """RMSE of the mapped landmarks: each landmark id with a slot in
    ``table`` against that slot's estimate (``active_mask`` is unused, as in
    the reference: the table names the mapped slots)."""
    has_slot = table >= 0
    est = features_est[torch.clamp(table, 0, features_est.shape[0] - 1)]
    err2 = torch.sum((est - landmarks_true) ** 2, dim=-1)
    w = has_slot.to(err2.dtype)
    return torch.sqrt(torch.sum(err2 * w) / torch.clamp(torch.sum(w), min=1.0))
