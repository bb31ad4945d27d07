"""Trajectory metrics (port of conan_slam_tpu.runner.metrics.ate_rmse)."""

from __future__ import annotations

import torch


def ate_rmse(x_true: torch.Tensor, x_est: torch.Tensor, valid=None) -> torch.Tensor:
    """Absolute trajectory error (position RMSE) over (T, 3) trajectories,
    optionally over the steps where ``valid`` (T,) is True."""
    err2 = torch.sum((x_true[:, :2] - x_est[:, :2]) ** 2, dim=-1)
    if valid is None:
        return torch.sqrt(torch.mean(err2))
    w = valid.to(err2.dtype)
    return torch.sqrt(torch.sum(err2 * w) / torch.clamp(torch.sum(w), min=1.0))
