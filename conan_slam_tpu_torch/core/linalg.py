"""Small dense linear algebra (port of the parts of conan_slam_tpu.core.linalg
that the EKF frame, gated association and augmentation use)."""

from __future__ import annotations

import torch


def sym(a: torch.Tensor) -> torch.Tensor:
    """(A + A^T)/2 over the last two axes."""
    return 0.5 * (a + a.transpose(-1, -2))


def safe_cholesky(s: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric PSD matrix, zero where it fails.

    The reference's degrade-don't-crash contract: a non-PD or non-finite
    input gives a zero factor instead of an exception.
    """
    n = s.shape[-1]
    if jitter:
        s = s + jitter * torch.eye(n, dtype=s.dtype, device=s.device)
    # cholesky_ex reports failure in ``info`` (JAX's cholesky gives NaN
    # instead); both count as failure here.
    chol, info = torch.linalg.cholesky_ex(sym(s))
    ok = torch.isfinite(chol).all(dim=(-2, -1), keepdim=True)
    ok = ok & (info == 0)[..., None, None]
    return torch.where(ok, chol, torch.zeros_like(chol))


def chol2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of a (2, 2) SPD matrix."""
    l00 = torch.sqrt(m[0, 0])
    l10 = m[1, 0] / l00
    l11 = torch.sqrt(torch.clamp(m[1, 1] - l10 * l10, min=0.0))
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z]), torch.stack([l10, l11])])


def inv2(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) matrices; zero where singular."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 1, 0], m[..., 1, 1]
    det = a * d - b * c
    idet = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    return torch.stack([
        torch.stack([d * idet, -b * idet], dim=-1),
        torch.stack([-c * idet, a * idet], dim=-1),
    ], dim=-2)


def det2(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 2, 2) matrices."""
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
