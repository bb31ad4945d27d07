"""Small dense linear algebra (port of conan_slam_tpu.core.linalg): the EKF's
helpers, and the particle filter's batched closed-form 2x2 / 3x3 algebra."""

from __future__ import annotations

import math

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


# The particle filter's closed forms (the reference's core/linalg.py:80-206):
# batched over any leading dimensions, in the reference's arithmetic form
# (broadcast-multiply-sum products, adjugate inverse, scalar Cholesky) so
# that the two packages round alike.

# log(2 pi) as the reference forms it: the float32 log of float32(2 pi).
_LOG_2PI = float(torch.log(torch.tensor(2.0 * math.pi, dtype=torch.float32)))


def _cofactors3(m: torch.Tensor):
    """The cofactor matrix of (..., 3, 3) matrices, C[i][j] = m[i+1][j+1]
    m[i+2][j+2] - m[i+1][j+2] m[i+2][j+1] (indices mod 3: rows and columns
    rolled), and their determinant sum_j m[0][j] C[0][j], in a few
    whole-tensor operations.  Each entry is the reference's closed-form one
    bit for bit: the same two rounded products subtracted (a negated
    difference is the difference taken the other way round, exactly), and
    the determinant summed in its order."""
    r1, r2 = m.roll(-1, -2), m.roll(-2, -2)
    c = r1.roll(-1, -1) * r2.roll(-2, -1) - r1.roll(-2, -1) * r2.roll(-1, -1)
    t = m[..., 0, :] * c[..., 0, :]
    return c, t[..., 0] + t[..., 1] + t[..., 2]


def _adjugate_inverse(c: torch.Tensor, det: torch.Tensor) -> torch.Tensor:
    idet = torch.where(det != 0, 1.0 / torch.where(det != 0, det, 1.0), 0.0)
    return c.transpose(-1, -2) * idet[..., None, None]


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate inverse of (..., 3, 3) matrices; zero where singular."""
    return _adjugate_inverse(*_cofactors3(m))


def bmm_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) @ (..., k, n) for tiny dims, as a broadcast product summed
    over k."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def bmv_small(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., m, k) x (..., k) -> (..., m) for tiny dims."""
    return (a * v[..., None, :]).sum(-1)


def quad_small(h: torch.Tensor, p: torch.Tensor, r: torch.Tensor | None = None) -> torch.Tensor:
    """H P H^T (+ R) for tiny blocks: (..., a, k), (..., k, k) -> (..., a, a)."""
    hp = bmm_small(h, p)
    out = (hp[..., :, None, :] * h[..., None, :, :]).sum(-1)
    return out if r is None else out + r


def det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) matrices."""
    return _cofactors3(m)[1]


def chol3(m: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Closed-form lower Cholesky of (..., 3, 3) SPD matrices, zero where a
    pivot is not positive (the reference's guard, slam.h:431-434)."""
    eps = 1e-30
    a = m[..., 0, 0] + jitter
    l11 = torch.sqrt(torch.clamp(a, min=eps))
    l21 = m[..., 1, 0] / l11
    l31 = m[..., 2, 0] / l11
    t22 = m[..., 1, 1] + jitter - l21 * l21
    l22 = torch.sqrt(torch.clamp(t22, min=eps))
    l32 = (m[..., 2, 1] - l31 * l21) / l22
    t33 = m[..., 2, 2] + jitter - l31 * l31 - l32 * l32
    l33 = torch.sqrt(torch.clamp(t33, min=eps))
    zero = torch.zeros_like(a)
    chol = torch.stack([
        torch.stack([l11, zero, zero], dim=-1),
        torch.stack([l21, l22, zero], dim=-1),
        torch.stack([l31, l32, l33], dim=-1),
    ], dim=-2)
    ok = (a > 0) & (t22 > 0) & (t33 > 0)
    return torch.where(ok[..., None, None], chol, 0.0)


def _jittered(s: torch.Tensor, jitter: float) -> torch.Tensor:
    if not jitter:
        return s
    return s + jitter * torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)


def mvn_logpdf2(v: torch.Tensor, s: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Closed-form log N(v; 0, S) for (..., 2) innovations, (..., 2, 2) S."""
    s = _jittered(s, jitter)
    det = torch.clamp(det2(s), min=1e-30)
    v0, v1 = v[..., 0], v[..., 1]
    maha = (s[..., 1, 1] * (v0 * v0) - (s[..., 0, 1] + s[..., 1, 0]) * v0 * v1
            + s[..., 0, 0] * (v1 * v1)) / det
    return -0.5 * (maha + torch.log(det) + 2.0 * _LOG_2PI)


def mvn_logpdf3(v: torch.Tensor, s: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Closed-form log N(v; 0, S) for (..., 3) innovations, (..., 3, 3) S."""
    c, det = _cofactors3(_jittered(s, jitter))
    maha = (v * bmv_small(_adjugate_inverse(c, det), v)).sum(-1)
    return -0.5 * (maha + torch.log(torch.clamp(det, min=1e-30)) + 3.0 * _LOG_2PI)


def solve_psd(s: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve S x = b (b (..., n, m)) for symmetric positive-definite S via
    its Cholesky factor (zero where the factor fails)."""
    return torch.cholesky_solve(b, safe_cholesky(s, jitter))


def sample_mvn(draws, mean: torch.Tensor, cov: torch.Tensor, num_samples: int | None = None,
               jitter: float = 0.0) -> torch.Tensor:
    """Sample(s) of N(mean, cov) via the Cholesky factor: (d,), or
    (num_samples, d) with ``num_samples``.  ``draws`` is the standard-normal
    draw of that shape, or a ``torch.Generator`` on mean's device to draw
    it from (the reference takes a key; its reference's rng was reseeded
    with a constant every call, slam.h:753-764)."""
    chol = safe_cholesky(cov, jitter)
    if isinstance(draws, torch.Generator):
        d = mean.shape[-1]
        shape = (d,) if num_samples is None else (num_samples, d)
        draws = torch.randn(shape, generator=draws, dtype=mean.dtype, device=mean.device)
    return mean + draws @ chol.transpose(-1, -2)


def mvn_logpdf(v: torch.Tensor, s: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Log-density of N(0, S) at innovation(s) ``v`` (..., d): the
    log-space form of the reference's ``gaussEvaluate`` (PF.cpp:279-317)
    with its log branch's defect fixed (the log of the Cholesky diagonal,
    SURVEY.md defect 7)."""
    d = v.shape[-1]
    chol = safe_cholesky(s, jitter)
    y = torch.linalg.solve_triangular(chol, v[..., None], upper=False)[..., 0]
    maha = (y * y).sum(-1)
    logdet = 2.0 * torch.log(torch.clamp(torch.diagonal(chol, dim1=-2, dim2=-1), min=1e-30)).sum(-1)
    return -0.5 * (maha + logdet + d * _LOG_2PI)
