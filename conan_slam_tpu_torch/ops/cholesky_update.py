"""Cholesky-form Kalman measurement update and the Joseph forms (port of
conan_slam_tpu.ops.cholesky_update; reference choleskyUpdate,
slam.h:235-266, and josephUpdate, slam.h:700-725).

The reference computes these in plain jnp outside any Pallas kernel, so
here they are plain PyTorch (``torch.linalg`` on either device); every
product is full fp32 (TF32 stays off, conan_slam_tpu_torch/__init__.py).
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.linalg import safe_cholesky, sym


def cholesky_update(x, p, v, r, h, *, jitter: float = 0.0, return_nis: bool = False):
    """One Kalman update in Cholesky form:

        PHT = P H^T;  S = sym(H PHT + R) = L L^T
        W1  = PHT L^-T;  x += W1 L^-1 v;  P = sym(P - W1 W1^T)

    ``x`` (D,), ``p`` (D, D), ``v`` (m,) wrapped innovation (0 on masked
    rows), ``r`` (m, m) (identity blocks on masked rows), ``h`` (m, D)
    (zero rows where masked).  Returns ``(x', p')``, and with
    ``return_nis`` also nis = ||L^-1 v||^2.  Masked rows add nothing: their
    H rows and innovations are zero.
    """
    pht = p @ h.T
    s = sym(h @ pht + r)
    chol = safe_cholesky(s, jitter)
    eye = torch.eye(s.shape[-1], dtype=s.dtype, device=s.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    w1t = linv @ pht.T
    lv = linv @ v
    x_new = x + w1t.T @ lv
    p_new = sym(p - w1t.T @ w1t)
    if return_nis:
        return x_new, p_new, torch.dot(lv, lv)
    return x_new, p_new


def joseph_update(x, p, v, r, h):
    """Joseph-form update: W = P H^T (H P H^T + R)^-1, x += W v,
    P = (I - W H) P (I - W H)^T + W R W^T."""
    pht = p @ h.T
    s = sym(h @ pht + r)
    w = torch.linalg.solve(s, pht.T).T
    x_new = x + w @ v
    c = torch.eye(p.shape[0], dtype=p.dtype, device=p.device) - w @ h
    return x_new, sym(c @ p @ c.T + (w @ r) @ w.T)


def joseph_update_scalar(x, p, v, r_scalar, idx: int):
    """Rank-1 Joseph update for a direct observation of ``x[idx]`` (the
    heading, reference EKF.cpp:328-352): with pc = P[:, idx] and
    s = P[idx, idx] + r, w = pc / s, x += w v and
    P = sym(P - w pc^T - pc w^T + s w w^T)."""
    pc = p[:, idx]
    s = p[idx, idx] + r_scalar
    w = pc / s
    x_new = x + w * v
    outer_wpc = torch.outer(w, pc)
    return x_new, sym(p - outer_wpc - outer_wpc.T + s * torch.outer(w, w))
