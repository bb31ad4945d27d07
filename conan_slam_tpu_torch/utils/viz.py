"""Trajectory and map plot (port of conan_slam_tpu.utils.viz): ground
truth against the estimate, the landmark map and covariance ellipses.
numpy only; matplotlib is imported when a plot is made."""

from __future__ import annotations

import numpy as np


def _np(a):
    """A numpy array from a tensor (on any device) or an array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _ellipse_path(mean, cov2, n_sigma: float = 2.0, n_pts: int = 40):
    """(n_pts, 2) polyline of the ``n_sigma`` ellipse of a 2x2 covariance
    block: the unit circle through n_sigma times its square root (negative
    eigenvalues of a float block clipped to 0)."""
    cov2 = np.asarray(cov2, np.float64)
    cov2 = 0.5 * (cov2 + cov2.T)
    w, vec = np.linalg.eigh(cov2)
    l = vec * np.sqrt(np.clip(w, 0.0, None))[None, :]
    ang = np.linspace(0.0, 2.0 * np.pi, n_pts)
    circ = np.stack([np.cos(ang), np.sin(ang)])
    return np.asarray(mean)[None, :] + n_sigma * (l @ circ).T


def plot_run(x_true, x_est, landmarks=None, features=None, active_mask=None, valid=None, p=None,
             ellipse_stride: int = 1, n_sigma: float = 2.0,
             title: str = "conan_slam_tpu_torch valet loop", save_path: str | None = None):
    """Plot a run; returns the matplotlib figure.

    ``x_true``/``x_est`` (T, 3); optional ``landmarks`` (N, 2) true,
    ``features`` (K, 2) estimated with ``active_mask`` (K,), ``valid`` (T,)
    steps to draw, ``p`` (D, D) the joint covariance (the pose ellipse at
    the end and one a ``ellipse_stride``-th active feature);
    ``save_path`` also writes a PNG.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x_true, x_est = _np(x_true), _np(x_est)
    if valid is not None:
        v = _np(valid)
        x_true, x_est = x_true[v], x_est[v]
    pm = None if p is None else _np(p)

    fig, ax = plt.subplots(figsize=(9, 8))
    if landmarks is not None:
        lm = _np(landmarks)
        ax.plot(lm[:, 0], lm[:, 1], "k*", ms=8, alpha=0.5, label="landmarks (true)")
    if features is not None:
        f = _np(features)
        mask = _np(active_mask) if active_mask is not None else np.ones((f.shape[0],), bool)
        fa = f[mask]
        ax.plot(fa[:, 0], fa[:, 1], "rx", ms=6, label="landmarks (est)")
        if pm is not None:
            for i, k in enumerate(np.flatnonzero(mask)[::max(1, ellipse_stride)]):
                path = _ellipse_path(f[k], pm[3 + 2 * k: 5 + 2 * k, 3 + 2 * k: 5 + 2 * k], n_sigma)
                ax.plot(path[:, 0], path[:, 1], "r-", lw=0.6, alpha=0.5,
                        label=f"{n_sigma:g}-sigma (features)" if i == 0 else None)
    if pm is not None and x_est.shape[0]:
        path = _ellipse_path(x_est[-1, :2], pm[:2, :2], n_sigma)
        ax.plot(path[:, 0], path[:, 1], "b-", lw=1.0, alpha=0.8, label=f"{n_sigma:g}-sigma (pose)")
    ax.plot(x_true[:, 0], x_true[:, 1], "g-", lw=1.5, label="trajectory (true)")
    ax.plot(x_est[:, 0], x_est[:, 1], "b--", lw=1.0, label="trajectory (est)")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="best")
    ax.axis("equal")
    ax.grid(alpha=0.3)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
