"""Loop-closure front end: keyframes, closure constraints, graph assembly
(port of conan_slam_tpu.graph.frontend; BASELINE config 4).

The pipeline (static shapes):
  1. keyframes: the estimated trajectory every ``keyframe_stride`` steps;
  2. odometry edges: the relative pose between consecutive keyframe
     estimates (what the filter believed it travelled);
  3. closure edges: revisit candidates from ``detect_loop_closures`` with a
     simulated scan-match measurement (true relative pose + matcher noise);
  4. relaxation with ``optimize``.

The reference draws its noise from PRNG keys; here the standard-normal
draws come in as tensors (a parity test passes the reference's own), or
are drawn from a ``torch.Generator`` on the trajectory's device (``None``:
that device's default generator).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.graph.pose_graph import (
    PoseGraph,
    detect_loop_closures,
    optimize,
    relative_pose,
)


class ClosureConfig(NamedTuple):
    keyframe_stride: int = 50        # control steps between keyframes
    max_closures: int = 64
    radius: float = 100.0            # revisit radius [m]
    min_index_gap: int = 40          # keyframes apart to count as a revisit
    # The odometry edges' noise must follow the filter's drift per keyframe
    # interval (overweighted odometry makes the chain too stiff for the
    # closures to correct).
    odo_sigma_xy: float = 1.0        # odometry edge noise [m]
    odo_sigma_th: float = 0.02       # [rad]
    closure_sigma_xy: float = 0.5    # simulated scan-match noise [m]
    closure_sigma_th: float = 0.01   # [rad]


class GraphDraws(NamedTuple):
    """``simulate_odometry_graph``'s standard-normal draws."""
    odo: torch.Tensor       # (T - 1, 3) the odometry noise
    closure: torch.Tensor   # (C, 3) the scan-match noise


def _normal(draws, shape, like: torch.Tensor) -> torch.Tensor:
    """``draws`` where it is a tensor, else ``shape`` standard normals from
    the generator ``draws`` (None: the default one) on ``like``'s device."""
    if torch.is_tensor(draws):
        if tuple(draws.shape) != tuple(shape):
            raise ValueError(f"draws of shape {tuple(draws.shape)}, expected {tuple(shape)}")
        return draws.to(like.device, like.dtype)
    return torch.randn(shape, generator=draws, dtype=like.dtype, device=like.device)


def _diag_info(sx: float, sth: float, n: int, like: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([1.0 / sx**2, 1.0 / sx**2, 1.0 / sth**2], dtype=like.dtype,
                     device=like.device)
    return torch.diag(w)[None].repeat(n, 1, 1)


def _chain_edges(t: int, device) -> torch.Tensor:
    ar = torch.arange(t, device=device)
    return torch.stack([ar[:-1], ar[1:]], dim=1)


def _closure_edges(kf_true, det, kf_valid, cfg: ClosureConfig, noise):
    """The closure pairs found on ``det``, clipped to safe indices, their
    mask and measurements (true relative pose + scaled ``noise``
    draws), and their information."""
    t = kf_true.shape[0]
    pairs, pair_mask = detect_loop_closures(det, kf_valid, max_candidates=cfg.max_closures,
                                            radius=cfg.radius, min_index_gap=cfg.min_index_gap)
    safe = torch.clamp(pairs, 0, t - 1)
    cl_true = relative_pose(kf_true[safe[:, 0]], kf_true[safe[:, 1]])
    sig = torch.tensor([cfg.closure_sigma_xy, cfg.closure_sigma_xy, cfg.closure_sigma_th],
                       dtype=cl_true.dtype, device=cl_true.device)
    cl_meas = cl_true + _normal(noise, cl_true.shape, cl_true) * sig
    info = _diag_info(cfg.closure_sigma_xy, cfg.closure_sigma_th, pairs.shape[0], kf_true)
    return safe, pair_mask, cl_meas, info


def build_graph(est_traj, true_traj, valid, cfg: ClosureConfig, noise=None, det_nodes=None,
                init_nodes=None) -> PoseGraph:
    """A pose graph from a (T, 3) trajectory.

    ``est_traj`` gives the node initial values and the odometry edges;
    ``true_traj`` plus ``noise`` (C, 3) standard-normal draws (or a
    generator) the closure measurements (a simulated matcher); ``valid``
    masks the steps after the course ends.  ``det_nodes`` (keyframe rate)
    replaces the true keyframe positions for revisit detection (the
    iterated pipeline detects on the previous round's relaxed nodes), and
    ``init_nodes`` the node initial values.  As in the reference,
    ``init_nodes`` replaces the keyframe estimates before the odometry is
    derived from them, so the odometry edges follow the given nodes.
    """
    stride = cfg.keyframe_stride
    kf_est = est_traj[::stride]
    kf_true = true_traj[::stride]
    kf_valid = valid[::stride]
    t = kf_est.shape[0]
    if init_nodes is not None:
        kf_est = init_nodes

    odo_meas = relative_pose(kf_est[:-1], kf_est[1:])
    odo_mask = torch.logical_and(kf_valid[:-1], kf_valid[1:])
    odo_info = _diag_info(cfg.odo_sigma_xy, cfg.odo_sigma_th, t - 1, kf_est)
    # Detection on the true keyframe positions by default: place
    # recognition sees the world, not the drifted estimate.
    safe, pair_mask, cl_meas, cl_info = _closure_edges(
        kf_true, kf_true if det_nodes is None else det_nodes, kf_valid, cfg, noise)
    return PoseGraph(
        nodes=kf_est, node_mask=kf_valid,
        edges=torch.cat([_chain_edges(t, kf_est.device), safe]),
        meas=torch.cat([odo_meas, cl_meas]), info=torch.cat([odo_info, cl_info]),
        edge_mask=torch.cat([odo_mask, pair_mask]),
    )


def compose_pose(pose: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """SE(2) composition pose (+) rel (both (..., 3))."""
    c = torch.cos(pose[..., 2])
    s = torch.sin(pose[..., 2])
    return torch.stack([pose[..., 0] + c * rel[..., 0] - s * rel[..., 1],
                        pose[..., 1] + s * rel[..., 0] + c * rel[..., 1],
                        wrap_angle(pose[..., 2] + rel[..., 2])], dim=-1)


def simulate_odometry_graph(true_traj, valid, cfg: ClosureConfig, noise=None) -> PoseGraph:
    """A dead-reckoned odometry chain with simulated closures on a true
    trajectory: between closures only noisy relative odometry informs the
    graph, so the integrated chain drifts without bound, and closures at
    the revisits (detected on the true positions, with scan-match noise)
    constrain its shape.  ``noise``: a ``GraphDraws`` of standard normals,
    or a generator (the odometry's draws first).
    """
    stride = cfg.keyframe_stride
    kf_true = true_traj[::stride]
    kf_valid = valid[::stride]
    t = kf_true.shape[0]
    if isinstance(noise, GraphDraws):
        odo_noise, cl_noise = noise.odo, noise.closure
    else:
        odo_noise = _normal(noise, (t - 1, 3), kf_true)
        cl_noise = noise

    rel_true = relative_pose(kf_true[:-1], kf_true[1:])
    sig = torch.tensor([cfg.odo_sigma_xy, cfg.odo_sigma_xy, cfg.odo_sigma_th],
                       dtype=rel_true.dtype, device=rel_true.device)
    rel_noisy = rel_true + sig * _normal(odo_noise, rel_true.shape, rel_true)

    # Integrate the noisy chain, one keyframe after another (the dead-reckoned
    # node initial values).
    chain = [kf_true[0]]
    for k in range(t - 1):
        chain.append(compose_pose(chain[-1], rel_noisy[k]))
    nodes = torch.stack(chain)

    odo_mask = torch.logical_and(kf_valid[:-1], kf_valid[1:])
    odo_info = _diag_info(cfg.odo_sigma_xy, cfg.odo_sigma_th, t - 1, kf_true)
    safe, pair_mask, cl_meas, cl_info = _closure_edges(kf_true, kf_true, kf_valid, cfg, cl_noise)
    return PoseGraph(
        nodes=nodes, node_mask=kf_valid,
        edges=torch.cat([_chain_edges(t, kf_true.device), safe]),
        meas=torch.cat([rel_noisy, cl_meas]), info=torch.cat([odo_info, cl_info]),
        edge_mask=torch.cat([odo_mask, pair_mask]),
    )


def relax_trajectory(est_traj, true_traj, valid, cfg: ClosureConfig, noise=None, *,
                     iterations: int = 10, cg_iterations: int | None = None, rounds: int = 1,
                     detect_on_estimate: bool = False):
    """Build and optimise the pose graph; returns (graph, optimised graph).

    ``noise``: each round's closure draws, (rounds, C, 3) standard normals
    (round r uses ``noise[r]``), or a generator.  ``cg_iterations``
    defaults to the keyframe count (at least 60), set in the first round
    and kept: corrections travel about one node per CG iteration along the
    odometry chain.  ``rounds`` > 1 iterates detect -> relax from the
    previous round's relaxed nodes; with ``detect_on_estimate`` detection
    runs on the current estimate (the pipeline without the oracle), else
    on the truth, where a second round finds nothing new and the loop
    stops after the first, as the reference's does.
    """
    det = est_traj[::cfg.keyframe_stride] if detect_on_estimate else None
    g_opt = None
    for r in range(max(1, rounds)):
        g = build_graph(est_traj, true_traj, valid, cfg,
                        noise[r] if torch.is_tensor(noise) else noise, det_nodes=det,
                        init_nodes=None if g_opt is None else g_opt.nodes)
        if cg_iterations is None:
            cg_iterations = max(60, g.nodes.shape[0])
        g_opt = optimize(g, iterations=iterations, cg_iterations=cg_iterations,
                         chordal_init=g_opt is None)
        if detect_on_estimate:
            det = g_opt.nodes
        elif rounds > 1 and r == 0:
            break
    return g, g_opt
