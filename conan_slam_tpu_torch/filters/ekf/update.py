"""EKF measurement updates (port of conan_slam_tpu.filters.ekf.update):
the per-frame forms ``batch_update``, ``sequential_update`` and ``update``
(reference EKF::batchUpdate, EKF.cpp:93-129, EKF::singleUpdate,
EKF.cpp:457-479, EKF::update, EKF.cpp:481-496), plain PyTorch as the
reference's are plain jnp; and the whole-frame kernels' entries,
``fused_frame_step`` and ``fused_frame_pair_step`` for known association
and ``fused_frame_update`` for the gated path (fp32 tier only)."""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.observe import build_batch_operator, wrap_heading
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import sensor
from conan_slam_tpu_torch.ops.cholesky_update import cholesky_update
from conan_slam_tpu_torch.ops.frame_kernel import (
    frame_rows,
    frame_step,
    frame_step_pair,
    frame_update_obs,
)


def batch_update(state: EKFState, obs: CompactObs, slots, mask, r_cov,
                 *, return_nis: bool = False):
    """One joint Cholesky update over every associated measurement."""
    v, h, rr = build_batch_operator(state, obs, slots, mask, r_cov)
    out = cholesky_update(state.x, state.p, v, rr, h, return_nis=return_nis)
    new_state = state._replace(x=wrap_heading(out[0]), p=out[1])
    return (new_state, out[2]) if return_nis else new_state


def sequential_update(state: EKFState, obs: CompactObs, slots, mask, r_cov,
                      *, return_nis: bool = False):
    """One update a measurement slot, in buffer order (the reference's
    order-dependent semantics; its ``lax.scan`` is a loop over the NZ
    slots here).  A masked slot runs as the reference's does, with zero H,
    zero innovation and identity R, and so adds nothing.  With
    ``return_nis`` also the sum of the slots' NIS."""
    d = state.x.shape[0]
    safe = torch.clamp(slots, 0, state.capacity - 1)
    eye2 = torch.eye(2, dtype=state.p.dtype, device=state.p.device)
    two = torch.arange(2, device=state.x.device)
    x, p = state.x, state.p
    nis = []
    for i in range(obs.z.shape[0]):
        cols = 3 + 2 * safe[i] + two                          # (2,) the slot's columns
        zp, hv, hf = sensor.observe(x[:3], x[cols])
        z_i, m_i = obs.z[i], mask[i]
        v = torch.stack([z_i[0] - zp[0], wrap_angle(z_i[1] - zp[1])])
        h = torch.zeros((2, d), dtype=p.dtype, device=p.device)
        h[:, :3] = hv
        h.scatter_(1, cols[None, :].expand(2, 2), hf)
        x, p, nis_i = cholesky_update(x, p, torch.where(m_i, v, 0.0), torch.where(m_i, r_cov, eye2),
                                      torch.where(m_i, h, 0.0), return_nis=True)
        nis.append(nis_i)
    new_state = state._replace(x=wrap_heading(x), p=p)
    return (new_state, torch.stack(nis).sum()) if return_nis else new_state


def update(state: EKFState, obs: CompactObs, slots, mask, r_cov, batch: bool,
           *, return_nis: bool = False):
    """``batch_update`` or ``sequential_update`` as the batch switch says."""
    fn = batch_update if batch else sequential_update
    return fn(state, obs, slots, mask, r_cov, return_nis=return_nis)


def fused_frame_step(state: EKFState, vns, swans, phis, actives, q_cov,
                     obs: CompactObs, slots, mask, r_cov, wheel_base, dt,
                     sigma_heading, use_heading: bool, *, plain: bool = False):
    """S predict + heading sub-steps, observe and measurement update of one
    frame (ops.frame_kernel.frame_step); the association table lookup is
    the only work left between frames.  The frame's raw slots and buffers
    go to ``frame_step``, whose default route (H9) forms the gathered rows
    and the packing in its launch.

    Returns ``(new_state, pose_trace (S, 3), nis per associated measurement)``.
    """
    fs = frame_step(state.p, state.x, slots, state.capacity, vns, swans, phis, actives, q_cov,
                    obs.z[:, 0], obs.z[:, 1], mask, r_cov, wheel_base, dt, sigma_heading,
                    use_heading, plain=plain)
    n_meas = torch.clamp(mask.to(fs.x.dtype).sum(), min=1.0)
    return state._replace(x=fs.x, p=fs.p), fs.pose_trace, fs.nis / n_meas


def fused_frame_pair_step(state: EKFState, vns2, swans2, phis2, actives2, q_cov,
                          obs_a: CompactObs, slots_a, mask_a, obs_b: CompactObs, slots_b,
                          mask_b, r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
                          *, plain: bool = False):
    """Two known-association frames with one P pass
    (ops.frame_kernel.frame_step_pair).  ``vns2``/``swans2``/``phis2``/
    ``actives2`` (2, S) stack both frames' controls; both frames' slots
    index the same table (the caller runs no augmentation between them).

    The pair runs the split schedule wherever it fits.  Past its limits
    (256 sub-steps, MP 2048) it is two sequential frames of the plain route
    where the reference, too, falls back to two frames (its TPU schedule
    has no tile), and raises on the card where the reference has one.
    Returns
    ``(new_state, pose_trace (2, S, 3), nis per associated measurement
    (2,), pose_mid (3,))``, ``pose_mid`` being frame A's post-update pose.
    """
    cap = state.capacity
    fp = frame_step_pair(
        state.p, state.x, frame_rows(slots_a, cap),
        (vns2[0], swans2[0], phis2[0], actives2[0]), (obs_a.z[:, 0], obs_a.z[:, 1], mask_a),
        frame_rows(slots_b, cap),
        (vns2[1], swans2[1], phis2[1], actives2[1]), (obs_b.z[:, 0], obs_b.z[:, 1], mask_b),
        q_cov, r_cov, wheel_base, dt, sigma_heading, use_heading, plain=plain,
    )
    n_meas = torch.clamp(torch.stack([mask_a.sum(), mask_b.sum()]).to(fp.x.dtype), min=1.0)
    return state._replace(x=fp.x, p=fp.p), fp.pose_trace, fp.nis / n_meas, fp.pose_mid


def fused_frame_update(state: EKFState, bmat, vtf, obs: CompactObs, slots, mask,
                       r_cov, *, return_nis: bool = False, plain: bool = False):
    """Frame-factored batch update: ONE rewrite of P per observation frame.

    ``state.p`` is the frame-START covariance and ``state.x`` the
    post-factor mean; the frame's predict + heading effect is the factored
    correction vtf^T B vtf, given as the row strip ``vtf`` (r, D) and
    ``bmat`` (r, r) of ops.factor_kernel.  The update runs against the
    virtual covariance P' = P + vtf^T B vtf without materialising it
    (ops.frame_kernel.frame_update_obs: H10, one C entry, by default; the
    split schedule past MP 224; the reference's jnp route past the port's
    kernels where the reference has no TPU schedule either).  The frame's
    raw slots and the table's capacity go to ``frame_update_obs``, whose
    default route forms the gathered rows and the packing in its launch.
    Masked measurements contribute nothing, so a frame with none applies
    the correction alone.

    Returns the new state, and with ``return_nis`` also the stacked NIS per
    associated measurement.  ``plain=True`` runs the kernels' plain
    versions.
    """
    fu = frame_update_obs(
        state.p, state.x, slots, state.capacity, obs.z[:, 0], obs.z[:, 1], mask, r_cov, bmat,
        vtf, plain=plain,
    )
    new_state = state._replace(x=fu.x, p=fu.p)
    if return_nis:
        n_meas = torch.clamp(mask.to(fu.x.dtype).sum(), min=1.0)
        return new_state, fu.nis / n_meas
    return new_state
