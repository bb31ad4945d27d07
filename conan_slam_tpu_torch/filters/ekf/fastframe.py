"""Rank-compounded frame updates (port of conan_slam_tpu.filters.ekf.fastframe).

Every per-step covariance transform of a frame's S predict + heading
sub-steps has the form (I + a e2^T), which is closed under composition, so
the whole frame collapses to one symmetric rank-(2 + 3S) update

    P_frame = P0 + V B V^T,   every column of V in span{P0 e2, e0, e1, e2}

computed from the pose and (P0 e2)[:3] alone.  The recursion runs on
4-coefficient vectors; ``_frame_core`` expands them against P0 e2.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import chol2
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import motion


def frame_predict_heading(state: EKFState, vns, swans, phi_meas, active,
                          q_cov, wheel_base, dt, sigma_heading,
                          use_heading: bool, return_pose_trace: bool = False):
    """Apply ``S`` (predict + heading-observe) sub-steps as one rank update
    (reference EKF.cpp:406-455, 328-352)."""
    x, pose_trace, vmat, bmat = _frame_core(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    p = state.p + (vmat @ bmat) @ vmat.T
    new_state = state._replace(x=x, p=p)
    if return_pose_trace:
        return new_state, pose_trace
    return new_state


def frame_factors(state: EKFState, vns, swans, phi_meas, active, q_cov,
                  wheel_base, dt, sigma_heading, use_heading: bool):
    """Like ``frame_predict_heading`` but without materialising P: returns
    ``(state with updated mean and frame-start P, pose_trace (S, 3),
    vmat (D, r), bmat (r, r))``."""
    x, pose_trace, vmat, bmat = _frame_core(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    return state._replace(x=x), pose_trace, vmat, bmat


def _frame_core(state: EKFState, vns, swans, phi_meas, active, q_cov,
                wheel_base, dt, sigma_heading, use_heading: bool):
    """Shared S-sub-step compounding; returns ``(x, pose_trace, vmat, bmat)``."""
    q_chol = chol2(q_cov)
    p2_0 = state.p[:, 2]
    pose, pose_trace, corr0, cmat, bmat = coeff_frame_core(
        state.pose, p2_0[:3], p2_0[2], vns, swans, phi_meas, active,
        q_chol, wheel_base, dt, sigma_heading, use_heading,
    )
    # Map components get p2_0 * corr0; the pose was tracked exactly.
    x = state.x
    if use_heading:
        corr = p2_0 * corr0
        x = x + torch.cat([torch.zeros_like(corr[:3]), corr[3:]])
    x = torch.cat([pose, x[3:]])
    vmat = p2_0[:, None] * cmat[0][None, :]                 # (D, nb)
    vmat = torch.cat([vmat[:3] + cmat[1:], vmat[3:]])
    return x, pose_trace, vmat, bmat


def coeff_frame_core(pose0, p2_head, p22_0, vns, swans, phi_meas, active,
                     q_chol, wheel_base, dt, sigma_heading, use_heading: bool):
    """The frame compounding in 4-coefficient space.

    Column j of the returned ``cmat`` represents
    ``p2_0 * cmat[0, j] + e0 * cmat[1, j] + e1 * cmat[2, j] + e2 * cmat[3, j]``;
    the frame covariance effect is ``P0 + V bmat V^T`` and the map mean
    correction ``x_map += p2_0 * corr0``.  Returns
    ``(pose, pose_trace (S, 3), corr0, cmat (4, NB), bmat (NB, NB))``.
    """
    s_steps = vns.shape[0]
    dtype, device = pose0.dtype, pose0.device
    r_head = sigma_heading**2
    zero = torch.zeros((), dtype=dtype, device=device)
    e_p2 = torch.eye(4, dtype=dtype, device=device)[0]   # made on the device: no host copy

    def val2(c):
        """Index-2 component of the represented vector."""
        return c[0] * p22_0 + c[3]

    def head3(c):
        """First three components of the represented vector."""
        return p2_head * c[0] + c[1:4]

    pose = pose0
    gamma = e_p2                      # col2 = P e2 tracking
    a_list, f_list, b3_list, w_list, v_list, pose_trace = [], [], [], [], [], []
    for k in range(s_steps):
        act = active[k]
        vn = vns[k]
        swan = swans[k]

        # --- predict: G = I + u e2^T with u = (Gv[0, 2], Gv[1, 2], 0) ---
        gv, gu = motion.jacobians(pose, vn, swan, wheel_base, dt)
        u_c = torch.where(act, torch.stack([zero, gv[0, 2], gv[1, 2], zero]), 0.0)
        b3 = torch.where(act, gu @ q_chol, 0.0)                  # (3, 2)
        f_c = torch.cat([torch.zeros_like(b3[:1]), b3])          # (4, 2)
        # col2 <- G col2 + (F F^T) e2 = col2 + u col2[2] + F F[2, :]^T.
        gamma = gamma + u_c * val2(gamma) + f_c @ b3[2, :]
        pose = torch.where(act, motion.step(pose, vn, swan, wheel_base, dt), pose)

        # --- heading observation ---
        if use_heading:
            c2 = val2(gamma)
            s_k = c2 + r_head
            w_c = torch.where(act, gamma / s_k, 0.0)
            v = torch.where(act, wrap_angle(phi_meas[k] - pose[2]), 0.0)
            w2 = c2 / s_k
            gamma = torch.where(
                act, (1.0 - w2) * (gamma - w_c * c2) + r_head * w2 * w_c, gamma
            )
            pose = pose + head3(w_c) * v
            pose = torch.cat([pose[:2], wrap_angle(pose[2:3])])
            a_c = u_c - w_c
        else:
            w_c = torch.zeros_like(gamma)
            v = zero
            a_c = u_c
        a_list.append(a_c)
        f_list.append(f_c)
        b3_list.append(b3)
        w_list.append(w_c)
        v_list.append(v)
        pose_trace.append(pose)

    def compose(b, a):
        """(I + a e2^T)(I + b e2^T) -> coefficient a(1 + b_2) + b."""
        return a * (1.0 + val2(b)) + b

    # Suffix composition: t_k = transform after sub-step k; m = whole frame.
    t = [None] * s_steps
    acc = torch.zeros_like(gamma)
    for k in range(s_steps - 1, -1, -1):
        t[k] = acc
        acc = compose(a_list[k], acc)
    m_c = acc

    w_prime = [w_list[k] + t[k] * val2(w_list[k]) for k in range(s_steps)]
    f_prime = []
    for k in range(s_steps):
        c_k = compose(-w_list[k], t[k]) if use_heading else t[k]
        f_prime.append(f_list[k] + torch.outer(c_k, b3_list[k][2, :]))

    if use_heading:
        corr0 = sum(v_list[k] * w_list[k][0] for k in range(s_steps))
    else:
        corr0 = zero

    # Coefficient columns [m, p2] + S F-pairs [+ S w vectors].
    c_cols = [m_c, e_p2]
    c_cols += [f_prime[k][:, i] for k in range(s_steps) for i in (0, 1)]
    if use_heading:
        c_cols += w_prime
    cmat = torch.stack(c_cols, dim=1)                   # (4, 2 + 2S [+ S])
    nb = cmat.shape[1]
    diag = torch.zeros((nb,), dtype=dtype, device=device)
    diag[2 : 2 + 2 * s_steps] = 1.0
    if use_heading:
        diag[2 + 2 * s_steps :] = r_head
    bmat = torch.diag(diag)
    bmat[0, 0] = p22_0
    # Ones from the device: a Python number written at an index is a copy
    # from the host, which a CUDA graph cannot capture.
    one = torch.ones((), dtype=dtype, device=device)
    bmat[0, 1] = one
    bmat[1, 0] = one
    return pose, torch.stack(pose_trace), corr0, cmat, bmat
