"""Distributed rank-compounded frame: the fastframe design on a sharded P
(port of conan_slam_tpu.parallel.dist_fastframe).

The frame compounding (filters.ekf.fastframe.coeff_frame_core) reads only
O(1) frame-start state, the pose and the first three entries of the
column P e2, and emits the whole frame's covariance effect as coefficient
columns against P e2.  On a row-sharded P every rank therefore builds its
local slice of the frame factor strip from its resident rows, and the
whole frame (S sub-steps, observe, the batched Schur-style measurement
update) is one per-rank function with exactly three collective rounds:

  1. one tiled all-gather of the stacked (2, Dp) [x, P e2] strip;
  2. one psum of the (3 + 2NZ, 2NZ) measurement-row strip of P'H^T;
  3. one tiled all-gather of the (2NZ, Dp) gain strip for the local
     downdates, the only O(Dp) collective of the frame.

S^-1 is ``ops.spd_inverse``: kernel H1 (``csrc/sweep_inverse.cu``) for
CUDA tensors, once a rank a frame; the plain Cholesky route for CPU
tensors, as the reference takes its Cholesky route off the TPU.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import chol2, sym
from conan_slam_tpu_torch.filters.ekf.fastframe import coeff_frame_core
from conan_slam_tpu_torch.models import sensor
from conan_slam_tpu_torch.ops.spd_inverse import spd_inverse
from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS


def sharded_frame_update(
    mesh,
    x,              # (chunk,) this rank's rows of the padded mean
    p,              # (chunk, Dp) this rank's row block of the padded covariance
    vns, swans, phis, actives,   # (S,) per-sub-step controls (replicated)
    q_cov,          # (2, 2) filter control noise
    z,              # (NZ, 2) measurement buffer (replicated)
    slots,          # (NZ,) map slots (replicated, clipped to capacity)
    mask,           # (NZ,) bool associated-and-live
    r_cov,          # (2, 2) filter observation noise
    wheel_base, dt, sigma_heading,
    use_heading: bool,
    axis: str = STATE_AXIS,
    gain_wire: str = "f32",
):
    """One whole observation frame on the sharded joint state.

    Semantically identical to filters.ekf.update.fused_frame_step (S
    predict + heading sub-steps compounded into a rank-(2 + 3S) factor,
    folded into the batched Cholesky-form measurement update; reference
    hot loop test/main.cpp:132-200) against the unsharded state.

    ``gain_wire`` selects the wire format of the (m, Dp) gain all-gather:
      "f32" (default): exact.
      "i16": per-row-scaled int16, half the dominant wire term.  The strip
          is quantised against a global row max (pmax) and both sides of
          the downdate use the DECODED values, so the downdate stays a
          symmetric Gram product.  The mean correction keeps the exact
          local strip: the mean and the downdate use different strips, as
          the reference's (its fault R3, mirrored).

    Returns ``(x, p, nis, pose_trace)``: this rank's blocks, ``nis`` the
    frame NIS per associated measurement and ``pose_trace`` the (S, 3)
    per-sub-step pose means (both replicated: the same bits on every rank).
    """
    ax = mesh.axis(axis)
    chunk = x.shape[0]
    dp = chunk * ax.size
    nz = z.shape[0]
    m = 2 * nz
    dtype, dev = p.dtype, p.device
    i = ax.index
    row_ids = i * chunk + torch.arange(chunk, device=dev)

    q_chol = chol2(q_cov)
    rows2 = (3 + 2 * slots[:, None] + torch.arange(2, device=dev)[None, :]).reshape(-1)
    rows131 = torch.cat([torch.arange(3, dtype=rows2.dtype, device=dev), rows2])

    # --- collective 1: the frame inputs.  x (for pose + feature
    # positions) and the tracked column P e2, stacked into one gather. ---
    p2_l = p[:, 2]
    xp2 = ax.all_gather(torch.stack([x, p2_l]), dim=1)     # (2, Dp)
    x0_full, p2_full = xp2[0], xp2[1]

    # --- frame compounding: O(S) scalar work, replicated ---
    pose, pose_trace, corr0, cmat, bmat = coeff_frame_core(
        x0_full[:3], p2_full[:3], p2_full[2], vns, swans, phis, actives,
        q_chol, wheel_base, dt, sigma_heading, use_heading,
    )

    # Post-frame mean, replicated view (for the measurement operator).
    xq_full = x0_full + torch.where(torch.arange(dp, device=dev) >= 3, p2_full * corr0, 0.0)
    xq_full = torch.cat([pose, xq_full[3:]])
    xf = xq_full[rows2].reshape(nz, 2)

    # --- observation model at the post-frame mean (replicated) ---
    zp, hv, hf = sensor.observe(pose, xf)
    hv = torch.where(mask[:, None, None], hv, 0.0)          # (NZ, 2, 3)
    hf = torch.where(mask[:, None, None], hf, 0.0)          # (NZ, 2, 2)
    dz = z - zp
    v = torch.stack([dz[:, 0], wrap_angle(dz[:, 1])], dim=-1)
    v = torch.where(mask[:, None], v, 0.0).reshape(m)
    hv2 = hv.reshape(m, 3)

    # --- local slice of the frame factor strip V (chunk, NB) ---
    vloc = p2_l[:, None] * cmat[0][None, :]
    for rr in range(3):
        vloc = vloc + torch.where((row_ids == rr)[:, None], cmat[1 + rr][None, :], 0.0)

    # H V (m, NB): H p2 via the sparse pose/slot columns, plus the e-basis
    # rows (H's pose block against cmat's e-coefficients).
    hp2 = hv2 @ p2_full[:3] + torch.einsum("nab,nb->na", hf,
                                           p2_full[rows2].reshape(nz, 2)).reshape(m)
    hvm = hp2[:, None] * cmat[0][None, :] + hv2 @ cmat[1:4]            # (m, NB)

    # --- P' H^T local row strip: P H^T (sparse H) + V B (H V)^T ---
    pcols = p[:, rows2].reshape(chunk, nz, 2)
    pht_l = (p[:, :3] @ hv2.T
             + torch.einsum("cnk,nmk->cnm", pcols, hf).reshape(chunk, m)
             + vloc @ (bmat @ hvm.T))                                    # (chunk, m)

    # --- collective 2: measurement rows of P'H^T (pose + slot rows) ---
    local131 = rows131 - i * chunk
    inshard = (local131 >= 0) & (local131 < chunk)
    strip_part = torch.where(inshard[:, None], pht_l[torch.clamp(local131, 0, chunk - 1)], 0.0)
    strip = ax.psum(strip_part)                                         # (3 + m, m)

    # S = H P'H^T + R from the replicated strip.
    s = hv2 @ strip[:3]
    strip_slots = strip[3:].reshape(nz, 2, m)
    s = s + torch.einsum("nab,nbm->nam", hf, strip_slots).reshape(m, m)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    rblocks = torch.where(mask[:, None, None], r_cov, eye2)
    idx = torch.arange(nz, device=dev)
    s = s.reshape(nz, 2, nz, 2)
    s[idx, :, idx, :] += rblocks
    s = sym(s.reshape(m, m))

    si = spd_inverse(s)                                                 # (m, m): H1 on the card
    siv = si @ v
    nis = torch.dot(v, siv) / torch.clamp(mask.to(dtype).sum(), min=1.0)

    # --- mean: post-frame local mean + measurement correction ---
    xq_l = x + torch.where(row_ids >= 3, p2_l * corr0, 0.0)
    xq_l = torch.where(row_ids < 3, pose[torch.clamp(row_ids, 0, 2)], xq_l)
    x_new = xq_l + pht_l @ siv
    x_new = torch.where(row_ids == 2, wrap_angle(x_new), x_new)

    # --- collective 3: the P'H^T strip; then ONE local pass over the
    # resident covariance block: down = pht^T S^-1 pht with BOTH sides
    # taken from the (possibly decoded) gathered strip ---
    if gain_wire == "i16":
        amax = ax.pmax(pht_l.abs().amax(0))                             # (m,) global
        scale = torch.clamp(amax, min=1e-30) * (1.0 / 32767.0)
        q_l = torch.round(pht_l.T / scale[:, None]).to(torch.int16)
        q_full = ax.all_gather(q_l, dim=1)
        pht_full = q_full.to(dtype) * scale[:, None]
        pht_down_l = (q_l.to(dtype) * scale[:, None]).T
    elif gain_wire == "f32":
        pht_full = ax.all_gather(pht_l.T.contiguous(), dim=1)            # (m, Dp)
        pht_down_l = pht_l
    else:
        raise ValueError(f"gain_wire must be 'f32' or 'i16', got {gain_wire!r}")
    vtf_full = cmat[0][:, None] * p2_full[None, :]                      # (NB, Dp)
    vtf_full = torch.cat([vtf_full[:, :3] + cmat[1:4].T, vtf_full[:, 3:]], dim=1)
    p_new = p + vloc @ (bmat @ vtf_full) - (pht_down_l @ si) @ pht_full
    return x_new, p_new, nis, pose_trace
