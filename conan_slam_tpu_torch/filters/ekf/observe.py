"""EKF observation-side helpers: the batched measurement operator and the
heading observation (port of conan_slam_tpu.filters.ekf.observe;
reference EKF::observeModel, EKF.cpp:354-404, and EKF::observeHeading,
EKF.cpp:328-352)."""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import sensor
from conan_slam_tpu_torch.ops.cholesky_update import joseph_update_scalar


def assemble_operator(pose, features, z, slots, mask, r_cov, d: int):
    """Stacked (masked) innovation, Jacobian and noise of a batch update.

    ``pose`` (3,) linearisation point, ``features`` (K, 2) slot positions,
    ``z`` (NZ, 2) measurements, ``slots`` (NZ,) their map slots, ``mask``
    (NZ,) which take part, ``d`` the (padded) state dimension.  Returns
    ``v`` (2 NZ,) zero on masked rows, ``h`` (2 NZ, d) zero on masked rows
    and ``rr`` (2 NZ, 2 NZ) block-diagonal, identity on masked rows
    (reference EKF.cpp:104-121).
    """
    nz = z.shape[0]
    cap = features.shape[0]
    safe = torch.clamp(slots, 0, cap - 1)
    zp, hv, hf = sensor.observe(pose, features[safe])       # (NZ,2) (NZ,2,3) (NZ,2,2)

    dz = z - zp
    v = torch.stack([dz[:, 0], wrap_angle(dz[:, 1])], dim=-1)
    v = torch.where(mask[:, None], v, 0.0).reshape(2 * nz)

    h_rows = torch.zeros((nz, 2, d), dtype=z.dtype, device=z.device)
    h_rows[:, :, :3] = hv
    cols = 3 + 2 * safe[:, None] + torch.arange(2, device=z.device)   # (NZ, 2)
    h_rows.scatter_(2, cols[:, None, :].expand(nz, 2, 2), hf)
    h = torch.where(mask[:, None, None], h_rows, 0.0).reshape(2 * nz, d)

    eye2 = torch.eye(2, dtype=z.dtype, device=z.device)
    r_blocks = torch.where(mask[:, None, None], r_cov, eye2)   # (NZ, 2, 2)
    return v, h, _block_diag2(r_blocks)


def build_batch_operator(state: EKFState, obs: CompactObs, slots, mask, r_cov):
    """``assemble_operator`` at the state's pose and map."""
    return assemble_operator(state.pose, state.features, obs.z, slots, mask, r_cov,
                             state.x.shape[0])


def _block_diag2(blocks):
    """(NZ, 2, 2) -> (2 NZ, 2 NZ) block diagonal."""
    nz = blocks.shape[0]
    out = torch.zeros((nz, 2, nz, 2), dtype=blocks.dtype, device=blocks.device)
    idx = torch.arange(nz, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(2 * nz, 2 * nz)


def observe_heading(state: EKFState, phi_meas, sigma_heading) -> EKFState:
    """The heading pseudo-observation in Joseph form (sigma 0.01 deg,
    reference EKF.cpp:337; every control step where
    ``switch_heading_known``, test/main.cpp:168)."""
    v = wrap_angle(phi_meas - state.x[2])
    x, p = joseph_update_scalar(state.x, state.p, v, sigma_heading**2, idx=2)
    return state._replace(x=wrap_heading(x), p=p)


def wrap_heading(x):
    """The state mean ``x`` with its heading x[2] wrapped to [-pi, pi)."""
    return torch.cat([x[:2], wrap_angle(x[2:3]), x[3:]])
