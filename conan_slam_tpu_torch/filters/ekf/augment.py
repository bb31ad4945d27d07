"""State augmentation: founding new map features (port of
conan_slam_tpu.filters.ekf.augment; reference EKF::augment /
addOneNewFeature, EKF.cpp:9-91).

One batched masked block write into the pre-allocated state.  For new
measurement i, taking slot s_i = n_active + rank_i:

    xf_i              = inverse sensor model               (EKF.cpp:47-48)
    P[s_i, s_i]       = Gv_i Pvv Gv_i^T + Gz_i R Gz_i^T   (EKF.cpp:74)
    P[s_i, pose]      = Gv_i Pvv                           (EKF.cpp:77)
    P[s_i, old map]   = Gv_i Pvm                           (EKF.cpp:83)
    P[s_i, s_j], j<i  = Gv_i Pvv Gv_j^T

which equals the reference's sequential augmentation, because
addOneNewFeature never modifies the pose block it linearises around.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.filters.common import CompactObs
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.models import sensor


def augment(state: EKFState, obs: CompactObs, new_mask, r_cov) -> EKFState:
    """Found a new feature for every masked measurement and record it in
    the id table; measurements beyond the remaining capacity are dropped
    (the map is full).

    P is written IN PLACE and the returned state holds the same tensor
    (a copy would add a D^2 read and write per frame, as much traffic as
    the frame's whole P pass); pass a P you own, as the frame loop does
    with the update's fresh output.  The mean and the table are new.

    It never waits on the device, so it runs every frame (a frame with no
    new measurement rewrites rows with their own values).  The reference
    scatters with ``mode="drop"``, which PyTorch does not have: an index
    past D raises, and duplicate indices with different values write in
    no defined order.  So the write is built from the fact that the new
    slots are the contiguous block [n_active, n_active + n_new), capped at
    K: a window of W = min(2 NZ, 2K) rows that always holds that block and
    never leaves the slot rows [3, 3 + 2K) starts at
    3 + min(2 n_active, 2K - W).  Its rows, its columns and its corner are
    written with unique, in-range indices; each window row that is no new
    slot's keeps its old value.
    """
    nz = obs.z.shape[0]
    k = state.capacity
    dev = state.x.device
    # Slot assignment in buffer order (ascending landmark id, the
    # reference's sequential discovery order, EKF.cpp:213-226).
    rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    ok = new_mask & (state.n_active + rank < k)
    n_new = ok.sum()
    # by_rank[r] = the measurement of rank r among the accepted ones.
    by_rank = torch.argsort((~ok).to(torch.int8), stable=True)

    w = min(2 * nz, 2 * k)
    start = 3 + torch.clamp(2 * state.n_active, max=2 * k - w)
    win = start + torch.arange(w, device=dev)                  # (W,) rows
    r_of = (win - 3) // 2 - state.n_active                     # rank of each row's slot
    is_new = (r_of >= 0) & (r_of < n_new)
    src = 2 * by_rank[r_of.clamp(0, nz - 1)] + (win - 3) % 2   # (W,) source row in [0, 2 NZ)

    xf, gv, gz = sensor.init_feature(state.pose, obs.z)        # (NZ,2) (NZ,2,3) (NZ,2,2)
    x = state.x.clone()
    x[win] = torch.where(is_new, xf.reshape(-1)[src], state.x[win])

    # Rows Gv_i P[0:3, :] cover the pose and the existing map.
    p = state.p
    gv2 = gv.reshape(2 * nz, 3)
    strips = (gv2 @ p[:3])[src]                                # (W, D)
    pvv = p[:3, :3]
    cross = (gv2 @ pvv @ gv2.T).view(nz, 2, nz, 2)
    meas = torch.arange(nz, device=dev)
    cross[meas, :, meas, :] += gz @ r_cov @ gz.transpose(-1, -2)
    corner = cross.view(2 * nz, 2 * nz)[src[:, None], src[None, :]]   # (W, W)

    p[win] = torch.where(is_new[:, None], strips, p[win])
    p[:, win] = torch.where(is_new[None, :], strips.T, p[:, win])
    both = is_new[:, None] & is_new[None, :]
    p[win[:, None], win[None, :]] = torch.where(both, corner, p[win[:, None], win[None, :]])

    # Id table: accepted ids take their slots; the rest write a spare entry.
    n_ids = state.table.shape[0]
    table = torch.cat([state.table, state.table.new_full((1,), -1)])
    table[torch.where(ok, obs.ids.to(torch.int64), n_ids)] = state.n_active + rank
    return EKFState(x=x, p=p, n_active=state.n_active + n_new, table=table[:n_ids])
