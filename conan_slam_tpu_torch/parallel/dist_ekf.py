"""Distributed EKF-SLAM: the joint covariance in row blocks over the ranks
(port of conan_slam_tpu.parallel.dist_ekf).

Layout, as the reference's: the padded joint state (Dp = 3 + 2K rounded up
to the shard grain) is split in contiguous row blocks over the ``state``
mesh axis; each rank holds ``x`` rows [i chunk, (i + 1) chunk) and the
same rows of ``P`` (all Dp columns).  Measurement operators (m x Dp, m
small) are replicated.

Each of the reference's ``shard_map`` kernels is a per-rank function here:
it takes the mesh and this rank's blocks and returns this rank's blocks,
its collectives explicit calls on the axis (parallel.mesh), with the
reference's names, arguments and algebra.  The measurement update is the
reference's communication pattern: local P H^T strips, one psum of the
(m, m) partial S, a replicated small Cholesky, and one all-gather of the
(m, Dp) whitened-gain strip for the local downdates: O(m Dp) bytes on the
wire per update against O(Dp^2) resident per rank.

Each rank's branch on its own coordinate (``i == 0``) is a Python branch
on the host: a rank knows its coordinate, as a ``shard_map`` body knows
``axis_index``.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.core.linalg import safe_cholesky, sym
from conan_slam_tpu_torch.models import motion, sensor
from conan_slam_tpu_torch.parallel.mesh import STATE_AXIS, pad_to_multiple


def padded_dim(d: int, n_shards: int, grain: int = 8) -> int:
    """State dim padded so each shard's row block is a multiple of ``grain``."""
    return pad_to_multiple(d, n_shards * grain)


def row_block(mesh, dp: int, axis: str = STATE_AXIS) -> slice:
    """This rank's rows of a (Dp, ...) array."""
    ax = mesh.axis(axis)
    chunk = dp // ax.size
    return slice(ax.index * chunk, (ax.index + 1) * chunk)


def shard_state(mesh, x, p, axis: str = STATE_AXIS):
    """Pad (x, P) to the shard grain and return this rank's row blocks
    ``(x_l (chunk,), p_l (chunk, Dp))`` on the mesh's device.  ``p`` may
    be a callable ``p(rows)`` giving P's rows [rows] (Dp columns), so that
    no rank holds all of P."""
    n = mesh.axis(axis).size
    d = x.shape[0]
    dp = padded_dim(d, n)
    rows = row_block(mesh, dp, axis)
    x_pad = torch.zeros((dp,), dtype=x.dtype, device=mesh.device)
    x_pad[:d] = x
    lo, hi = rows.start, min(rows.stop, d)
    p_l = torch.zeros((rows.stop - rows.start, dp), dtype=x.dtype, device=mesh.device)
    if lo < hi:
        p_l[: hi - lo, :d] = p(slice(lo, hi)) if callable(p) else p[lo:hi]
    return x_pad[rows].clone(), p_l


def _pose_from_shards(x_l, ax):
    """Broadcast the pose (rows 0:3, resident on shard 0) to all shards."""
    local_pose = x_l[:3] if ax.index == 0 else torch.zeros_like(x_l[:3])
    return ax.psum(local_pose)


def sharded_cholesky_update(mesh, x, p, v, r, h, axis: str = STATE_AXIS):
    """Cholesky-form KF update on a row-sharded covariance (this rank's
    blocks ``x`` (chunk,), ``p`` (chunk, Dp); ``h`` (m, Dp) replicated).

    Algebra identical to ops.cholesky_update (reference slam.h:235-266);
    collectives: one psum of the (m, m) partial S, one tiled all-gather of
    the (m, Dp) whitened-gain strip.
    """
    ax = mesh.axis(axis)
    chunk = x.shape[0]
    i = ax.index
    pht_l = p @ h.T                                         # (chunk, m)
    h_l = h[:, i * chunk:(i + 1) * chunk]
    s_part = h_l @ pht_l                                    # (m, m)
    s = sym(ax.psum(s_part) + r)
    chol = safe_cholesky(s)
    # Small explicit L^-1 + dense product; replicated, no extra collective.
    eye_m = torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
    linv = torch.linalg.solve_triangular(chol, eye_m, upper=False)
    w1t_l = linv @ pht_l.T
    lv = linv @ v
    x_new = x + w1t_l.T @ lv
    w1t_full = ax.all_gather(w1t_l, dim=1)                  # (m, Dp)
    p_new = p - w1t_l.T @ w1t_full
    return x_new, p_new


def sharded_predict(mesh, x, p, v_ctrl, swa, q_cov, wheel_base, dt, axis: str = STATE_AXIS):
    """Structured motion prediction on the sharded covariance.

    Row strip (pose rows, shard 0 only) and column strip (all shards) are
    updated locally; the only collective is the 3-element pose broadcast.
    Mirrors filters.ekf.predict (reference EKF.cpp:406-455).
    """
    ax = mesh.axis(axis)
    pose = _pose_from_shards(x, ax)
    v_ctrl, swa = (torch.as_tensor(c, dtype=x.dtype, device=x.device) for c in (v_ctrl, swa))
    gv, gu = motion.jacobians(pose, v_ctrl, swa, wheel_base, dt)
    p = p.clone()
    if ax.index == 0:
        # Row strip: [Pvv | Pvm] <- Gv [Pvv | Pvm]   (shard 0 only).
        p[:3, :] = gv @ p[:3, :]
    # Column strip on every shard: cols 0:3 <- cols @ Gv^T.
    p[:, :3] = p[:, :3] @ gv.T
    x = x.clone()
    if ax.index == 0:
        # Process noise into the pose block, the pose moved (shard 0).
        p[:3, :3] += (gu @ q_cov) @ gu.T
        x[:3] = motion.step(pose, v_ctrl, swa, wheel_base, dt)
    return x, p


def sharded_observation_update(mesh, x, p, z, slots, mask, r_cov, capacity: int,
                               axis: str = STATE_AXIS):
    """Full batched measurement update against the sharded state.

    The (2m, Dp) operator is assembled replicated from the gathered O(Dp)
    mean (the all-gather XLA places in the reference); the O(Dp^2)
    covariance never leaves its shards.  Then the Schur-style sharded
    Cholesky update.  Mirrors filters.ekf.update.batch_update (reference
    EKF.cpp:93-129).
    """
    from conan_slam_tpu_torch.filters.ekf.observe import assemble_operator

    x_full = mesh.axis(axis).all_gather(x)
    dp = x_full.shape[0]
    features = x_full[3:3 + 2 * capacity].reshape(capacity, 2)
    v, h, rr = assemble_operator(x_full[:3], features, z, slots, mask, r_cov, dp)
    return sharded_cholesky_update(mesh, x, p, v, rr, h, axis)


def _window_rows(start, w: int, lo: int, n_rows: int, device):
    """The rows [a, a + min(w, n_rows)) of a block of ``n_rows`` rows
    starting at global row ``lo`` that hold every row the global window
    [start, start + w) has in the block; unique and in range."""
    wl = min(w, n_rows)
    a = torch.clamp(start - lo, 0, n_rows - wl)
    return a + torch.arange(wl, device=device)


def sharded_augment(mesh, x, p, z, ids, new_mask, r_cov, n_active, table,
                    axis: str = STATE_AXIS):
    """Masked new-feature founding on the sharded state.

    Mirrors filters.ekf.augment (reference EKF.cpp:9-91) as the reference's
    sharded kernel does: one broadcast of the pose and the (3, Dp)
    pose-row strip from shard 0 (one psum, as XLA combines the reference's
    two); every write is local, each shard writing the new rows it owns
    and every shard the new columns.  The slot capacity is the padded
    state's, (Dp - 3) // 2, as the reference's.

    The reference scatters with ``mode="drop"``; here, without waiting on
    the device, the new slots are the contiguous block [n_active,
    n_active + n_new), so their rows lie in a window of W = 2 NZ rows
    (``filters.ekf.augment``'s): each rank writes the window's columns and
    the window's rows in its block, each entry that is no new slot's
    keeping its value.

    Returns (x, p, n_active, table).
    """
    return _augment(mesh, x, p, z, ids, new_mask, r_cov, n_active, table, axis)[:4]


def _augment(mesh, x, p, z, ids, new_mask, r_cov, n_active, table, axis: str):
    """``sharded_augment``, also returning the pose it broadcast (the
    state's pose, which founding leaves as it is)."""
    ax = mesh.axis(axis)
    chunk = x.shape[0]
    dp = chunk * ax.size
    lo = ax.index * chunk
    nz = z.shape[0]
    num_ids = table.shape[0]
    dev = x.device

    # Slot assignment (replicated bookkeeping, identical on all shards).
    rank = torch.cumsum(new_mask.to(torch.int64), 0) - 1
    slots = n_active + rank
    cap = (dp - 3) // 2
    ok = new_mask & (slots < cap)
    n_new = ok.sum()
    by_rank = torch.argsort((~ok).to(torch.int8), stable=True)

    # The pose and the pose-row strip of P, broadcast from their owner
    # (shard 0) in one psum.
    own = torch.cat([x[:3], p[:3, :].reshape(-1)])
    both = ax.psum(own if ax.index == 0 else torch.zeros_like(own))
    pose, strip = both[:3], both[3:].view(3, dp)                # (3,), (3, Dp)
    xf, gv, gz = sensor.init_feature(pose, z)     # (NZ,2) (NZ,2,3) (NZ,2,2)
    gv2 = gv.reshape(2 * nz, 3)
    new_rows = gv2 @ strip                                   # (2 NZ, Dp)
    pvv = strip[:, :3]
    cross = (gv2 @ pvv @ gv2.T).view(nz, 2, nz, 2)
    meas = torch.arange(nz, device=dev)
    cross[meas, :, meas, :] += gz @ r_cov @ gz.transpose(-1, -2)
    cross = cross.reshape(2 * nz, 2 * nz)

    w = min(2 * nz, 2 * cap)
    start = 3 + torch.clamp(2 * n_active, max=2 * cap - w)

    def slot_rows(rows):
        """Which global ``rows`` are new slots' rows, and their source rows
        in [0, 2 NZ)."""
        r_of = (rows - 3) // 2 - n_active
        is_new = (rows >= 3) & (r_of >= 0) & (r_of < n_new)
        src = 2 * by_rank[r_of.clamp(0, nz - 1)] + (rows - 3) % 2
        return is_new, src

    win = start + torch.arange(w, device=dev)                # global columns, every shard
    new_c, src_c = slot_rows(win)
    lwin = _window_rows(start, w, lo, chunk, dev)            # local rows, this shard
    new_r, src_r = slot_rows(lo + lwin)

    p = p.clone()
    # Rows (strip part): new feature rows across all columns.
    p[lwin] = torch.where(new_r[:, None], new_rows[src_r], p[lwin])
    # Columns on every shard.
    p[:, win] = torch.where(new_c[None, :], new_rows[src_c][:, lo:lo + chunk].T, p[:, win])
    # New-new cross blocks overwrite the intersections (row-owner shards).
    both = new_r[:, None] & new_c[None, :]
    p[lwin[:, None], win[None, :]] = torch.where(both, cross[src_r[:, None], src_c[None, :]],
                                                 p[lwin[:, None], win[None, :]])
    # Mean scatter (owner shards).
    x = x.clone()
    x[lwin] = torch.where(new_r, xf.reshape(-1)[src_r], x[lwin])

    table_new = torch.cat([table, table.new_full((1,), -1)])
    table_new[torch.where(ok, ids.to(torch.int64), num_ids)] = slots.to(table.dtype)
    return x, p, n_active + n_new, table_new[:num_ids], pose


def sharded_observe_heading(mesh, x, p, phi_meas, sigma_heading, axis: str = STATE_AXIS):
    """Rank-1 Joseph heading update on the sharded covariance
    (mirrors ops.joseph_update_scalar; reference EKF.cpp:328-352).

    Collectives: pose broadcast + one Dp-length all-gather of the P[:, 2]
    column strip.
    """
    ax = mesh.axis(axis)
    i = ax.index
    r = sigma_heading**2
    pose = _pose_from_shards(x, ax)
    v = wrap_angle(phi_meas - pose[2])
    pc_l = p[:, 2]                                     # local rows of P[:, 2]
    pc = ax.all_gather(pc_l)                           # (Dp,)
    s = pc[2] + r
    w = pc / s
    chunk = x.shape[0]
    w_l = w[i * chunk:(i + 1) * chunk]
    x_new = x + w_l * v
    if i == 0:
        x_new = torch.cat([x_new[:2], wrap_angle(x_new[2:3]), x_new[3:]])
    p_new = p - torch.outer(w_l, pc) - torch.outer(pc_l, w) + s * torch.outer(w_l, w)
    return x_new, p_new
