"""The whole observation frame on the split schedule (port of
conan_slam_tpu.ops.frame_kernel.frame_step, frame_update_obs and their
references).

The reference runs the frame on the TPU as one resident kernel whose
(D, MP) strip lives in 15 MiB of VMEM.  A Hopper block has 227 KB of shared
memory, so the port takes the reference's big-D schedule instead
(``_frame_step_big``: a chain kernel, then one O(D^2) rank pass), proven
equal to the resident one by the reference's own tests:

  H2 ``frame_chain`` (one block a band of measurement rows,
      ``frame_chain_plan``): the S-step coefficient recursion, K4, the
      range-bearing observe and compact Hc, S = Hc P'[rows] Hc^T + R.
      Every block reruns the recursion and the observe and forms its
      band's rows of psub and S.  It writes the small state the TPU grid
      carried in scratch (``rowc``, ``ms``) to device memory, because
      Hopper blocks run in parallel and in no order.
  H1 ``sweep_si`` (one block): S^-1 by the Jacobi-scaled sweep over the
      valid pivot blocks (ops.spd_inverse).  The reference ran it inside
      the chain kernel; here it is its own launch.
  H3 ``frame_panels`` (one block a 16-column panel of D,
      ``frame_panels_plan``): the gains siv = v^T S^-1 and the NIS,
      pht = Hc P'[rows] and the updated mean.  Clusters of 8 blocks split
      siv and share it through distributed shared memory.
  H4 ``rank_update_t``: P + G^T M G with G = [pht; p2; e0; e1; e2] and
      M = blockdiag(-S^-1, K4) (``_frame_gm``).

where P' = P + U K4 U^T, U = [P e2, e0, e1, e2], is the frame-start
covariance after the S predict + heading sub-steps (the fastframe closed
form).

The frame pair (``frame_step_pair``, the reference's T8) runs H2 -> H1 ->
H3 twice, frame B against strips rebuilt from frame A's (G, M), and one H4
pass at r = 2 (MP + 8) for both frames.

The gated frame (``frame_update_obs``, the reference's ``_fullframe_kernel``)
gets its factors P' = P + vtf^T B vtf from H5 (ops.factor_kernel) and runs

  H7 ``obs_chain`` (one block): observe, compact Hc, v, R, the coupling
      hvb = (Hc vtf[:, rows]^T) B and S = (Hc P[rows][:, rows] + hvb
      vtf[:, rows]) Hc^T + R.
  H1 ``sweep_si``: S^-1, as above.
  H8 ``obs_panels`` (many blocks): pht = Hc P[rows] + hvb vtf, the gains,
      the updated mean and the NIS.
  H4 ``rank_update_t``: P + G^T M G with G = [vtf; pht] and
      M = blockdiag(B, -S^-1).

Each kernel's plain PyTorch version sits beside its wrapper; the
wrapper takes it for CPU tensors only.  ``_frame_step_reference`` is the
independent oracle: the fastframe factors composed with the measurement
chain, as the reference's CPU route.

Layouts shared by H2, H3 and their plain versions (MP = 2 NZ rounded up to
32, RP = 3 + 2 NZ rounded up to 8; row i of Hc belongs to measurement
l = i // 2 and has nonzeros only in the gathered columns 0, 1, 2 (pose)
and 3 + 2l, 4 + 2l (its slot)):

  rowc (MP, 8): [hc pose x, pose y, pose phi, slot x, slot y, hp2, hg, v]
                with hp2 = Hc p2[rows], hg = Hc[:, :3] g, v the innovation.
  ms (32,):     [pose (3), corr0, alpha, g (3), m3 (3x3, row-major), 0...]
                where K4 = [[alpha, g^T], [g, m3]].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops.rank_update import (
    rank_update_t,
    rank_update_t2_reference,
    rank_update_t_reference,
    rank_update_vbt,
    rank_update_vbt_reference,
)
from conan_slam_tpu_torch.ops.spd_inverse import (
    spd_inverse_reference,
    sweep_si,
    sweep_si_reference,
)

MS_LEN = 32
MAX_STEPS = 16     # sub-steps per frame the chain kernel holds

N_SM = 132          # SMs of an H100 SXM, the most blocks H2's bands spread over
PANEL_W = 16        # H3's columns of D a block (csrc/frame_panels.cu)
PANEL_CLUSTER = 8   # H3's blocks that share one siv
PANEL_THREADS = 256
PANEL_LD = 24       # H3's panel row stride in shared memory

FRAME_CHAIN = cuda.CudaKernel(
    "frame_chain", "csl_frame_chain",
    [cuda.P] * 11 + [cuda.I, cuda.I, cuda.I, cuda.I, cuda.F, cuda.F, cuda.F, cuda.I],
    source="conan_slam_tpu_torch/csrc/frame_chain.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:1123 (_chain_dispatch -> pallas_call :1139, grid step 0)",
)
FRAME_PANELS = cuda.CudaKernel(
    "frame_panels", "csl_frame_panels",
    [cuda.P] * 8 + [cuda.I] * 5,
    source="conan_slam_tpu_torch/csrc/frame_panels.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:1123 (_chain_dispatch -> pallas_call :1139, panel steps)",
)


OBS_CHAIN = cuda.CudaKernel(
    "obs_chain", "csl_obs_chain",
    [cuda.P] * 9 + [cuda.I, cuda.I, cuda.I],
    source="conan_slam_tpu_torch/csrc/obs_chain.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:535 (frame_update_obs -> pallas_call :607, grid step 0)",
)
OBS_PANELS = cuda.CudaKernel(
    "obs_panels", "csl_obs_panels",
    [cuda.P] * 9 + [cuda.I, cuda.I, cuda.I, cuda.I],
    source="conan_slam_tpu_torch/csrc/obs_panels.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:535 (frame_update_obs -> pallas_call :607, panels)",
)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def frame_shapes(nz: int) -> tuple[int, int]:
    """(MP, RP): padded measurement rows and gathered rows for NZ slots."""
    return _round_up(2 * nz, 32), _round_up(3 + 2 * nz, 8)


class ChainPlan(NamedTuple):
    """H2's row bands: block b forms rows ``rows(b)`` of psub and S."""

    band: int    # measurement rows a block: whole measurements (even)
    grid: int    # blocks
    mp: int

    def rows(self, block: int) -> range:
        return range(min(self.mp, block * self.band), min(self.mp, (block + 1) * self.band))


def frame_chain_plan(mp: int) -> ChainPlan:
    """H2's bands at MP = ``mp``: one measurement (two rows) a block while
    that takes no more blocks than the card has SMs, else the fewest whole
    measurements a band that does."""
    band = 2 * -(-(mp // 2) // N_SM)
    return ChainPlan(band=band, grid=-(-mp // band), mp=mp)


class PanelPlan(NamedTuple):
    """H3's column panels: block b writes columns ``columns(b)`` of pht and
    xn, and forms siv entries ``siv_entries(b % cluster)`` for its cluster."""

    width: int       # columns of D a block
    panels: int      # blocks that hold columns
    grid: int        # blocks launched: whole clusters
    cluster: int     # blocks that share one siv
    siv_block: int   # siv entries each block of a cluster forms
    mp: int
    d: int

    def columns(self, block: int) -> range:
        return range(min(self.d, block * self.width), min(self.d, (block + 1) * self.width))

    def siv_entries(self, rank: int) -> range:
        return range(min(self.mp, rank * self.siv_block),
                     min(self.mp, (rank + 1) * self.siv_block))


def frame_panels_plan(mp: int, d: int) -> PanelPlan:
    """H3's panels at MP = ``mp``, D = ``d``: 16-column panels, the grid
    rounded up to whole clusters of 8."""
    panels = -(-d // PANEL_W)
    return PanelPlan(width=PANEL_W, panels=panels, grid=_round_up(panels, PANEL_CLUSTER),
                     cluster=PANEL_CLUSTER, siv_block=-(-mp // PANEL_CLUSTER), mp=mp, d=d)


class FrameStep(NamedTuple):
    p: torch.Tensor           # (D, D)  post-frame covariance
    x: torch.Tensor           # (D,)    post-frame state mean (heading wrapped)
    pose_trace: torch.Tensor  # (S, 3)  exact per-sub-step pose means
    nis: torch.Tensor         # ()      stacked NIS


class ChainOut(NamedTuple):
    pt: torch.Tensor     # (S, 3)   pose trace
    k4: torch.Tensor     # (8, 8)   K4 = C B C^T in the leading 4x4
    s: torch.Tensor      # (MP, MP) innovation covariance S
    rowc: torch.Tensor   # (MP, 8)  per-row coefficients (module docstring)
    ms: torch.Tensor     # (32,)    frame scalars (module docstring)


class FrameUpdateObs(NamedTuple):
    p: torch.Tensor      # (D, D)
    x: torch.Tensor      # (D,)
    nis: torch.Tensor    # ()


class MeasurementChain(NamedTuple):
    pht: torch.Tensor     # (MP, D)  P' H^T row strips
    bvt: torch.Tensor     # (NB, D)  B V^T rank-update strip
    nsipht: torch.Tensor  # (MP, D)  -S^-1 pht downdate strip
    siv: torch.Tensor     # (MP,)
    dx: torch.Tensor      # (D,)
    nis: torch.Tensor     # ()


# ---------------------------------------------------------------- packing


def _pack_meas(zr, zb, mask, r_cov, nzl):
    """``zin`` (3, NZL) rows [range, bearing, mask], ``rsc`` (4,) noise
    entries and the sweep bound ``nblk`` (1,) int32 = last valid slot + 1."""
    nz = zr.shape[0]
    mask_f = mask.to(zr.dtype)
    zin = torch.stack([torch.where(mask, zr, 0.0), torch.where(mask, zb, 0.0), mask_f])
    zin = F.pad(zin, (0, nzl - nz))
    rsc = r_cov.to(zr.dtype).reshape(4)
    order = torch.arange(1, nz + 1, dtype=torch.int32, device=zr.device)
    nblk = torch.where(mask, order, 0).max().reshape(1)
    return zin.contiguous(), rsc.contiguous(), nblk


def _pack_subs(vns, swans, phis, actives):
    """``subs`` (4, S) rows [vn, swan, phi_meas, active]."""
    dtype = vns.dtype
    return torch.stack([vns, swans.to(dtype), phis.to(dtype), actives.to(dtype)]).contiguous()


def _pack_ctrl(vns, swans, phis, actives, q_cov):
    """``subs`` (4, S) (``_pack_subs``) and ``qc`` (3,) the closed-form
    Cholesky entries [l00, l10, l11] of the control noise."""
    l00 = torch.sqrt(q_cov[0, 0])
    l10 = q_cov[1, 0] / l00
    l11 = torch.sqrt(torch.clamp(q_cov[1, 1] - l10 * l10, min=0.0))
    return _pack_subs(vns, swans, phis, actives), torch.stack([l00, l10, l11]).to(vns.dtype)


# ------------------------------------------------- H2: the frame chain


def _coeff_k4(subs, qc, p2_head, p22, pose0, wheel_base, dt, sigma_heading,
              use_heading):
    """Coefficient recursion + K4 = C B C^T (the reference kernel's
    ``coeff_recursion`` algebra, on the fastframe port)."""
    # Imported here: filters.ekf imports this module.
    from conan_slam_tpu_torch.filters.ekf.fastframe import coeff_frame_core

    zero = torch.zeros_like(qc[0])
    q_chol = torch.stack([torch.stack([qc[0], zero]), torch.stack([qc[1], qc[2]])])
    pose, pose_trace, corr0, cmat, bmat = coeff_frame_core(
        pose0, p2_head, p22, subs[0], subs[1], subs[2], subs[3] > 0.5,
        q_chol, wheel_base, dt, sigma_heading, use_heading,
    )
    return pose, pose_trace, corr0, cmat @ bmat @ cmat.T


def _observe_reference(xrows, zin, rsc, mp, rp):
    """Range-bearing observe against the gathered mean ``xrows`` (RP,):
    compact Hc (MP, 5), block-diagonal R (identity on masked rows) and the
    stacked innovation v (MP,).  Row i of compact Hc holds the coefficients
    of the gathered columns 0, 1, 2 (pose) and 3 + 2l, 4 + 2l (the slot of
    measurement l = i // 2)."""
    nzl = mp // 2
    xw = F.pad(xrows, (0, max(0, mp + 3 - rp)))
    idx = torch.arange(nzl, device=xrows.device)
    fx, fy = xw[3 + 2 * idx], xw[4 + 2 * idx]
    px, py, phi = xrows[0], xrows[1], xrows[2]
    m = zin[2]
    dxl, dyl = fx - px, fy - py
    d2 = torch.clamp(dxl * dxl + dyl * dyl, min=1e-12)
    dist = torch.sqrt(d2)
    bpred = torch.atan2(dyl, dxl) - phi
    vr = (zin[0] - dist) * m
    vb = wrap_angle(zin[1] - bpred) * m
    v2 = torch.stack([vr, vb], dim=1).reshape(mp)

    xd, yd, xd2, yd2 = dxl / dist * m, dyl / dist * m, dxl / d2 * m, dyl / d2 * m
    zero = torch.zeros_like(m)
    hcc = torch.stack([
        torch.stack([-xd, -yd, zero, xd, yd], -1),
        torch.stack([yd2, -xd2, -m, -yd2, xd2], -1),
    ], dim=1).reshape(mp, 5)

    valid = m > 0
    one = torch.ones_like(m)
    blocks = torch.stack([
        torch.stack([torch.where(valid, rsc[0], one), torch.where(valid, rsc[1], zero)], -1),
        torch.stack([torch.where(valid, rsc[2], zero), torch.where(valid, rsc[3], one)], -1),
    ], dim=-2)                                              # (NZL, 2, 2)
    rmat = torch.block_diag(*blocks)
    return hcc, rmat, v2


def _dense_hc(hcc, rp):
    """Compact Hc (MP, 5) as the dense (MP, RP) operator on the gathered
    rows.  Slot columns past RP belong to empty buffer slots, whose rows are
    zero."""
    mp = hcc.shape[0]
    hc = torch.zeros((mp, max(rp, mp + 3)), dtype=hcc.dtype, device=hcc.device)
    row = torch.arange(mp, device=hcc.device)
    slot = 3 + 2 * (row // 2)
    hc[:, :3] = hcc[:, :3]
    hc[row, slot] = hcc[:, 3]
    hc[row, slot + 1] = hcc[:, 4]
    return hc[:, :rp]


def _frame_chain_reference(subs, qc, zin, rsc, x0rows, prc, mp, wheel_base,
                           dt, sigma_heading, use_heading) -> ChainOut:
    """Plain version of H2: the frame up to S, from no more of P than its
    gathered block ``prc`` = P[rows][:, rows] (RP, RP)."""
    rp = prc.shape[0]
    p2r = prc[2]
    pose, pose_trace, corr0, k4 = _coeff_k4(
        subs, qc, p2r[:3], p2r[2], x0rows[:3], wheel_base, dt, sigma_heading,
        use_heading,
    )
    alpha, g, m3 = k4[0, 0], k4[1:4, 0], k4[1:4, 1:4]

    # Observe against the post-frame mean at the gathered rows.
    xrows = torch.cat([pose, (x0rows + p2r * corr0)[3:]])
    hcc, rmat, v2 = _observe_reference(xrows, zin, rsc, mp, rp)
    hc = _dense_hc(hcc, rp)

    # psub = Hc P'[rows][:, rows] with P' = P + U K4 U^T in factored form.
    wr_row = alpha * p2r + F.pad(g, (0, rp - 3))
    m3r = F.pad(m3, (0, rp - 3))                            # (3, RP)
    hp2 = hc @ p2r
    hcs = hc[:, :3]
    hg = hcs @ g
    psub = hc @ prc + hp2[:, None] * wr_row + hg[:, None] * p2r + hcs @ m3r
    s = psub @ hc.T + rmat

    rowc = torch.cat([hcc, hp2[:, None], hg[:, None], v2[:, None]], 1)
    ms = torch.cat([pose, corr0.reshape(1), alpha.reshape(1), g, m3.reshape(9)])
    return ChainOut(
        pt=pose_trace, k4=F.pad(k4, (0, 4, 0, 4)), s=s,
        rowc=rowc.contiguous(), ms=F.pad(ms, (0, MS_LEN - ms.shape[0])),
    )


def _chain_smem_bytes(mp: int, rp: int, band: int) -> int:
    """Shared memory of one H2 block (csrc/frame_chain.cu frame_chain_smem)."""
    rpa = _round_up(rp, 4)
    return 4 * ((4 + band) * rpa + _round_up(3 * (mp // 2), 4) + 4 + 8 * mp + band * rp)


def frame_chain(subs, qc, zin, rsc, x0rows, prc, mp, wheel_base, dt,
                sigma_heading, use_heading) -> ChainOut:
    """The frame chain up to S: plain version for CPU tensors, kernel H2
    (one block a band of measurement rows, ``frame_chain_plan``) for CUDA
    tensors."""
    if cuda.on_cpu(subs, qc, zin, rsc, x0rows, prc):
        return _frame_chain_reference(
            subs, qc, zin, rsc, x0rows, prc, mp, wheel_base, dt,
            sigma_heading, use_heading,
        )
    s_steps = subs.shape[1]
    rp = prc.shape[0]
    plan = frame_chain_plan(mp)
    if s_steps > MAX_STEPS or _chain_smem_bytes(mp, rp, plan.band) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"frame_chain: S={s_steps}, MP={mp}, RP={rp} exceed one block")
    cuda.check(subs, "subs", (4, s_steps))
    cuda.check(qc, "qc", (3,))
    cuda.check(zin, "zin", (3, mp // 2))
    cuda.check(rsc, "rsc", (4,))
    cuda.check(x0rows, "x0rows", (rp,))
    cuda.check(prc, "prc", (rp, rp))
    dev, f32 = prc.device, torch.float32
    out = ChainOut(
        pt=torch.empty((s_steps, 3), dtype=f32, device=dev),
        k4=torch.empty((8, 8), dtype=f32, device=dev),
        s=torch.empty((mp, mp), dtype=f32, device=dev),
        rowc=torch.empty((mp, 8), dtype=f32, device=dev),
        ms=torch.empty((MS_LEN,), dtype=f32, device=dev),
    )
    FRAME_CHAIN(
        dev, *(cuda.ptr(t) for t in (subs, qc, zin, rsc, x0rows, prc)),
        *(cuda.ptr(t) for t in out),
        s_steps, mp, rp, plan.band, float(wheel_base), float(dt), float(sigma_heading),
        int(bool(use_heading)),
    )
    return out


# ------------------------------------------------- H3: the column panels


def _frame_panels_reference(rowc, ms, si, prows, x):
    """Plain version of H3: pht = Hc P'[rows] (MP, D), the updated mean xn
    (D,) (heading wrapped) and the NIS (1,), from the chain's ``rowc``/``ms``
    and S^-1."""
    rp, d = prows.shape
    hc = _dense_hc(rowc[:, :5], rp)
    pose, corr0, alpha, g, m3 = ms[:3], ms[3], ms[4], ms[5:8], ms[8:17].reshape(3, 3)
    v2 = rowc[:, 7]
    siv = v2 @ si
    nis = (siv * v2).sum().reshape(1)

    p2 = prows[2]
    wrow = alpha * p2 + F.pad(g, (0, d - 3))
    m3d = F.pad(m3, (0, d - 3))                             # (3, D)
    pht = (
        hc @ prows + rowc[:, 5:6] * wrow + rowc[:, 6:7] * p2 + rowc[:, :3] @ m3d
    )
    base = torch.cat([pose, (x + p2 * corr0)[3:]])
    xn = base + siv @ pht
    xn = torch.cat([xn[:2], wrap_angle(xn[2:3]), xn[3:]])
    return pht, xn, nis


def _panels_smem_bytes(mp: int, rp: int) -> int:
    """Shared memory of one H3 block (csrc/frame_panels.cu frame_panels_smem)."""
    return 4 * (8 * mp + 32 + PANEL_LD * rp + PANEL_THREADS + _round_up(mp, 4)
                + -(-mp // PANEL_CLUSTER))


def frame_panels(rowc, ms, si, prows, x):
    """pht, the updated mean and the NIS: plain version for CPU tensors,
    kernel H3 (one block a 16-column panel, ragged edge masked,
    ``frame_panels_plan``) for CUDA tensors."""
    if cuda.on_cpu(rowc, ms, si, prows, x):
        return _frame_panels_reference(rowc, ms, si, prows, x)
    mp = rowc.shape[0]
    rp, d = prows.shape
    plan = frame_panels_plan(mp, d)
    if mp > PANEL_CLUSTER * PANEL_THREADS or _panels_smem_bytes(mp, rp) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"frame_panels: MP={mp}, RP={rp} exceed one block")
    cuda.check(rowc, "rowc", (mp, 8))
    cuda.check(ms, "ms", (MS_LEN,))
    cuda.check(si, "si", (mp, mp))
    cuda.check(prows, "prows", (rp, d))
    cuda.check(x, "x", (d,))
    pht = torch.empty((mp, d), dtype=torch.float32, device=x.device)
    xn = torch.empty((d,), dtype=torch.float32, device=x.device)
    nis = torch.empty((1,), dtype=torch.float32, device=x.device)
    FRAME_PANELS(
        x.device, *(cuda.ptr(t) for t in (rowc, ms, si, prows, x, pht, xn, nis)), mp, rp, d,
        plan.width, plan.grid,
    )
    return pht, xn, nis


# ------------------------------------------------------ the whole frame


def _frame_gm(pht, si, k4, p2row, mp):
    """G = [pht; p2; e0; e1; e2; 0] (MP + 8, D), M = blockdiag(-S^-1, K4):
    G^T M G = U K4 U^T - pht^T S^-1 pht, the frame's whole covariance
    update relative to the frame-start P.  G is a new tensor, never a view
    of P."""
    d = pht.shape[1]
    e3 = torch.eye(3, d, dtype=pht.dtype, device=pht.device)
    z4 = torch.zeros((4, d), dtype=pht.dtype, device=pht.device)
    gmat = torch.cat([pht, p2row, e3, z4], dim=0)
    mmid = torch.zeros((mp + 8, mp + 8), dtype=pht.dtype, device=pht.device)
    mmid[:mp, :mp] = -si
    mmid[mp : mp + 4, mp : mp + 4] = k4
    return gmat, mmid


class FrameInputs(NamedTuple):
    """One frame's packed kernel inputs (``frame_inputs``)."""

    zin: torch.Tensor     # (3, NZL) [range, bearing, mask] rows
    rsc: torch.Tensor     # (4,)     R entries
    nblk: torch.Tensor    # (1,)     int32 sweep bound: last valid slot + 1
    subs: torch.Tensor    # (4, S)   [vn, swan, phi_meas, active] rows
    qc: torch.Tensor      # (3,)     chol(Q) entries [l00, l10, l11]
    prows: torch.Tensor   # (RP, D)  P[rows]
    prc: torch.Tensor     # (RP, RP) P[rows][:, rows]
    x0rows: torch.Tensor  # (RP,)    x[rows]
    mp: int
    rp: int


def frame_inputs(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask,
                 r_cov) -> FrameInputs:
    """Pack a frame for the kernels: the measurement and control buffers
    and three gathers of the frame-start state."""
    mp, rp = frame_shapes(zr.shape[0])
    zin, rsc, nblk = _pack_meas(zr, zb, mask, r_cov, mp // 2)
    subs, qc = _pack_ctrl(vns, swans, phis, actives, q_cov)
    # Pad slots re-read row 0: Hc's columns past 3 + 2 NZ are zero, so
    # their content never matters.
    rows_full = F.pad(rows, (0, rp - rows.shape[0]))
    prows = p[rows_full]
    return FrameInputs(
        zin=zin, rsc=rsc, nblk=nblk, subs=subs, qc=qc, prows=prows,
        prc=prows[:, rows_full].contiguous(), x0rows=x[rows_full], mp=mp, rp=rp,
    )


def frame_step(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask,
               r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
               *, plain: bool = False) -> FrameStep:
    """The whole known-association observation frame: S predict + heading
    sub-steps, range-bearing observe, measurement update and the P pass.

    Args mirror the reference: ``rows`` (3 + 2 NZ,) gathered row indices
    [0, 1, 2, slot rows...]; ``vns``/``swans``/``phis``/``actives`` (S,)
    per-sub-step controls, measured heading and active flags; ``zr``/``zb``/
    ``mask`` (NZ,) the measurement buffer.  ``plain=True`` runs each
    kernel's plain PyTorch version instead, on any device (the baseline the
    kernels are measured against).  Returns ``FrameStep(p, x, pose_trace,
    nis)``; P is not modified in place.
    """
    fi = frame_inputs(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask, r_cov)
    ch, si, pht, xn, nis = _frame_measure(fi, x, (wheel_base, dt, sigma_heading, use_heading),
                                          plain)
    gmat, mmid = _frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp)
    update = rank_update_t_reference if plain else rank_update_t
    p_out = update(p, gmat, mmid)
    return FrameStep(p=p_out, x=xn, pose_trace=ch.pt, nis=nis[0])


def _frame_measure(fi: FrameInputs, x, tail, plain: bool):
    """H2 -> H1 -> H3 of one frame against its gathered strips
    ``fi.prows``/``fi.prc`` and the frame-start mean ``x``: ``(ChainOut,
    S^-1, pht, xn, nis)``.  ``tail`` is (wheel_base, dt, sigma_heading,
    use_heading)."""
    chain_args = (fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp, *tail)
    if plain:
        ch = _frame_chain_reference(*chain_args)
        si = sweep_si_reference(ch.s, fi.nblk)
        return ch, si, *_frame_panels_reference(ch.rowc, ch.ms, si, fi.prows, x)
    ch = frame_chain(*chain_args)
    si = sweep_si(ch.s, fi.nblk)
    return ch, si, *frame_panels(ch.rowc, ch.ms, si, fi.prows, x)


# ------------------------------------------------------- the frame pair


class FramePair(NamedTuple):
    p: torch.Tensor           # (D, D)    covariance after both frames
    x: torch.Tensor           # (D,)      mean after both frames
    pose_trace: torch.Tensor  # (2, S, 3) each frame's exact pose trace
    nis: torch.Tensor         # (2,)      each frame's stacked NIS
    pose_mid: torch.Tensor    # (3,)      frame A's post-update pose


def frame_step_pair(p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b,
                    q_cov, r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
                    *, plain: bool = False) -> FramePair:
    """Two consecutive known-association frames with one P pass (port of
    the reference's ``frame_step_pair``).

    Each frame's chain needs only its gathered rows of P, and frame A's
    whole covariance update is G_A^T M_A G_A (``_frame_gm``), so frame B's
    strips relative to P_A = P + G_A^T M_A G_A come from small data:

        P_A[rows_B] = P[rows_B] + G_A[:, rows_B]^T (M_A G_A)

    Frame A runs H2 -> H1 -> H3 against P, frame B against those strips
    from frame A's updated mean, and one H4 pass applies both updates:
    P + [G_A; G_B]^T [M_A G_A; M_B G_B] at r = 2 (MP + 8).  The algebra is
    that of two ``frame_step`` calls; fp32 rounding differs through the
    rebuilt strips' products.  ``rows_b`` must index the same association
    table as ``rows_a`` (no augmentation between the frames).

    ``ctrl_*`` = (vns, swans, phis, actives), ``meas_*`` = (zr, zb, mask),
    the other arguments as ``frame_step``'s; ``plain=True`` runs the same
    pair algebra through the plain versions.  P is not modified in place.
    """
    tail = (wheel_base, dt, sigma_heading, use_heading)
    fa = frame_inputs(p, x, rows_a, *ctrl_a, q_cov, *meas_a, r_cov)
    ch_a, si_a, pht_a, xn_a, nis_a = _frame_measure(fa, x, tail, plain)
    g_a, m_a = _frame_gm(pht_a, si_a, ch_a.k4[:4, :4], fa.prows[2:3], fa.mp)
    y_a = m_a @ g_a                                          # (MP + 8, D)

    rows_bf = F.pad(rows_b, (0, fa.rp - rows_b.shape[0]))
    prows_b = p[rows_bf] + g_a[:, rows_bf].T @ y_a
    zin_b, _, nblk_b = _pack_meas(*meas_b, r_cov, fa.mp // 2)
    fb = fa._replace(zin=zin_b, nblk=nblk_b, subs=_pack_subs(*ctrl_b), prows=prows_b,
                     prc=prows_b[:, rows_bf].contiguous(), x0rows=xn_a[rows_bf])
    ch_b, si_b, pht_b, xn_b, nis_b = _frame_measure(fb, xn_a, tail, plain)
    g_b, m_b = _frame_gm(pht_b, si_b, ch_b.k4[:4, :4], prows_b[2:3], fa.mp)

    update = rank_update_vbt_reference if plain else rank_update_vbt
    p_out = update(p, torch.cat([g_a, g_b]), torch.cat([y_a, m_b @ g_b]))
    return FramePair(p=p_out, x=xn_b, pose_trace=torch.stack([ch_a.pt, ch_b.pt]),
                     nis=torch.cat([nis_a, nis_b]), pose_mid=xn_a[:3])


# ------------------------------------------ the gated frame: H7 and H8


def _obs_chain_reference(zin, rsc, xrows, prc, vrows, bmat, mp):
    """Plain version of H7: ``(s (MP, MP), rowc (MP, 8), hvb (MP, NBP))``
    from the gathered block ``prc`` = P[rows][:, rows], ``vrows`` =
    vtf[:, rows] and the post-factor mean ``xrows`` = x[rows]."""
    rp = prc.shape[0]
    hcc, rmat, v2 = _observe_reference(xrows, zin, rsc, mp, rp)
    hc = _dense_hc(hcc, rp)
    hvb = (hc @ vrows.T) @ bmat
    psub = hc @ prc + hvb @ vrows
    s = psub @ hc.T + rmat
    rowc = torch.cat([hcc, torch.zeros_like(hcc[:, :2]), v2[:, None]], 1)
    return s, rowc, hvb


def _obs_smem_bytes(mp: int, rp: int, nbp: int) -> int:
    return 4 * (rp * rp + mp * rp + nbp * rp + 2 * mp * nbp + nbp * nbp + 8 * mp + rp)


def obs_chain(zin, rsc, xrows, prc, vrows, bmat, mp):
    """The gated frame's chain up to S: plain version for CPU tensors,
    kernel H7 (one block) for CUDA tensors."""
    if cuda.on_cpu(zin, rsc, xrows, prc, vrows, bmat):
        return _obs_chain_reference(zin, rsc, xrows, prc, vrows, bmat, mp)
    rp = prc.shape[0]
    nbp = bmat.shape[0]
    if _obs_smem_bytes(mp, rp, nbp) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"obs_chain: MP={mp}, RP={rp}, NBP={nbp} exceed one block")
    cuda.check(zin, "zin", (3, mp // 2))
    cuda.check(rsc, "rsc", (4,))
    cuda.check(xrows, "xrows", (rp,))
    cuda.check(prc, "prc", (rp, rp))
    cuda.check(vrows, "vrows", (nbp, rp))
    cuda.check(bmat, "bmat", (nbp, nbp))
    dev, f32 = prc.device, torch.float32
    s = torch.empty((mp, mp), dtype=f32, device=dev)
    rowc = torch.empty((mp, 8), dtype=f32, device=dev)
    hvb = torch.empty((mp, nbp), dtype=f32, device=dev)
    OBS_CHAIN(dev, *(cuda.ptr(t) for t in (zin, rsc, xrows, prc, vrows, bmat, s, rowc, hvb)),
              mp, rp, nbp)
    return s, rowc, hvb


def _obs_panels_reference(rowc, hvb, si, prows, vtf, x):
    """Plain version of H8: pht = Hc P[rows] + hvb vtf (MP, D), the updated
    mean x + siv pht (heading wrapped) and the NIS (1,)."""
    rp = prows.shape[0]
    hc = _dense_hc(rowc[:, :5], rp)
    v2 = rowc[:, 7]
    siv = v2 @ si
    nis = (siv * v2).sum().reshape(1)
    pht = hc @ prows + hvb @ vtf
    xn = x + siv @ pht
    xn = torch.cat([xn[:2], wrap_angle(xn[2:3]), xn[3:]])
    return pht, xn, nis


def obs_panels(rowc, hvb, si, prows, vtf, x):
    """pht, the updated mean and the NIS of the gated frame: plain version
    for CPU tensors, kernel H8 (one block per column panel, ragged edge
    masked) for CUDA tensors."""
    if cuda.on_cpu(rowc, hvb, si, prows, vtf, x):
        return _obs_panels_reference(rowc, hvb, si, prows, vtf, x)
    mp, nbp = hvb.shape
    rp, d = prows.shape
    cuda.check(rowc, "rowc", (mp, 8))
    cuda.check(hvb, "hvb", (mp, nbp))
    cuda.check(si, "si", (mp, mp))
    cuda.check(prows, "prows", (rp, d))
    cuda.check(vtf, "vtf", (nbp, d))
    cuda.check(x, "x", (d,))
    dev, f32 = x.device, torch.float32
    pht = torch.empty((mp, d), dtype=f32, device=dev)
    xn = torch.empty((d,), dtype=f32, device=dev)
    nis = torch.empty((1,), dtype=f32, device=dev)
    OBS_PANELS(dev, *(cuda.ptr(t) for t in (rowc, hvb, si, prows, vtf, x, pht, xn, nis)),
               mp, rp, nbp, d)
    return pht, xn, nis


class ObsInputs(NamedTuple):
    """One gated frame's packed kernel inputs (``obs_inputs``)."""

    zin: torch.Tensor     # (3, NZL) [range, bearing, mask] rows
    rsc: torch.Tensor     # (4,)     R entries
    nblk: torch.Tensor    # (1,)     int32 sweep bound: last valid slot + 1
    prows: torch.Tensor   # (RP, D)  P[rows]
    prc: torch.Tensor     # (RP, RP) P[rows][:, rows]
    xrows: torch.Tensor   # (RP,)    x[rows]
    vrows: torch.Tensor   # (NBP, RP) vtf[:, rows]
    mp: int


def obs_inputs(p, x, rows, zr, zb, mask, r_cov, vtf) -> ObsInputs:
    """Pack a gated frame for the kernels: the measurement buffer and four
    gathers of the state and the factor strip."""
    mp, rp = frame_shapes(zr.shape[0])
    zin, rsc, nblk = _pack_meas(zr, zb, mask, r_cov, mp // 2)
    # Pad slots re-read row 0: Hc's columns past 3 + 2 NZ are zero.
    rows_full = F.pad(rows, (0, rp - rows.shape[0]))
    prows = p[rows_full]
    return ObsInputs(
        zin=zin, rsc=rsc, nblk=nblk, prows=prows, prc=prows[:, rows_full].contiguous(),
        xrows=x[rows_full], vrows=vtf[:, rows_full].contiguous(), mp=mp,
    )


def frame_update_obs(p, x, rows, zr, zb, mask, r_cov, bmat, vtf,
                     *, plain: bool = False) -> FrameUpdateObs:
    """The gated observation frame against the frame factors: observe,
    measurement chain, mean update and the one P pass
    P + vtf^T B vtf - pht^T S^-1 pht.

    Args mirror the reference: ``p`` (D, D) frame-start covariance; ``x``
    (D,) post-factor mean; ``rows`` (3 + 2 NZ,) gathered row indices
    [0, 1, 2, slot rows...]; ``zr``/``zb``/``mask`` (NZ,) the measurement
    buffer; ``bmat`` (NBP, NBP) and ``vtf`` (NBP, D) the factors
    (ops.factor_kernel).  ``plain=True`` runs each kernel's plain PyTorch
    version instead, on any device.  Returns ``FrameUpdateObs(p, x, nis)``
    with the updated mean; P is not modified in place.
    """
    oi = obs_inputs(p, x, rows, zr, zb, mask, r_cov, vtf)
    chain_args = (oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    if plain:
        s, rowc, hvb = _obs_chain_reference(*chain_args)
        si = sweep_si_reference(s, oi.nblk)
        pht, xn, nis = _obs_panels_reference(rowc, hvb, si, oi.prows, vtf, x)
    else:
        s, rowc, hvb = obs_chain(*chain_args)
        si = sweep_si(s, oi.nblk)
        pht, xn, nis = obs_panels(rowc, hvb, si, oi.prows, vtf, x)
    gmat = torch.cat([vtf, pht])
    mmid = torch.block_diag(bmat, -si)
    update = rank_update_t_reference if plain else rank_update_t
    return FrameUpdateObs(p=update(p, gmat, mmid), x=xn, nis=nis[0])


# --------------------------------------------------- independent oracle


def _masked_cols(a, rows):
    """a[..., rows] with zero where rows < 0 (the reference's one-hot
    selector product, as an exact gather)."""
    return torch.where(rows >= 0, a[..., rows.clamp(min=0)], 0.0)


def _frame_step_reference(p, x, rows, vns, swans, phis, actives, q_cov,
                          zin, rsc, mp, rp, wheel_base, dt, sigma_heading,
                          use_heading) -> FrameStep:
    """The fastframe factors composed with the whole-frame measurement
    chain: the same algebra as the split schedule, bracketed as the
    reference's CPU route."""
    from conan_slam_tpu_torch.filters.ekf.fastframe import _frame_core
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

    shim = EKFState(x=x, p=p, n_active=torch.zeros((), dtype=torch.int64, device=p.device),
                    table=torch.zeros((1,), dtype=torch.int64, device=p.device))
    x1, pose_trace, vmat, bmat = _frame_core(
        shim, vns, swans, phis, actives, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    nr = rows.shape[0]
    rows_p = F.pad(rows, (0, rp - nr), value=-1)
    prows = F.pad(p[rows], (0, 0, 0, rp - nr))
    fu = _frame_update_obs_reference(p, x1, rows_p, prows, zin, rsc, bmat, vmat.T, mp, rp)
    return FrameStep(p=fu.p, x=fu.x, pose_trace=pose_trace, nis=fu.nis)


def _frame_update_obs_reference(p, x, rows, prows, zin, rsc, bmat, vtf, mp, rp):
    """Observe + measurement chain + rank update against P' = P + V B V^T."""
    xrows = _masked_cols(x, rows)
    hcc, rmat, v2 = _observe_reference(xrows, zin, rsc, mp, rp)
    hc = _dense_hc(hcc, rp)
    chain = _measurement_chain_reference(prows, rows, hc, bmat, vtf, rmat, v2)
    p_out = rank_update_t2_reference(p, vtf, chain.bvt, chain.pht, chain.nsipht)
    xn = x + chain.dx
    xn = torch.cat([xn[:2], wrap_angle(xn[2:3]), xn[3:]])
    return FrameUpdateObs(p=p_out, x=xn, nis=chain.nis)


def _measurement_chain_reference(prows, rows, hc, bmat, vtf, rmat, v2):
    """pht, S, S^-1 (Cholesky route), gains and the two update strips."""
    hvm = hc @ _masked_cols(vtf, rows).T                    # (MP, NB)
    pht = hc @ prows + (hvm @ bmat) @ vtf
    s = _masked_cols(pht, rows) @ hc.T + rmat
    si = spd_inverse_reference(s)
    siv = v2 @ si
    return MeasurementChain(
        pht=pht, bvt=bmat @ vtf, nsipht=-(si @ pht), siv=siv,
        dx=siv @ pht, nis=torch.dot(siv, v2),
    )
