"""The whole observation frame (port of
conan_slam_tpu.ops.frame_kernel.frame_step, frame_step_pair,
frame_update_obs and their references).

The reference runs the known frame on the TPU as one resident kernel
(``_framestep_kernel``) whose grid steps run in order.  The port's default
is its Hopper counterpart, H9 ``frame_step`` (csrc/frame_step.cu): TWO
launches from one C entry: a cooperative frame kernel, one block an SM,
whose phases (the chain, the sweep with the pht units beside it, the gains
and the mean) are separated by grid barriers, then the P pass at H4's
occupancy, launched behind it with programmatic dependent launch.
``frame_step`` takes the frame's raw slots and buffers, and H9 does the
packing and the gathers itself (its plain version
``_frame_step_resident_reference``).

``frame_route`` names the route a frame takes, from its shapes alone:
"resident" (H9) where H9's phases fit a block (MP <= 224, H1's register
limit), "split" (below) under ``schedule="split"`` or past MP 224 (H1's
cooperative sweep), "plain" (the reference's jnp route,
``_frame_step_reference``) where neither the port's kernels nor the
reference's TPU schedules hold the frame, and "unported" where only the
reference's do: such a frame raises on the card.  The frame pair and the
gated frame choose between their kernels and the plain route the same way.

The split schedule is the reference's big-D one (``_frame_step_big``: a
chain kernel, then one O(D^2) rank pass), proven equal to the resident one
by the reference's own tests; the frame pair keeps it:

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
gets its factors P' = P + vtf^T B vtf from H5 (ops.factor_kernel).  Its
default route is H10 ``obs_step`` (csrc/obs_step.cu), H9's design carried
over to the gated frame: TWO launches from one C entry, a cooperative frame
kernel (the chain in bands: the packing from the raw slots, the observe,
compact Hc, the hvb coupling and S; the sweep beside the pht units, with
[vtf; B vtf]; the gains -S^-1 pht and the mean), then the P pass
P + [vtf; pht]^T [B vtf; -S^-1 pht] at H4's occupancy behind a
programmatic launch (``obs_route``; its plain version
``_frame_update_obs_resident_reference``).  Its split schedule, under
``schedule="split"`` and past MP 224, runs

  H7 ``obs_chain`` (one block a band of one measurement): observe, compact
      Hc, v, R, the coupling hvb = (Hc vtf[:, rows]^T) B and S = (Hc
      P[rows][:, rows] + hvb vtf[:, rows]) Hc^T + R.
  H1 ``sweep_si``: S^-1, as above.
  H8 ``obs_panels`` (column panels of 8 or 16 columns on persistent
      blocks, ``obs_panels_plan``): pht = Hc P[rows] + hvb vtf, the gains, the
      updated mean and the NIS; H3's design: clusters of 8 blocks split
      siv, the panels staged by cp.async.
  H4 ``rank_update_t``: P + G^T M G with G = [vtf; pht] and
      M = blockdiag(B, -S^-1).

Each kernel's plain PyTorch version sits beside its wrapper; the
wrapper takes it for CPU tensors only.  ``_frame_step_reference`` is the
independent oracle and the plain route: the fastframe factors composed
with the measurement chain, as the reference's CPU route.

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

import ctypes
import functools
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
    MAX_MP,
    _sweep_smem_bytes,
    spd_inverse_reference,
    sweep_fits,
    sweep_si,
    sweep_si_reference,
)
from conan_slam_tpu_torch.utils import profiling

MS_LEN = 32
# Sub-steps per frame the recursion of H2, H5 and H9 holds (csrc/coeff.cuh
# CSL_MAX_STEPS): its per-sub-step terms live in shared memory sized by S.
MAX_STEPS = 256

N_SM = 132          # SMs of an H100 SXM, the most blocks H2's bands spread over
PANEL_W = 16        # H3's columns of D a block (csrc/frame_panels.cu)
PANEL_CLUSTER = 8   # H3's blocks that share one siv
PANEL_THREADS = 256
PANEL_LD = 24       # H3's panel row stride in shared memory
# H8 (csrc/obs_panels.cu): 128 threads a block, 4 column threads by 32 row
# groups; panels of 8 or 16 columns; clusters of 8 blocks share siv; an SM
# holds 768 of its threads (85 registers each) and 228 KB of shared memory,
# 1 KB of it a block's own.
OP_TX = 4
OP_TY = 32
OP_THREADS = OP_TX * OP_TY
OP_CLUSTER = 8
OP_MAX_MP = 2048
OP_SM_THREADS = 768
OP_SM_SMEM = 233_472
OP_WALK = 32        # the most columns a block walks
OP_PLAN = 10        # values csl_obs_panels_plan reports

# H9 (csrc/frame_step.cu): the frame kernel's one block size for every
# phase, the sweep's 16 warps; 16-column pht panels (32 row groups) in
# units of 24 columns a block through the panels and the gains; the most
# gathered rows (MP = 224).
FS_THREADS = 512
FS_W = 16
FS_LD = 24
FS_UNIT = 24
FS_XG = 32          # the mean's partial sums a column
FS_MAX_RP = 232
FS_STAMPS = 12      # H9's phase stamps a block (csrc/frame_step.cu stamp())
FS_LAUNCHES = 2     # kernels a call launches: the frame kernel, the P pass
FS_PLAN = 14        # values csl_frame_step_plan reports
FP_PLAN = 8         # values csl_frame_pass_plan reports

# The P pass, H9's and H10's second launch (csrc/resident.cuh): H4's
# 64-thread 32-tiles, one block a tile; or, where D gives at least
# PASS_TILES_AN_SM tiles of 128 an SM and P's rows take 16-byte copies
# (``pass_tile``), the streamed 128-tiles: one persistent block an SM of 8
# consumer warps, the strips' warp (a ring of SP_STAGES stages of SP_BK
# rows), P's warp and out's warp (a ring of SP_SLOTS half-blocks of P),
# every copy a tensor copy.
PASS_SMALL = 32
PASS_BIG = 128
PASS_TILES_AN_SM = 8
SP_THREADS = 352
SP_BK = 16
SP_STAGES = 4
SP_SLOTS = 5
PASS_ROUTES = {"auto": 0, "tile32": PASS_SMALL, "tile128": PASS_BIG}
# H9's static shared memory: rows, qc, ms, a max per warp.
FS_STATIC_BYTES = 4 * (FS_MAX_RP + 4 + MS_LEN + FS_THREADS // 32)

# H10 (csrc/obs_step.cuh): H9's frame-kernel block; units of 8 to 32
# columns a block through the pht units and the gains (``obs_step_unit``),
# the mean's partial sums a column, MG's warps; the most gathered rows (MP
# = 224).
OS_THREADS = 512
OS_COLS = 8
OS_MAX_UNIT = 32
OS_XG = 32
OS_MG_WARPS = 8
OS_MAX_RP = 232
OS_STAMPS = 12      # H10's phase stamps a block (csrc/obs_step.cuh stamp())
OS_LAUNCHES = 2     # kernels a call launches: the frame kernel, the P pass
OS_PLAN = 14        # values csl_obs_step_plan reports
# H10's static shared memory: rows, a max per warp.
OS_STATIC_BYTES = 4 * (OS_MAX_RP + OS_THREADS // 32)
# The gated chain's rows a band, in H7 and H10 alike: one measurement.
OBS_BAND = 2

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


FRAME_STEP = cuda.CudaKernel(
    "frame_step", "csl_frame_step",
    [cuda.P] * 18 + [cuda.I] * 16 + [cuda.F] * 3 + [cuda.I],
    source="conan_slam_tpu_torch/csrc/frame_step.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:1312 (frame_step -> pallas_call :1399, "
             "_framestep_kernel :655)",
    launches_per_call=FS_LAUNCHES,
)
FRAME_PASS = cuda.CudaKernel(
    "frame_pass", "csl_frame_pass",
    [cuda.P] * 4 + [cuda.I] * 4,
    source="conan_slam_tpu_torch/csrc/frame_step.cu",
    replaces="none of its own: H9's and H10's second launch (the P pass) alone, on a route "
             "of the caller's, for the card's tests and timings",
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
OBS_STEP = cuda.CudaKernel(
    "obs_step", "csl_obs_step",
    [cuda.P] * 14 + [cuda.I] * 11,
    source="conan_slam_tpu_torch/csrc/obs_step.cu",
    replaces="conan_slam_tpu/ops/frame_kernel.py:535 (frame_update_obs -> pallas_call :607, "
             "_fullframe_kernel :381)",
    launches_per_call=OS_LAUNCHES,
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


def _coeff_smem_floats(s_steps: int) -> int:
    """The recursion's shared memory: its columns and per-sub-step inputs
    and terms (csrc/coeff.cuh csl_coeff_smem_floats)."""
    return 41 * s_steps + 8


def _chain_smem_bytes(mp: int, rp: int, band: int, s_steps: int = MAX_STEPS) -> int:
    """Shared memory of one H2 block at ``s_steps`` sub-steps (by default
    the most it takes; csrc/frame_chain.cu frame_chain_smem)."""
    rpa = _round_up(rp, 4)
    return 4 * ((4 + band) * rpa + _round_up(3 * (mp // 2), 4) + 4 + 8 * mp + band * rp
                + _coeff_smem_floats(s_steps))


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
    if s_steps > MAX_STEPS or _chain_smem_bytes(mp, rp, plan.band, s_steps) > cuda.MAX_SMEM_BYTES:
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


def frame_rows(slots, capacity: int):
    """[0, 1, 2, 3 + 2 s_0, 4 + 2 s_0, ...]: the rows a frame gathers, the
    slots clamped to [0, capacity - 1]."""
    safe = torch.clamp(slots, 0, capacity - 1)
    two = torch.arange(2, device=safe.device)
    rows2 = (3 + 2 * safe[:, None] + two[None, :]).reshape(-1)
    return torch.cat([torch.arange(3, device=safe.device), rows2])


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


# ------------------------------------------- the route a frame takes


def _smem_limit(device) -> int:
    """The shared memory one block may use on ``device`` (the H100's, whose
    routes the CPU's plain versions follow, for the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return cuda.MAX_SMEM_BYTES
    props = torch.cuda.get_device_properties(device)
    return getattr(props, "shared_memory_per_block_optin", cuda.MAX_SMEM_BYTES)


def _frame_step_smem_bytes(mp: int, rp: int, band: int, s_steps: int = MAX_STEPS) -> int:
    """The dynamic shared memory of H9's frame kernel at ``s_steps``
    sub-steps (by default the most it takes): the largest of its phases'
    needs (csrc/frame_step.cu smem_bytes; the chain's holds the controls
    too).  The P pass, its second launch, takes H4's ring of 32-tiles."""
    unit = FS_UNIT
    return max(
        _chain_smem_bytes(mp, rp, band, s_steps) + 16 * s_steps,
        _sweep_smem_bytes(mp) + 4 * 2 * mp,                          # sweep, v, siv
        4 * (mp * unit + 8 * mp + MS_LEN + FS_LD * rp),              # pht units
        4 * (mp * unit + mp * mp + FS_XG * unit + 2 * mp + MS_LEN + 16),  # gains, 7 mbarriers
    )


def _split_fits(mp: int, rp: int, s_steps: int, limit: int) -> bool:
    """H2, H1 and H3 hold a frame of these shapes (H4 holds any)."""
    return (s_steps <= MAX_STEPS and sweep_fits(mp, limit) and mp <= PANEL_CLUSTER * PANEL_THREADS
            and _chain_smem_bytes(mp, rp, frame_chain_plan(mp).band, s_steps) <= limit
            and _panels_smem_bytes(mp, rp) <= limit)


# The reference's TPU schedules: its VMEM budget (FK_VMEM_BUDGET_MB's
# default) and its padding, MP = 2 NZ rounded up to 128.
_REF_VMEM_BUDGET = 15 * 2**20


def _ref_shapes(nz: int) -> tuple[int, int]:
    return _round_up(2 * nz, 128), _round_up(3 + 2 * nz, 8)


def _ref_frame_step_has_kernel(d: int, nz: int) -> bool:
    """The reference's ``can_fuse_frame_step`` (and ``can_fuse_frame_pair``):
    its streaming chain kernel has a column tile (``_pick_bigchain_tile``).
    Its resident schedule needs strictly more VMEM at every shape, so it
    adds no shape to these."""
    if d % 128:
        return False
    mp, rp = _ref_shapes(nz)
    fixed = (3 * mp * mp + 2 * mp * rp + rp * rp + mp * 16 + 200) * 4
    return any(d % tc == 0 and fixed + tc * (2 * rp + 2 * mp + 8) * 4 <= _REF_VMEM_BUDGET
               for tc in (1024, 512, 256, 128))


def _ref_frame_update_has_kernel(d: int, nz: int, nb: int) -> bool:
    """The reference's ``can_fuse_frame`` (``_pick_frame_tile``): its gated
    one-dispatch frame has a row panel."""
    if d % 128:
        return False
    mp, rp = _ref_shapes(nz)
    nbp = _round_up(nb, 8)
    fixed = (rp + 2 * nbp + 2 * mp + 2) * d * 4 + (4 * mp * mp + rp * rp) * 4
    fixed += (nbp * nbp + nbp * rp + 2 * rp + mp // 2 * 8) * 4
    fixed += (2 * mp * rp + mp * mp) * 4
    return any(d % tr == 0 and fixed + tr * (6 * d + mp) * 4 <= _REF_VMEM_BUDGET
               for tr in (512, 256, 128))


def _past_the_kernels(route: str, name: str, plain: bool, *tensors) -> bool:
    """Whether a frame past the port's kernels takes the plain route:
    ``route`` "plain" (the reference itself runs its jnp route there), or
    "unported" on CPU tensors or under ``plain=True``.  Otherwise an
    "unported" frame raises: the reference runs a TPU kernel at that shape
    that no kernel of the port holds."""
    if route == "unported" and not (plain or cuda.on_cpu(*tensors)):
        raise ValueError(
            f"{name}: the reference runs a TPU kernel at this shape and no kernel of the port "
            "holds it; see ROADMAP.md")
    return route in ("plain", "unported")


@functools.lru_cache(maxsize=None)
def frame_route(d: int, nz: int, device, s_steps: int = 1, schedule: str = "auto") -> str:
    """The route ``frame_step`` takes for a frame at D = ``d`` with ``nz``
    measurement slots and ``s_steps`` sub-steps on ``device``: a function
    of the shapes alone, chosen before any launch:

      "resident"  H9 (a cooperative frame kernel and the P pass), where its
                  phases fit a block
                  (MP <= 224, H1's register limit);
      "split"     H2 -> H1 -> H3 -> H4, under ``schedule="split"``, or where
                  only the split fits (MP 226 to 2048: H1's cooperative
                  sweep);
      "plain"     the reference's jnp route (``_frame_step_reference``),
                  where no kernel of the port fits (past MAX_STEPS = 256
                  sub-steps, or MP 2048) and the reference has no TPU
                  schedule either
                  (``can_fuse_frame_step``: D not a multiple of 128, or no
                  VMEM tile);
      "unported"  no kernel of the port fits, but the reference has a TPU
                  schedule: the frame raises on the card (the plain route
                  on the CPU).

    D limits none of the port's kernels (every phase walks it in panels and
    tiles).  On the CPU a route's plain versions run; the shapes decide the
    route the same way, against the card's shared memory."""
    if schedule not in ("auto", "split"):
        raise ValueError(f"frame_route: schedule must be 'auto' or 'split', got {schedule!r}")
    mp, rp = frame_shapes(nz)
    limit = _smem_limit(device)
    if not _split_fits(mp, rp, s_steps, limit):
        return "unported" if _ref_frame_step_has_kernel(d, nz) else "plain"
    band = frame_chain_plan(mp).band
    if (schedule == "auto" and rp <= FS_MAX_RP
            and _frame_step_smem_bytes(mp, rp, band, s_steps) + FS_STATIC_BYTES <= limit):
        return "resident"
    return "split"


# ------------------------------------------------- the P pass's route


def pass_tile(d: int, sms: int = N_SM, vec: bool = True) -> int:
    """The P pass's tile edge at D = ``d`` on a card of ``sms`` SMs
    (csrc/resident.cuh pass_route, H9's and H10's rule): PASS_BIG, the
    streamed 128-tiles, where D gives at least PASS_TILES_AN_SM upper-
    triangle tiles of 128 an SM and P's rows take 16-byte copies (``vec``:
    ``pass_vec``), else PASS_SMALL, H4's 32-tiles."""
    n = -(-d // PASS_BIG)
    return PASS_BIG if vec and n * (n + 1) // 2 >= PASS_TILES_AN_SM * sms else PASS_SMALL


def _tile_ij(tile: int, nt: int) -> tuple[int, int]:
    """Tile ``tile`` of the row-by-row upper-triangle list of ``nt`` x
    ``nt`` tiles as (I, J) (csrc/rank_tile.cuh tile_ij, line for line)."""
    i, rem = 0, tile
    while rem >= nt - i:
        rem -= nt - i
        i += 1
    return i, i + rem


def pass_walk(nt: int, grid: int, block: int) -> list[tuple[int, int]]:
    """The tiles (I, J) that block ``block`` of the streamed pass's
    ``grid`` persistent blocks takes, in order, over the row-by-row upper-
    triangle list of ``nt`` x ``nt`` tiles (csrc/resident.cuh csl_sp::Walk,
    line for line: tiles block, block + grid, ...)."""
    ntiles = nt * (nt + 1) // 2
    tile, ti, tj = block, 0, 0
    if tile < ntiles:
        ti, tj = _tile_ij(tile, nt)
    walk = []
    while tile < ntiles:
        walk.append((ti, tj))
        tile += grid
        tj += grid
        while ti < nt and tj >= nt:
            tj -= nt
            ti += 1
            tj += ti
    return walk


def stream_pass_smem_bytes() -> int:
    """The streamed pass's shared memory a block (csl_sp::SMEM): 1 KB to
    align the rings, the strips' ring, P's ring of half-blocks (64 x 128)
    and the mbarriers (each stage's full and empty; each slot's P landed,
    sums added, out stored)."""
    ring = SP_STAGES * 2 * SP_BK * PASS_BIG
    halves = SP_SLOTS * PASS_BIG // 2 * PASS_BIG
    return 1024 + 4 * (ring + halves) + 8 * (2 * SP_STAGES + 3 * SP_SLOTS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def pass_vec(p: torch.Tensor, out: torch.Tensor) -> bool:
    """P's rows take 16-byte copies in the P pass from ``p`` to ``out``
    (csrc/resident.cuh pass_vec): D % 4 == 0, P and out 16-byte aligned."""
    return p.shape[0] % 4 == 0 and p.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0


def _count_pass_route(p: torch.Tensor, p_out: torch.Tensor) -> None:
    """Count a frame launched on the card by its P pass's route from
    ``p`` into ``p_out``, in the port's tracer: ``pass.tile128`` or
    ``pass.tile32`` (nothing while the tracer is off)."""
    if profiling.TRACER.on:
        vec = pass_vec(p, p_out)
        profiling.count(f"pass.tile{pass_tile(p.shape[0], _sm_count(p.device.index), vec)}")


class FramePassPlan(NamedTuple):
    """The P pass's launch on one route (``frame_pass_plan``)."""

    tile: int        # tile edge: 32 or 128
    grid: int        # blocks: one a tile (32), one an SM (128)
    block: int       # threads a block
    smem: int        # dynamic shared memory a block, bytes
    regs: int        # registers a thread
    local: int       # local-memory bytes a thread: spills and stack
    occ: int         # blocks an SM
    tiles: int       # upper-triangle tiles over P


def frame_pass_plan(d: int, device, route: str = "auto") -> FramePassPlan:
    """The P pass's launch at D = ``d`` on ``route`` (``frame_pass``'s;
    16-byte P rows) on the CUDA ``device``; launches nothing."""
    lib = cuda.library()
    fn = lib.csl_frame_pass_plan
    fn.argtypes = [cuda.I, cuda.I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * FP_PLAN)()
    with torch.cuda.device(device):
        err = fn(d, PASS_ROUTES[route], out)
    if err != 0:
        raise RuntimeError(f"frame_pass plan failed: {lib.csl_error_string(err).decode()} ({err})")
    return FramePassPlan(*out)


def frame_pass(p: torch.Tensor, g: torch.Tensor, mg: torch.Tensor, route: str = "auto") -> torch.Tensor:
    """The frames' P pass alone: out = P + G^T MG over the strips ``g``,
    ``mg`` (r, ldg), ldg >= D a multiple of 4 (columns from D on unread);
    on the card G^T MG's upper triangle, mirrored (the whole product where
    it is symmetric, as the frames' is).  ``route``: "auto" the frames'
    (``pass_tile``), "tile32" or "tile128" (D % 4 == 0, P 16-byte
    aligned).  CPU tensors take the plain version; P is not modified."""
    if route not in PASS_ROUTES:
        raise ValueError(f"frame_pass: route must be one of {sorted(PASS_ROUTES)}, got {route!r}")
    d, (r, ldg) = p.shape[0], g.shape
    if cuda.on_cpu(p, g, mg):
        return rank_update_vbt_reference(p, g[:, :d], mg[:, :d])
    cuda.check(p, "p", (d, d))
    cuda.check(g, "g", (r, ldg))
    cuda.check(mg, "mg", (r, ldg))
    if ldg < d or ldg % 4:
        raise ValueError(f"frame_pass: the strips' row stride must be >= D and a multiple of 4, got {ldg}")
    out = torch.empty_like(p)
    FRAME_PASS(p.device, cuda.ptr(p), cuda.ptr(g), cuda.ptr(mg), cuda.ptr(out), d, ldg, r,
               PASS_ROUTES[route])
    return out


# ------------------------------------------------- H9: the resident frame


class FrameStepPlan(NamedTuple):
    """H9's two launches and the work of each of its phases."""

    grid: int        # frame kernel blocks: one an SM (a cooperative launch)
    block: int       # its threads a block, in every phase
    smem: int        # its dynamic shared memory a block, the largest phase's
    regs: int        # its registers a thread (cudaFuncGetAttributes)
    local: int       # its local-memory bytes a thread: spills and stack
    bands: int       # phase 1: blocks that form rows of S (frame_chain_plan)
    panels: int      # phase 2: 16-column pht panels of D
    unit: int        # phases 2 and 3: columns of D a block takes at a time
    units: int       # phases 2 and 3: units of D
    pass_grid: int   # the P pass: blocks, one a tile (32), one an SM (128)
    pass_block: int  # its threads a block
    pass_smem: int   # its shared memory a block
    pass_regs: int   # its registers a thread
    pass_local: int  # its local-memory bytes a thread
    pass_occ: int    # its blocks an SM (the occupancy query)
    tiles: int       # the P pass: upper-triangle tiles over P
    tile: int        # the P pass's tile edge, its route (``pass_tile``)


def frame_step_plan(d: int, mp: int, device, s_steps: int = MAX_STEPS) -> FrameStepPlan:
    """The grids, blocks and shared memory of H9's two launches at D =
    ``d``, MP = ``mp`` (RP the largest for that MP) and ``s_steps``
    sub-steps on the CUDA ``device``, their registers, and each phase's
    work; launches nothing."""
    rp = _round_up(3 + mp, 8)
    band = frame_chain_plan(mp).band
    lib = cuda.library()
    fn = lib.csl_frame_step_plan
    fn.argtypes = [cuda.I] * 5 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * FS_PLAN)()
    with torch.cuda.device(device):
        err = fn(mp, rp, band, s_steps, d, out)
    if err != 0:
        raise RuntimeError(f"frame_step plan failed: {lib.csl_error_string(err).decode()} ({err})")
    (grid, block, smem, regs, local, pass_grid, pass_block, pass_smem, pass_regs, pass_local,
     unit, tiles, pass_occ, tile) = out
    return FrameStepPlan(grid=grid, block=block, smem=smem, regs=regs, local=local,
                         bands=frame_chain_plan(mp).grid, panels=-(-d // FS_W), unit=unit,
                         units=-(-_round_up(d, 4) // unit), pass_grid=pass_grid,
                         pass_block=pass_block, pass_smem=pass_smem, pass_regs=pass_regs,
                         pass_local=pass_local, pass_occ=pass_occ, tiles=tiles, tile=tile)


def _frame_step_scratch_floats(mp: int, ldg: int) -> int:
    """H9's scratch: S, S^-1, rowc, ms, siv and the strips G, MG (MP + 8, ldg)."""
    return 2 * mp * mp + 9 * mp + MS_LEN + 2 * (mp + 8) * ldg


def _frame_step_resident_reference(p, x, fi: FrameInputs, wheel_base, dt, sigma_heading,
                                   use_heading) -> FrameStep:
    """Plain version of H9: the resident body's algebra on the packed
    inputs: the chain, the sweep, siv, xn and the NIS, then
    P + p2^T wrow + border - (pht^T S^-1) pht."""
    ch = _frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp,
                                wheel_base, dt, sigma_heading, use_heading)
    si = sweep_si_reference(ch.s, fi.nblk)
    pht, xn, nis = _frame_panels_reference(ch.rowc, ch.ms, si, fi.prows, x)
    alpha, g, m3 = ch.ms[4], ch.ms[5:8], ch.ms[8:17].reshape(3, 3)
    d = p.shape[0]
    p2 = fi.prows[2]
    wrow = alpha * p2 + F.pad(g, (0, d - 3))
    border = g[:, None] * p2 + F.pad(m3, (0, d - 3))           # (3, D)
    p_out = p + p2[:, None] * wrow - (pht.T @ si) @ pht
    p_out = torch.cat([p_out[:3] + border, p_out[3:]])
    return FrameStep(p=p_out, x=xn, pose_trace=ch.pt, nis=nis[0])


def _frame_step_h9(p, x, slots, capacity: int, vns, swans, phis, actives, q_cov, zr, zb, mask,
                   r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
                   stamps=None) -> FrameStep:
    """Launch H9 on CUDA tensors (``frame_step``'s resident route): the
    frame kernel, then the P pass.  ``stamps``, a (grid + pass_grid,
    FS_STAMPS) int64 CUDA tensor (``frame_step_plan``), takes the frame
    kernel's blocks' %globaltimer (ns) at their phase boundaries in rows
    0 .. grid - 1: the start, the chain done, past barrier 1, block 0's
    sweep or another block's pht units done, block 0's siv and NIS done
    (beside the gains), past barrier 2, the gains done, block 0's SM
    clock64 at the sweep's start and end, then the first unit's S^-1
    staged, its MG stored and its siv formed; and each P-pass block's start
    (past its wait for the frame kernel) and end in the rows after them.
    None records nothing."""
    d, nz, s_steps = p.shape[0], slots.shape[0], vns.shape[0]
    mp, rp = frame_shapes(nz)
    cuda.check(p, "p", (d, d))
    cuda.check(x, "x", (d,))
    cuda.check(q_cov, "q_cov", (2, 2))
    cuda.check(r_cov, "r_cov", (2, 2))
    strides = (
        cuda.vector_stride(slots, "slots", nz, torch.int64),
        cuda.vector_stride(vns, "vns", s_steps),
        cuda.vector_stride(swans, "swans", s_steps),
        cuda.vector_stride(phis, "phis", s_steps),
        cuda.vector_stride(actives, "actives", s_steps, torch.bool),
        cuda.vector_stride(zr, "zr", nz),
        cuda.vector_stride(zb, "zb", nz),
        cuda.vector_stride(mask, "mask", nz, torch.bool),
    )
    dev, f32 = p.device, torch.float32
    ldg = _round_up(d, 4)
    p_out = torch.empty_like(p)
    xn = torch.empty((d,), dtype=f32, device=dev)
    pt = torch.empty((s_steps, 3), dtype=f32, device=dev)
    nis = torch.empty((1,), dtype=f32, device=dev)
    scratch = torch.empty((_frame_step_scratch_floats(mp, ldg),), dtype=f32, device=dev)
    if stamps is not None:
        plan = frame_step_plan(d, mp, dev, s_steps)
        cuda.check(stamps, "stamps", (plan.grid + plan.pass_grid, FS_STAMPS), torch.int64)
    _count_pass_route(p, p_out)
    FRAME_STEP(
        dev, *(cuda.ptr(t) for t in (p, x, slots, vns, swans, phis, actives, q_cov, zr, zb, mask,
                                     r_cov, p_out, xn, pt, nis, scratch)),
        None if stamps is None else cuda.ptr(stamps),
        *strides, d, nz, s_steps, int(capacity), mp, rp, ldg, frame_chain_plan(mp).band,
        float(wheel_base), float(dt), float(sigma_heading), int(bool(use_heading)),
    )
    return FrameStep(p=p_out, x=xn, pose_trace=pt, nis=nis[0])


# ------------------------------------------------------ the whole frame


def frame_step(p, x, slots, capacity: int, vns, swans, phis, actives, q_cov, zr, zb, mask,
               r_cov, wheel_base, dt, sigma_heading, use_heading: bool,
               *, plain: bool = False, schedule: str = "auto") -> FrameStep:
    """The whole known-association observation frame: S predict + heading
    sub-steps, range-bearing observe, measurement update and the P pass.

    Args as the reference's, except that the frame takes its raw map slots
    ``slots`` (NZ,) int64 and the table's ``capacity`` in place of the
    gathered rows [0, 1, 2, 3 + 2 s, 4 + 2 s, ...] (``frame_rows``, the
    slots clamped to [0, capacity - 1]): H9 forms the rows in its launch.
    ``vns``/``swans``/``phis``/``actives`` (S,) are the per-sub-step
    controls, measured heading and active flags; ``zr``/``zb``/``mask``
    (NZ,) the measurement buffer.  The 1-D inputs may be strided views (a
    column of the measurement buffer).

    The route is ``frame_route``'s, decided once: H9 by default, the split
    schedule under ``schedule="split"`` (a test hook, as the reference's
    ``_force_schedule``), the plain route where neither the port nor the
    reference has a kernel; a frame the reference runs on a TPU kernel and
    no kernel of the port holds raises on the card.  CPU tensors, or
    ``plain=True`` on any device, run the route's plain PyTorch versions
    (the baseline the kernels are measured against).  Returns
    ``FrameStep(p, x, pose_trace, nis)``; P is not modified in place.
    """
    d, nz = p.shape[0], zr.shape[0]
    tensors = (p, x, slots, vns, swans, phis, actives, q_cov, zr, zb, mask, r_cov)
    tail = (wheel_base, dt, sigma_heading, use_heading)
    route = frame_route(d, nz, p.device, vns.shape[0], schedule)
    if route == "resident" and not (plain or cuda.on_cpu(*tensors)):
        return _frame_step_h9(p, x, slots, capacity, *tensors[3:], *tail)
    rows = frame_rows(slots, capacity)
    if _past_the_kernels(route, "frame_step", plain, *tensors):
        return _plain_frame(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask, r_cov,
                            tail)
    fi = frame_inputs(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask, r_cov)
    if route == "resident":
        return _frame_step_resident_reference(p, x, fi, *tail)
    ch, si, pht, xn, nis = _frame_measure(fi, x, tail, plain)
    gmat, mmid = _frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp)
    update = rank_update_t_reference if plain else rank_update_t
    p_out = update(p, gmat, mmid)
    return FrameStep(p=p_out, x=xn, pose_trace=ch.pt, nis=nis[0])


def _plain_frame(p, x, rows, vns, swans, phis, actives, q_cov, zr, zb, mask, r_cov,
                 tail) -> FrameStep:
    """The plain route of one frame at its gathered ``rows``: the
    reference's jnp route (``_frame_step_reference``)."""
    mp, rp = frame_shapes(zr.shape[0])
    zin, rsc, _ = _pack_meas(zr, zb, mask, r_cov, mp // 2)
    return _frame_step_reference(p, x, rows, vns, swans, phis, actives, q_cov, zin, rsc, mp, rp,
                                 *tail)


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
    pair algebra through the plain versions.  Where the split schedule does
    not fit (``frame_route``: past 256 sub-steps or MP 2048), the pair is two
    frames of ``frame_step``'s plain route, as the reference's jnp route,
    and raises on the card where the reference has a TPU schedule
    ("unported").  P is not modified in place.
    """
    tail = (wheel_base, dt, sigma_heading, use_heading)
    route = frame_route(p.shape[0], meas_a[0].shape[0], p.device, ctrl_a[0].shape[0], "split")
    if _past_the_kernels(route, "frame_step_pair", plain, p, x, rows_a, rows_b, q_cov, r_cov,
                         *ctrl_a, *meas_a, *ctrl_b, *meas_b):
        fa = _plain_frame(p, x, rows_a, *ctrl_a, q_cov, *meas_a, r_cov, tail)
        fb = _plain_frame(fa.p, fa.x, rows_b, *ctrl_b, q_cov, *meas_b, r_cov, tail)
        return FramePair(p=fb.p, x=fb.x, pose_trace=torch.stack([fa.pose_trace, fb.pose_trace]),
                         nis=torch.stack([fa.nis, fb.nis]), pose_mid=fa.x[:3])
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


def _obs_smem_bytes(mp: int, rp: int, nbp: int, band: int = OBS_BAND) -> int:
    """Shared memory of one H7 band block, or of H10's chain phase
    (csrc/obs_band.cuh csl_obs_smem_floats)."""
    rpa = _round_up(rp, 4)
    return 4 * (rpa + _round_up(3 * (mp // 2), 4) + 4 + 6 * mp + (3 + band) * rpa
                + 2 * band * nbp + band * rp)


def obs_chain_plan(mp: int) -> ChainPlan:
    """H7's bands at MP = ``mp``: one measurement (two rows) a block."""
    return ChainPlan(band=OBS_BAND, grid=mp // OBS_BAND, mp=mp)


def obs_chain(zin, rsc, xrows, prc, vrows, bmat, mp):
    """The gated frame's chain up to S: plain version for CPU tensors,
    kernel H7 (one block a band of one measurement, ``obs_chain_plan``) for
    CUDA tensors."""
    if cuda.on_cpu(zin, rsc, xrows, prc, vrows, bmat):
        return _obs_chain_reference(zin, rsc, xrows, prc, vrows, bmat, mp)
    rp = prc.shape[0]
    nbp = bmat.shape[0]
    plan = obs_chain_plan(mp)
    if _obs_smem_bytes(mp, rp, nbp, plan.band) > cuda.MAX_SMEM_BYTES:
        raise ValueError(f"obs_chain: MP={mp}, RP={rp}, NBP={nbp} exceed a block")
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
              mp, rp, nbp, plan.band)
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


class ObsPanelsPlan(NamedTuple):
    """H8's column panels: block b writes panels b, b + grid, ... (columns
    [p width, (p + 1) width) of pht and xn) and forms siv entries for its
    cluster."""

    width: int     # columns of D a panel
    panels: int    # panels of D
    grid: int      # blocks launched: whole clusters
    cluster: int   # blocks that share one siv
    block: int     # threads a block
    rows: int      # rowc and hvb rows a chunk (MP: all in one)
    smem: int      # dynamic shared memory a block, bytes


def _obs_panels_smem_floats(mp: int, rp: int, nbp: int, width: int, rows: int) -> int:
    """Shared memory of one H8 block in floats (csrc/obs_panels.cu
    smem_floats): siv, the block's siv entries (MP / 8 in whole quads), the
    partial sums, a chunk of rowc and (transposed) hvb rows, the panel
    buffer: a prows panel, a vtf panel and the panel's x."""
    nb4 = _round_up(nbp, 4)
    return (_round_up(mp, 4) + _round_up(-(-mp // OP_CLUSTER), 4)
            + _round_up(max(OP_TY * (width + 1), 4 * OP_THREADS), 4) + rows * 8
            + (nb4 * (_round_up(rows, 8) + 4) if rows else 0)
            + rp * (width + 4) + nb4 * width + width)


def obs_panels_plan(d: int, mp: int, rp: int, nbp: int, sms: int = N_SM) -> ObsPanelsPlan | None:
    """H8's panels at D = ``d``, MP = ``mp``, RP = ``rp``, NBP = ``nbp`` on
    a card of ``sms`` SMs (csrc/obs_panels.cu make_plan), or None where no
    block holds them.  8-column panels while one block a panel stays
    within the SMs' threads, else 16, if all MP rows of rowc and hvb fit
    beside the panel; else 8 columns and the most rows a chunk that fit, a
    multiple of 8.  Then the fewest panels a block, k, that one round of
    resident blocks covers (an SM's threads and shared memory decide how
    many it holds), but no more than OP_WALK columns a block, and the grid
    ceil(panels / k) in whole clusters."""
    if not (0 < mp <= OP_MAX_MP and mp % 4 == 0 and rp >= 3 and nbp > 0 and d >= 3):
        return None
    floats = cuda.MAX_SMEM_BYTES // 4
    by_threads = OP_SM_THREADS // OP_THREADS
    nb4 = _round_up(nbp, 4)
    width = 8 if -(-d // 8) <= by_threads * sms else 16
    while True:
        fixed = _obs_panels_smem_floats(mp, rp, nbp, width, 0) + 4 * nb4
        rows = (max(0, floats - fixed) // (8 + nb4)) & ~7
        if rows >= mp:
            rows = mp if _obs_panels_smem_floats(mp, rp, nbp, width, mp) <= floats else mp & ~7
        if rows == mp or width == 8:
            break
        width = 8
    if rows < 8 and rows != mp:
        return None
    panels = -(-d // width)
    smem = 4 * _obs_panels_smem_floats(mp, rp, nbp, width, rows)
    resident = min(OP_SM_SMEM // (smem + 1024), by_threads) * sms
    k = min(-(-panels // resident) if resident > 0 else panels, OP_WALK // width)
    return ObsPanelsPlan(width=width, panels=panels, grid=_round_up(-(-panels // k), OP_CLUSTER),
                         cluster=OP_CLUSTER, block=OP_THREADS, rows=rows, smem=smem)


def obs_panels_attributes(d: int, mp: int, rp: int, nbp: int, device):
    """``(plan, registers, local bytes, clusters)`` of H8 at these shapes as
    the C entry makes them (csl_obs_panels_plan) on the CUDA ``device``:
    the clusters are those of the plan the card holds at once; launches
    nothing."""
    lib = cuda.library()
    fn = lib.csl_obs_panels_plan
    fn.argtypes = [cuda.I] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * OP_PLAN)()
    with torch.cuda.device(device):
        err = fn(d, mp, rp, nbp, out)
    if err != 0:
        raise RuntimeError(f"obs_panels plan failed: {lib.csl_error_string(err).decode()} ({err})")
    width, panels, grid, cluster, block, rows, smem, regs, local, clusters = out
    return (ObsPanelsPlan(width=width, panels=panels, grid=grid, cluster=cluster, block=block,
                          rows=rows, smem=smem), regs, local, clusters)


def obs_panels(rowc, hvb, si, prows, vtf, x):
    """pht, the updated mean and the NIS of the gated frame: plain version
    for CPU tensors, kernel H8 (one block a column panel, ragged edge
    masked, ``obs_panels_plan``) for CUDA tensors."""
    if cuda.on_cpu(rowc, hvb, si, prows, vtf, x):
        return _obs_panels_reference(rowc, hvb, si, prows, vtf, x)
    mp, nbp = hvb.shape
    rp, d = prows.shape
    if obs_panels_plan(d, mp, rp, nbp) is None:
        raise ValueError(f"obs_panels: MP={mp}, RP={rp}, NBP={nbp} exceed a block")
    if si.data_ptr() % 16:
        raise ValueError("obs_panels: si must be 16-byte aligned (four siv entries a read)")
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


# ------------------------------------------------ H10: the gated frame


def _obs_step_smem_bytes(mp: int, rp: int, nbp: int, unit: int = OS_COLS) -> int:
    """The dynamic shared memory of H10's frame kernel at a unit of ``unit``
    columns (by default the narrowest, which every resident frame takes at
    least): the largest of its phases' needs (csrc/obs_step.cuh
    smem_floats).  The P pass, its second launch, takes H4's ring."""
    pl = unit + 4
    return max(
        _obs_smem_bytes(mp, rp, nbp, OBS_BAND),                           # chain
        _sweep_smem_bytes(mp) + 4 * 2 * mp,                               # sweep, v, siv
        4 * (mp * pl + 8 * mp + mp * nbp + rp * pl + nbp * unit),         # pht units
        4 * (mp * pl + mp * mp + OS_XG * unit + 2 * mp + 16),             # gains, 7 mbarriers
    )


def obs_step_unit(d: int, mp: int, rp: int, nbp: int, sms: int = N_SM) -> int:
    """H10's unit at D = ``d`` on a card of ``sms`` SMs (csrc/obs_step.cuh
    unit_cols): the fewest multiples of OS_COLS columns that cover D in one
    round of the sms - 1 blocks beside the sweep's, at most OS_MAX_UNIT, and
    no more than fit a block's shared memory."""
    groups = -(-_round_up(d, 4) // OS_COLS)
    unit = OS_COLS * min(OS_MAX_UNIT // OS_COLS, max(1, -(-groups // (sms - 1))))
    while (unit > OS_COLS
           and _obs_step_smem_bytes(mp, rp, nbp, unit) + OS_STATIC_BYTES > cuda.MAX_SMEM_BYTES):
        unit -= OS_COLS
    return unit


def _obs_split_fits(d: int, mp: int, rp: int, nbp: int, limit: int) -> bool:
    """H7, H1 and H8 hold a gated frame of these shapes (H4 holds any)."""
    plan = obs_panels_plan(d, mp, rp, nbp)
    return (sweep_fits(mp, limit) and _obs_smem_bytes(mp, rp, nbp) <= limit
            and plan is not None and plan.smem <= limit)


@functools.lru_cache(maxsize=None)
def obs_route(d: int, nz: int, nbp: int, device, schedule: str = "auto") -> str:
    """The route ``frame_update_obs`` takes at D = ``d`` for ``nz``
    measurement slots and ``nbp`` factor rows on ``device``: a function of
    the shapes alone, chosen before any launch:

      "resident"  H10 (a cooperative frame kernel and the P pass), where its
                  phases fit a block (MP <= 224, H1's register limit, and
                  its narrowest unit's shared memory);
      "split"     H7 -> H1 -> H8 -> H4, under ``schedule="split"``, or where
                  only the split fits: MP 226 to 2048 (H7 in bands of one
                  measurement, H1's cooperative sweep, H8's panels), for
                  any NBP the factors give up to 256 sub-steps;
      "plain"     the reference's jnp route (``_frame_update_obs_reference``)
                  where no kernel of the port fits and the reference has no
                  TPU schedule either (``can_fuse_frame``: D not a multiple
                  of 128, or no VMEM tile);
      "unported"  no kernel of the port fits, but the reference has a TPU
                  schedule: the frame raises on the card (the plain route
                  on the CPU).

    D limits none of the port's kernels.  On the CPU a route's plain
    versions run; the shapes decide the route the same way, against the
    card's shared memory."""
    if schedule not in ("auto", "split"):
        raise ValueError(f"obs_route: schedule must be 'auto' or 'split', got {schedule!r}")
    mp, rp = frame_shapes(nz)
    limit = _smem_limit(device)
    if (schedule == "auto" and mp <= MAX_MP and rp <= OS_MAX_RP
            and _obs_step_smem_bytes(mp, rp, nbp) + OS_STATIC_BYTES <= limit):
        return "resident"
    if _obs_split_fits(d, mp, rp, nbp, limit):
        return "split"
    return "unported" if _ref_frame_update_has_kernel(d, nz, nbp) else "plain"


class ObsStepPlan(NamedTuple):
    """H10's two launches and the work of each of its phases."""

    grid: int        # frame kernel blocks: one an SM (a cooperative launch)
    block: int       # its threads a block, in every phase
    smem: int        # its dynamic shared memory a block, the largest phase's
    regs: int        # its registers a thread (cudaFuncGetAttributes)
    local: int       # its local-memory bytes a thread: spills and stack
    bands: int       # phase 1: blocks that form rows of S (one measurement each)
    unit: int        # phases 2 and 3: columns of D a block takes at a time
    units: int       # phases 2 and 3: units of D
    pass_grid: int   # the P pass: blocks, one a tile (32), one an SM (128)
    pass_block: int  # its threads a block
    pass_smem: int   # its shared memory a block
    pass_regs: int   # its registers a thread
    pass_local: int  # its local-memory bytes a thread
    pass_occ: int    # its blocks an SM (the occupancy query)
    tile: int        # the P pass's tile edge, its route (``pass_tile``)
    tiles: int       # the P pass: upper-triangle tiles of P


def obs_step_plan(d: int, mp: int, nbp: int, device) -> ObsStepPlan:
    """The grids, blocks and shared memory of H10's two launches at D =
    ``d``, MP = ``mp`` (RP the largest for that MP) and NBP = ``nbp`` on the
    CUDA ``device``, their registers, and each phase's work; launches
    nothing."""
    rp = _round_up(3 + mp, 8)
    lib = cuda.library()
    fn = lib.csl_obs_step_plan
    fn.argtypes = [cuda.I] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * OS_PLAN)()
    with torch.cuda.device(device):
        err = fn(d, mp, rp, nbp, out)
    if err != 0:
        raise RuntimeError(f"obs_step plan failed: {lib.csl_error_string(err).decode()} ({err})")
    (grid, block, smem, regs, local, unit, pass_grid, pass_block, pass_smem, pass_regs, pass_local,
     pass_occ, tile, tiles) = out
    return ObsStepPlan(grid=grid, block=block, smem=smem, regs=regs, local=local,
                       bands=mp // OBS_BAND, unit=unit, units=-(-_round_up(d, 4) // unit),
                       pass_grid=pass_grid, pass_block=pass_block, pass_smem=pass_smem,
                       pass_regs=pass_regs, pass_local=pass_local, pass_occ=pass_occ, tile=tile,
                       tiles=tiles)


def _obs_step_scratch_floats(mp: int, nbp: int, ldg: int) -> int:
    """H10's scratch: S, S^-1, rowc, hvb, siv and the strips G, MG
    (NBP + MP, ldg)."""
    return 2 * mp * mp + 9 * mp + mp * nbp + 2 * (nbp + mp) * ldg


def _frame_update_obs_resident_reference(p, x, oi: ObsInputs, bmat, vtf) -> FrameUpdateObs:
    """Plain version of H10: the one-dispatch body's algebra on the packed
    inputs: the chain (as H7), the sweep, pht, siv, xn and the NIS (as H8),
    then P + G^T MG with G = [vtf; pht], MG = [B vtf; -S^-1 pht]."""
    s, rowc, hvb = _obs_chain_reference(oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    si = sweep_si_reference(s, oi.nblk)
    pht, xn, nis = _obs_panels_reference(rowc, hvb, si, oi.prows, vtf, x)
    gmat = torch.cat([vtf, pht])
    mg = torch.cat([bmat @ vtf, -(si @ pht)])
    return FrameUpdateObs(p=rank_update_vbt_reference(p, gmat, mg), x=xn, nis=nis[0])


def _obs_step_h10(p, x, slots, capacity: int, zr, zb, mask, r_cov, bmat, vtf,
                  stamps=None) -> FrameUpdateObs:
    """Launch H10 on CUDA tensors (``frame_update_obs``'s resident route):
    the frame kernel, then the P pass.  ``stamps``, a (grid + pass_grid,
    OS_STAMPS) int64 CUDA tensor (``obs_step_plan``), takes the frame
    kernel's blocks' %globaltimer (ns) at their phase boundaries in rows
    0 .. grid - 1: the start, the chain done, past barrier 1, block 0's
    sweep or another block's pht units done, block 0's siv and NIS done
    (beside the gains), past barrier 2, the gains done, block 0's SM
    clock64 at the sweep's start and end, then the first unit's S^-1
    staged, its MG stored and its siv formed; and each P-pass block's start
    (past its wait for the frame kernel) and end in the rows after them.
    None records nothing."""
    d, nz, nbp = p.shape[0], slots.shape[0], bmat.shape[0]
    mp, rp = frame_shapes(nz)
    cuda.check(p, "p", (d, d))
    cuda.check(x, "x", (d,))
    cuda.check(r_cov, "r_cov", (2, 2))
    cuda.check(bmat, "bmat", (nbp, nbp))
    cuda.check(vtf, "vtf", (nbp, d))
    strides = (
        cuda.vector_stride(slots, "slots", nz, torch.int64),
        cuda.vector_stride(zr, "zr", nz),
        cuda.vector_stride(zb, "zb", nz),
        cuda.vector_stride(mask, "mask", nz, torch.bool),
    )
    dev, f32 = p.device, torch.float32
    ldg = _round_up(d, 4)
    p_out = torch.empty_like(p)
    xn = torch.empty((d,), dtype=f32, device=dev)
    nis = torch.empty((1,), dtype=f32, device=dev)
    scratch = torch.empty((_obs_step_scratch_floats(mp, nbp, ldg),), dtype=f32, device=dev)
    if stamps is not None:
        plan = obs_step_plan(d, mp, nbp, dev)
        cuda.check(stamps, "stamps", (plan.grid + plan.pass_grid, OS_STAMPS), torch.int64)
    _count_pass_route(p, p_out)
    OBS_STEP(
        dev, *(cuda.ptr(t) for t in (p, x, slots, zr, zb, mask, r_cov, bmat, vtf, p_out, xn, nis,
                                     scratch)),
        None if stamps is None else cuda.ptr(stamps),
        *strides, d, nz, int(capacity), mp, rp, nbp, ldg,
    )
    return FrameUpdateObs(p=p_out, x=xn, nis=nis[0])


def frame_update_obs(p, x, slots, capacity: int, zr, zb, mask, r_cov, bmat, vtf,
                     *, plain: bool = False, schedule: str = "auto") -> FrameUpdateObs:
    """The gated observation frame against the frame factors: observe,
    measurement chain, mean update and the one P pass
    P + vtf^T B vtf - pht^T S^-1 pht.

    Args mirror the reference, except that the frame takes its raw map
    slots ``slots`` (NZ,) int64 and the table's ``capacity`` in place of
    the gathered rows [0, 1, 2, 3 + 2 s, 4 + 2 s, ...] (``frame_rows``, the
    slots clamped to [0, capacity - 1]): H10 forms the rows in its launch.
    ``p`` (D, D) is the frame-start covariance; ``x`` (D,) the post-factor
    mean; ``zr``/``zb``/``mask`` (NZ,) the measurement buffer (strided
    views allowed); ``bmat`` (NBP, NBP) and ``vtf`` (NBP, D) the factors
    (ops.factor_kernel).

    The route is ``obs_route``'s, decided once: H10 by default, the split
    H7 -> H1 -> H8 -> H4 under ``schedule="split"`` (a test hook) or past
    MP 224, the plain route where neither the port nor the reference has a
    kernel; a frame the reference runs on a TPU kernel and no kernel of the
    port holds raises on the card.  CPU tensors, or ``plain=True`` on any
    device, run the route's plain PyTorch versions.  Returns
    ``FrameUpdateObs(p, x, nis)`` with the updated mean; P is not modified
    in place.
    """
    nz, nbp = zr.shape[0], bmat.shape[0]
    tensors = (p, x, slots, zr, zb, mask, r_cov, bmat, vtf)
    route = obs_route(p.shape[0], nz, nbp, p.device, schedule)
    if route == "resident" and not (plain or cuda.on_cpu(*tensors)):
        return _obs_step_h10(p, x, slots, capacity, zr, zb, mask, r_cov, bmat, vtf)
    rows = frame_rows(slots, capacity)
    if _past_the_kernels(route, "frame_update_obs", plain, *tensors):
        mp, rp = frame_shapes(nz)
        nr = rows.shape[0]
        zin, rsc, _ = _pack_meas(zr, zb, mask, r_cov, mp // 2)
        return _frame_update_obs_reference(p, x, F.pad(rows, (0, rp - nr), value=-1),
                                           F.pad(p[rows], (0, 0, 0, rp - nr)), zin, rsc, bmat,
                                           vtf, mp, rp)
    oi = obs_inputs(p, x, rows, zr, zb, mask, r_cov, vtf)
    if route == "resident":
        return _frame_update_obs_resident_reference(p, x, oi, bmat, vtf)
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
