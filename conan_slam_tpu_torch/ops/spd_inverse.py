"""SPD inverse by the Jacobi-scaled symmetric sweep (port of
conan_slam_tpu.ops.spd_inverse and frame_kernel._sweep_si).

Kernel H1 (``csrc/sweep_inverse.cu``) runs the 2x2-pivot Gauss-Jordan
sweep.  Up to MP 224 one block of 16 warps holds the swept block in
registers (warp w holds 2Q consecutive rows, lane l their columns l + 32 b,
Q = ceil(MP / 32), or fewer columns when the unused slots decouple).  A
pivot is one block barrier: the warp holding the next pivot's rows updates
them first, forms that pivot's factors g and h (two shuffles, no barrier)
and publishes them, while the other warps apply the current one; both
symmetrizations read the transpose through a padded shared tile.  Past
MP 224 (to 2048) it is one cooperative launch: each block holds a band of
A's rows in shared memory (``coop_band``), and a pivot is its two rows
published through device memory and one grid barrier.  On the frame's
path it runs once per frame, between the chain kernel H2 and
the panel kernel H3 (ops.frame_kernel), where the reference ran the sweep
inside its chain kernel.  Its plain versions live here:
``sweep_si_reference`` (the sweep itself, with the ``nblk`` bound) and
``spd_inverse_reference`` (the Cholesky route the reference takes off-TPU).
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.linalg import safe_cholesky, sym
from conan_slam_tpu_torch.ops import cuda

SWEEP_INVERSE = cuda.CudaKernel(
    "sweep_inverse", "csl_sweep_inverse",
    [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I],
    source="conan_slam_tpu_torch/csrc/sweep_inverse.cu",
    replaces="conan_slam_tpu/ops/spd_inverse.py:135 (spd_inverse -> _sweep_pallas :114)",
)


# The largest S one block holds in registers: 7 x 7 elements a thread.
MAX_MP = 224
# The largest S the cooperative sweep takes past MAX_MP, and the blocks it
# spreads A's rows over where their shared memory allows
# (csrc/sweep_inverse.cu COOP_MAX_MP, COOP_BLOCKS).
MAX_MP_COOP = 2048
COOP_BLOCKS = 32


def coop_band(mp: int) -> int:
    """The cooperative sweep's rows a block (csrc/sweep_inverse.cu
    coop_band): an even share over COOP_BLOCKS blocks, or fewer where a
    block's shared memory holds fewer."""
    want = 2 * -(-mp // (2 * COOP_BLOCKS))
    fit = ((cuda.MAX_SMEM_BYTES // 4 - 5 * mp) // mp) & ~1
    return min(want, fit)


def _sweep_smem_bytes(mp: int) -> int:
    """A block's shared memory: up to MAX_MP the padded tile, the scale and
    two buffers of the pivots' g and h; past it the cooperative sweep's
    rows, scale, pivot rows and factors."""
    if mp > MAX_MP:
        return 4 * (coop_band(mp) + 5) * mp
    return 4 * (mp * (mp + 1) + mp + 8 * 32 * -(-mp // 32))


def sweep_fits(mp: int, limit: int = cuda.MAX_SMEM_BYTES) -> bool:
    """Whether H1 takes an S of size ``mp`` (even, at most MAX_MP_COOP)
    with ``limit`` bytes of shared memory a block."""
    return mp % 2 == 0 and 0 < mp <= MAX_MP_COOP and _sweep_smem_bytes(mp) <= limit


def _sweep(a: torch.Tensor, nblk) -> torch.Tensor:
    """In-place symmetric Gauss-Jordan on a scaled SPD matrix, 2x2 pivots,
    as the reference's ``sweep_ref_inverse`` (one rank-2 update per pivot
    with shifted factors).  Pivot blocks ``k >= nblk`` are left unswept
    (they come out as -E, not E^-1); ``nblk`` may be a device tensor."""
    mp = a.shape[0]
    idx = torch.arange(mp, device=a.device)
    for k in range(mp // 2):
        k0 = 2 * k
        r0, r1 = a[k0], a[k0 + 1]
        e00, e01, e11 = r0[k0], r0[k0 + 1], r1[k0 + 1]
        det = e00 * e11 - e01 * e01
        ok = (det > 1e-30) & (e00 > 1e-20)
        idet = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
        i00, i01, i11 = e11 * idet, -e01 * idet, e00 * idet
        l0 = idx == k0
        l1 = idx == k0 + 1
        g0 = i00 * r0 + i01 * r1 - torch.where(l0, i00, 0.0) - torch.where(l1, i01, 0.0)
        g1 = i01 * r0 + i11 * r1 - torch.where(l0, i01, 0.0) - torch.where(l1, i11, 0.0)
        h0 = r0 - l0.to(a.dtype)
        h1 = r1 - l1.to(a.dtype)
        piv = torch.diag(torch.where(l0 | l1, torch.where(ok, 2.0, 0.0), 0.0))
        upd = a - (h0[:, None] * g0[None, :] + h1[:, None] * g1[None, :] + piv)
        a = upd if nblk is None else torch.where(k < nblk, upd, a)
    return -a


def sweep_si_reference(s: torch.Tensor, nblk=None) -> torch.Tensor:
    """Plain version of H1: S^-1 of sym(S) by the Jacobi-scaled sweep over
    the first ``nblk`` pivot blocks (all if None), symmetrized again after,
    zero if anything is non-finite.

    Both symmetrizations are load-bearing: the sweep reads pivot columns as
    rows, so an asymmetric S would give an S^-1 whose asymmetry feeds back
    into P with gain (the reference's divergence at bench frame ~1582).
    """
    s = sym(s)
    dsc = torch.rsqrt(torch.clamp(torch.diagonal(s), min=1e-30))
    a = s * dsc[:, None] * dsc[None, :]
    si = _sweep(a, None if nblk is None else nblk.reshape(()))
    si = sym(si * dsc[:, None] * dsc[None, :])
    return torch.where(torch.isfinite(si).all(), si, torch.zeros_like(si))


def sweep_si(s: torch.Tensor, nblk: torch.Tensor) -> torch.Tensor:
    """S^-1 by the sweep over the first ``nblk`` (int32 (1,) tensor) pivot
    blocks: the plain version for CPU tensors, kernel H1 for CUDA tensors."""
    if cuda.on_cpu(s, nblk):
        return sweep_si_reference(s, nblk)
    mp = s.shape[0]
    if not sweep_fits(mp):
        raise ValueError(f"sweep_inverse: S must be even-sized and at most {MAX_MP_COOP}, "
                         f"got {mp}")
    cuda.check(s, "s", (mp, mp))
    cuda.check(nblk, "nblk", (1,), torch.int32)
    out = torch.empty_like(s)
    # Past MAX_MP: the published pivot rows (two buffers) and a flag a block.
    scratch = torch.empty((4 * mp + 256,), dtype=s.dtype, device=s.device) if mp > MAX_MP else None
    SWEEP_INVERSE(s.device, cuda.ptr(s), cuda.ptr(nblk), cuda.ptr(out),
                  None if scratch is None else cuda.ptr(scratch), mp)
    return out


def sweep_inverse_attributes(mp: int, device: torch.device) -> tuple[int, int]:
    """``(registers, local-memory bytes)`` a thread of H1's register sweep
    for MP = ``mp`` (at most MAX_MP) on the CUDA ``device``; launches
    nothing."""
    return cuda.attributes("csl_sweep_inverse_attributes", device, mp)


def spd_inverse_reference(s: torch.Tensor) -> torch.Tensor:
    """Plain SPD inverse: the reference's off-TPU Cholesky route with the
    same Jacobi scaling and the same zero-on-failure guard."""
    m = s.shape[0]
    s = sym(s)
    dsc = torch.rsqrt(torch.clamp(torch.diagonal(s), min=1e-30))
    shat = s * dsc[:, None] * dsc[None, :]
    chol = safe_cholesky(shat)
    eye = torch.eye(m, dtype=s.dtype, device=s.device)
    linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    si = (linv.T @ linv) * dsc[:, None] * dsc[None, :]
    return torch.where(torch.isfinite(si).all(), sym(si), torch.zeros_like(si))


def spd_inverse(s: torch.Tensor) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix: the Cholesky route
    for CPU tensors, the full sweep of kernel H1 for CUDA tensors (an odd
    size is padded with one decoupled unit pivot)."""
    if cuda.on_cpu(s):
        return spd_inverse_reference(s)
    m = s.shape[0]
    mp = m + (m % 2)
    if mp != m:
        pad = torch.zeros((mp, mp), dtype=s.dtype, device=s.device)
        pad[:m, :m] = s
        pad[m, m] = 1.0
        s = pad
    nblk = torch.full((1,), mp // 2, dtype=torch.int32, device=s.device)
    return sweep_si(s.contiguous(), nblk)[:m, :m]
