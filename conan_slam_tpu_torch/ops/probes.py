"""The kernels of the port-side probes (conan_slam_tpu_torch.benchmarks):
the counterparts of the reference's probe kernels (the T9 sites of
benchmarks/probe_sweep.py, probe_rankpass.py and probe_mosaic.py), each
beside its plain PyTorch version.

  H11 ``sweep_probe`` (csrc/sweep_probe.cu): the sweep variants unroll2,
      unroll4 (H1's register sweep, 2 / 4 pivots a loop body) and wide4
      (the paired sweep: one barrier a pair of pivots) on a pre-scaled S.
      Its v0 is H1 (ops.spd_inverse.sweep_si).
  H12 ``stream_copy`` (csrc/stream_copy.cu): out = in, the byte floor of a
      pass over P.
  H13 ``probe_dots`` (csrc/probe_mosaic.cu): the three transposed
      contractions of the gated frame's strips.
  H14 ``probe_observe`` (csrc/probe_mosaic.cu): the known frame's and the
      gated frame's observe device code alone.
  H4's probe entry ``rank_update_tile`` (csrc/rank_update.cu): H4 with its
      tile edge and grid forced, and with no P read.

As everywhere in the port, a wrapper takes the plain version for CPU
tensors, launches the kernel for CUDA tensors, and raises on anything else.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops.frame_kernel import _dense_hc, _observe_reference

SWEEP_PROBE = cuda.CudaKernel(
    "sweep_probe", "csl_sweep_probe",
    [cuda.P, cuda.P, cuda.I, cuda.I, cuda.I],
    source="conan_slam_tpu_torch/csrc/sweep_probe.cu",
    replaces="benchmarks/probe_sweep.py:192 (make -> unrolled_sweep :58, paired_sweep :98)",
)
STREAM_COPY = cuda.CudaKernel(
    "stream_copy", "csl_stream_copy",
    [cuda.P, cuda.P, cuda.L],
    source="conan_slam_tpu_torch/csrc/stream_copy.cu",
    replaces="benchmarks/probe_rankpass.py:144 (copy_step)",
)
PROBE_DOTS = cuda.CudaKernel(
    "probe_dots", "csl_probe_dots",
    [cuda.P] * 7 + [cuda.I] * 3,
    source="conan_slam_tpu_torch/csrc/probe_mosaic.cu",
    replaces="benchmarks/probe_mosaic.py:62 (probe_dots)",
)
PROBE_OBSERVE = cuda.CudaKernel(
    "probe_observe", "csl_probe_observe",
    [cuda.P] * 6 + [cuda.I] * 3,
    source="conan_slam_tpu_torch/csrc/probe_mosaic.cu",
    replaces="benchmarks/probe_mosaic.py:122 (probe_observe -> _observe_core)",
)
RANK_UPDATE_TILE = cuda.CudaKernel(
    "rank_update_tile", "csl_rank_update_tile",
    [cuda.P] * 4 + [cuda.I] * 5,
    source="conan_slam_tpu_torch/csrc/rank_update.cu",
    replaces="benchmarks/probe_rankpass.py:105, :121 (make_variant), :163 (mm_step), "
             ":198 (make_stacked)",
)

# ------------------------------------------------------- H11: the sweeps

SWEEP_VARIANTS = ("unroll2", "unroll4", "wide4")
SWEEP_PROBE_MAX_MP = 128     # csrc/sweep_probe.cu MAX_MP


def _pivot_factors(r0, r1, k0, lane):
    """Pivot (k0, k0 + 1) from its rows r0, r1, as the probe's kernels form
    it: the column factors g0, g1 with their unit shifts, and whether the
    pivot is usable."""
    l0, l1 = lane == k0, lane == k0 + 1
    e00, e01, e11 = r0[k0], r0[k0 + 1], r1[k0 + 1]
    det = e00 * e11 - e01 * e01
    ok = (det > 1e-30) & (e00 > 1e-20)
    idet = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    i00, i01, i11 = e11 * idet, -e01 * idet, e00 * idet
    g0 = i00 * r0 + i01 * r1 - torch.where(l0, i00, 0.0) - torch.where(l1, i01, 0.0)
    g1 = i01 * r0 + i11 * r1 - torch.where(l0, i01, 0.0) - torch.where(l1, i11, 0.0)
    return g0, g1, ok


def _diag_piv(lane, k0, ok):
    """The pivot diagonal's constant: 2 at (k0, k0) and (k0 + 1, k0 + 1)
    when the pivot is usable."""
    on = (lane == k0) | (lane == k0 + 1)
    return torch.diag(torch.where(on & ok, 2.0, 0.0))


def _classic_pivot(a, k0, lane):
    """One 2x2 pivot of the sweep (the probe's ``unrolled_sweep`` pivot,
    the algebra of ``sweep_ref_inverse``)."""
    r0, r1 = a[k0], a[k0 + 1]
    g0, g1, ok = _pivot_factors(r0, r1, k0, lane)
    h0 = r0 - (lane == k0).to(a.dtype)
    h1 = r1 - (lane == k0 + 1).to(a.dtype)
    return a - (h0[:, None] * g0 + h1[:, None] * g1 + _diag_piv(lane, k0, ok))


def _paired_pivots(a, k0, lane):
    """Two pivots (k0, k0 + 1) and (k0 + 2, k0 + 3) in one rank-4 update,
    as the probe's ``paired_sweep`` body: pivot A applied to rows k0 + 2,
    k0 + 3 locally, pivot B formed from them, and B's columns the pre-A
    ones with A's rank-2 correction."""
    one = lambda k: (lane == k).to(a.dtype)   # noqa: E731
    r0, r1, r2p, r3p = a[k0], a[k0 + 1], a[k0 + 2], a[k0 + 3]
    g0, g1, ok_a = _pivot_factors(r0, r1, k0, lane)
    h0, h1 = r0 - one(k0), r1 - one(k0 + 1)
    r2 = r2p - r2p[k0] * g0 - r2p[k0 + 1] * g1
    r3 = r3p - r3p[k0] * g0 - r3p[k0 + 1] * g1
    g2, g3, ok_b = _pivot_factors(r2, r3, k0 + 2, lane)
    c2 = r2p - h0 * g0[k0 + 2] - h1 * g1[k0 + 2]
    c3 = r3p - h0 * g0[k0 + 3] - h1 * g1[k0 + 3]
    h2, h3 = c2 - one(k0 + 2), c3 - one(k0 + 3)
    piv = _diag_piv(lane, k0, ok_a) + _diag_piv(lane, k0 + 2, ok_b)
    return a - (h0[:, None] * g0 + h1[:, None] * g1 + h2[:, None] * g2 + h3[:, None] * g3
                + piv)


def sweep_probe_reference(s: torch.Tensor, nblk: int, variant: str) -> torch.Tensor:
    """Plain version of H11: -A after sweeping the first ``nblk`` 2x2 pivot
    blocks of the pre-scaled ``s`` by ``variant``'s algebra: unroll2 and
    unroll4 the classic pivot (the unrolling is a loop schedule, not
    arithmetic), wide4 pairs of pivots and, for an odd ``nblk``, one
    classic pivot last (the reference probe leaves it unswept: ROADMAP R6)."""
    if variant not in SWEEP_VARIANTS:
        raise ValueError(f"sweep_probe: variant must be one of {SWEEP_VARIANTS}, got {variant!r}")
    mp = s.shape[0]
    nb = max(0, min(int(nblk), mp // 2))
    lane = torch.arange(mp, device=s.device)
    a = s
    if variant == "wide4":
        for q in range(nb // 2):
            a = _paired_pivots(a, 4 * q, lane)
        if nb % 2:
            a = _classic_pivot(a, 2 * (nb - 1), lane)
    else:
        for k in range(nb):
            a = _classic_pivot(a, 2 * k, lane)
    return -a


def sweep_probe(s: torch.Tensor, nblk: int, variant: str) -> torch.Tensor:
    """The sweep ``variant`` over the first ``nblk`` pivot blocks of the
    pre-scaled S (even size, at most 128): the plain version for CPU
    tensors, kernel H11 for CUDA tensors."""
    if cuda.on_cpu(s):
        return sweep_probe_reference(s, nblk, variant)
    if variant not in SWEEP_VARIANTS:
        raise ValueError(f"sweep_probe: variant must be one of {SWEEP_VARIANTS}, got {variant!r}")
    mp = s.shape[0]
    if mp % 2 or not 0 < mp <= SWEEP_PROBE_MAX_MP:
        raise ValueError(f"sweep_probe: S must be even-sized and at most {SWEEP_PROBE_MAX_MP}, "
                         f"got {mp}")
    cuda.check(s, "s", (mp, mp))
    out = torch.empty_like(s)
    SWEEP_PROBE(s.device, cuda.ptr(s), cuda.ptr(out), mp, int(nblk),
                SWEEP_VARIANTS.index(variant))
    return out


# -------------------------------------------------- H12: the byte floor


def stream_copy_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of H12: a copy."""
    return x.clone()


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """out = x (a new tensor): the plain version for a CPU tensor, kernel
    H12 for a CUDA one (fp32, contiguous)."""
    if cuda.on_cpu(x):
        return stream_copy_reference(x)
    cuda.check(x, "x", tuple(x.shape))
    out = torch.empty_like(x)
    STREAM_COPY(x.device, cuda.ptr(x), cuda.ptr(out), x.numel())
    return out


# ------------------------------------------- H4's probe entry: the plan forced

RANK_TILES = (32, 64, 128)


def rank_update_tile_reference(p, vt: torch.Tensor, vbt: torch.Tensor) -> torch.Tensor:
    """Plain version of H4's probe entry: P + Vt^T VBt, or Vt^T VBt alone
    when ``p`` is None."""
    prod = vt.T @ vbt
    return prod if p is None else p + prod


def rank_update_tile(p, vt: torch.Tensor, vbt: torch.Tensor, tile: int,
                     grid: int = 0) -> torch.Tensor:
    """P + Vt^T VBt (or, with ``p`` None, Vt^T VBt without reading any P)
    by H4's tile pass with its tile edge forced to ``tile`` (32, 64, 128)
    and ``grid`` blocks (0: one a tile, not persistent blocks): the plain
    version for CPU tensors, H4's probe entry for CUDA tensors.

    As H4, Vt^T VBt must be symmetric: the upper triangle is formed and
    mirrored.  D must be a multiple of 4."""
    tensors = (vt, vbt) if p is None else (p, vt, vbt)
    if cuda.on_cpu(*tensors):
        return rank_update_tile_reference(p, vt, vbt)
    if tile not in RANK_TILES:
        raise ValueError(f"rank_update_tile: tile must be one of {RANK_TILES}, got {tile}")
    r, d = vt.shape
    if d % 4:
        raise ValueError(f"rank_update_tile: D must be a multiple of 4, got {d}")
    cuda.check(vt, "vt", (r, d))
    cuda.check(vbt, "vbt", (r, d))
    if p is not None:
        cuda.check(p, "p", (d, d))
    out = torch.empty((d, d), dtype=vt.dtype, device=vt.device)
    RANK_UPDATE_TILE(vt.device, None if p is None else cuda.ptr(p), cuda.ptr(vt), cuda.ptr(vbt),
                     cuda.ptr(out), d, r, tile, grid, int(p is not None))
    return out


# ------------------------------------------------------- H13: the dots

PROBE_DOTS_MAX_MP = 128      # csrc/probe_mosaic.cu: 8 row groups x 16 rows a thread


def probe_dots_reference(prows, hc, si, siv):
    """Plain version of H13: phtt = prows^T hc^T (D, MP), sipht = si phtt^T
    (MP, D), sivpht = siv phtt^T (1, D)."""
    phtt = prows.T @ hc.T
    return phtt, si @ phtt.T, siv @ phtt.T


def probe_dots(prows, hc, si, siv):
    """The three contractions of the probe: the plain version for CPU
    tensors, kernel H13 for CUDA tensors.  prows (RP, D), hc (MP, RP),
    si (MP, MP), siv (1, MP)."""
    if cuda.on_cpu(prows, hc, si, siv):
        return probe_dots_reference(prows, hc, si, siv)
    rp, d = prows.shape
    mp = hc.shape[0]
    if mp > PROBE_DOTS_MAX_MP:
        raise ValueError(f"probe_dots: MP must be at most {PROBE_DOTS_MAX_MP}, got {mp}")
    cuda.check(prows, "prows", (rp, d))
    cuda.check(hc, "hc", (mp, rp))
    cuda.check(si, "si", (mp, mp))
    cuda.check(siv, "siv", (1, mp))
    dev, f32 = prows.device, torch.float32
    phtt = torch.empty((d, mp), dtype=f32, device=dev)
    sipht = torch.empty((mp, d), dtype=f32, device=dev)
    sivpht = torch.empty((1, d), dtype=f32, device=dev)
    PROBE_DOTS(dev, *(cuda.ptr(t) for t in (prows, hc, si, siv, phtt, sipht, sivpht)), d, mp, rp)
    return phtt, sipht, sivpht


# ---------------------------------------------------- H14: the observe

OBSERVE_PATHS = ("known", "gated")


def probe_observe_reference(xrows, zin, rsc, mp: int, rp: int):
    """Plain version of H14 (either path): the port's observe
    (``ops.frame_kernel._observe_reference``) as the dense Hc (MP, RP),
    R (MP, MP) and v (MP,)."""
    hcc, rmat, v = _observe_reference(xrows, zin, rsc, mp, rp)
    return _dense_hc(hcc, rp), rmat, v


def probe_observe(xrows, zin, rsc, mp: int, rp: int, path: str = "gated"):
    """The observe alone on the gathered mean ``xrows`` (RP,), ``zin``
    (3, MP / 2) [range, bearing, mask] and R's entries ``rsc`` (4,): the
    plain version for CPU tensors, kernel H14 for CUDA tensors, which runs
    the known frame's device code (``path="known"``: csl_chain_observe, of
    H2 and H9) or the gated frame's (``"gated"``: csl_obs_observe, of H7
    and H10).  Returns (Hc (MP, RP), R (MP, MP), v (MP,))."""
    if path not in OBSERVE_PATHS:
        raise ValueError(f"probe_observe: path must be one of {OBSERVE_PATHS}, got {path!r}")
    if cuda.on_cpu(xrows, zin, rsc):
        return probe_observe_reference(xrows, zin, rsc, mp, rp)
    if mp % 2 or mp <= 0 or rp < 3:
        raise ValueError(f"probe_observe: MP must be even and RP at least 3, got {mp}, {rp}")
    cuda.check(xrows, "xrows", (rp,))
    cuda.check(zin, "zin", (3, mp // 2))
    cuda.check(rsc, "rsc", (4,))
    dev, f32 = xrows.device, torch.float32
    hc = torch.empty((mp, rp), dtype=f32, device=dev)
    rmat = torch.empty((mp, mp), dtype=f32, device=dev)
    v = torch.empty((mp,), dtype=f32, device=dev)
    PROBE_OBSERVE(dev, *(cuda.ptr(t) for t in (xrows, zin, rsc, hc, rmat, v)), mp, rp,
                  OBSERVE_PATHS.index(path))
    return hc, rmat, v
