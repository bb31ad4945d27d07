"""The kernels of the port-side probes (conan_slam_tpu_torch.benchmarks):
the counterparts of the reference's probe kernels (the T9 sites of
benchmarks/probe_sweep.py, probe_rankpass.py and probe_mosaic.py), each
beside its plain PyTorch version.

  H11 ``sweep_probe`` (csrc/sweep_probe.cu): the sweep variants unroll2,
      unroll4 (H1's register sweep, 2 / 4 pivots a loop body) and wide4
      (the paired sweep: one publish a pair of pivots) on a pre-scaled S,
      through a ring of mbarrier stages instead of a block barrier a step
      (``sweep_probe_plan``).  Its v0 is H1 (ops.spd_inverse.sweep_si).
  H12 ``stream_copy`` (csrc/stream_copy.cu): out = in, the byte floor of a
      pass over P.
  H13 ``probe_dots`` (csrc/probe_mosaic.cu): the three transposed
      contractions of the gated frame's strips, a cluster of CTAs a column
      panel (``probe_dots_plan``).
  H14 ``probe_observe`` (csrc/probe_mosaic.cu): the known frame's and the
      gated frame's observe device code alone, a CTA a band of output rows
      (``probe_observe_plan``).
  H4's probe entry ``rank_update_tile`` (csrc/rank_update.cu): H4 with its
      tile edge and grid forced, and with no P read.

As everywhere in the port, a wrapper takes the plain version for CPU
tensors, launches the kernel for CUDA tensors, and raises on anything else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

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
# csrc/sweep_probe.cu's geometry: the ring's stages (SP_RING), the warps of
# one block (SP_WARPS), and the CTAs of wide4's cluster past MP 64
# (SP_WIDE4_CLUSTER); everything else runs one block.
SWEEP_PROBE_RING = 8
SWEEP_PROBE_WARPS = 16
SWEEP_PROBE_WIDE4_CLUSTER = 8
SP_PLAN = 10                 # values csl_sweep_probe_plan reports


class SweepProbePlan(NamedTuple):
    """H11's geometry: one cluster of ``cluster`` CTAs (the grid); CTA c
    holds the ``cta_rows`` rows c cta_rows .. of the W = 32 q columns, warp
    w of it the ``rows`` rows from c cta_rows + w rows; the steps pass
    through a ring of ``ring`` stages of (g, h) in each CTA."""

    q: int          # 32-column blocks: 2 (MP <= 64) or 4
    cluster: int    # CTAs a cluster, one an SM (the grid)
    ring: int       # stages of the ring
    rows: int       # rows a warp
    cta_rows: int   # rows a CTA
    block: int      # threads a CTA
    smem: int       # shared memory a CTA, bytes


def sweep_probe_plan(mp: int, variant: str) -> SweepProbePlan:
    """H11's plan at MP = ``mp`` (even, at most 128) for ``variant``
    (csrc/sweep_probe.cu make_plan): one block of SWEEP_PROBE_WARPS warps
    splitting the 32 q rows, except wide4 past MP 64, which runs a cluster
    of SWEEP_PROBE_WIDE4_CLUSTER CTAs of 4 rows a warp (whole pairs)."""
    if variant not in SWEEP_VARIANTS:
        raise ValueError(f"sweep_probe: variant must be one of {SWEEP_VARIANTS}, got {variant!r}")
    if mp % 2 or not 0 < mp <= SWEEP_PROBE_MAX_MP:
        raise ValueError(f"sweep_probe: S must be even-sized and at most {SWEEP_PROBE_MAX_MP}, "
                         f"got {mp}")
    q = 2 if mp <= 64 else 4
    c = SWEEP_PROBE_WIDE4_CLUSTER if variant == "wide4" and q == 4 else 1
    rows = 32 * q // SWEEP_PROBE_WARPS if c == 1 else 4
    cta_rows = 32 * q // c
    entry = 16 if variant == "wide4" else 8      # bytes of g or h an entry: float4 / float2
    return SweepProbePlan(q=q, cluster=c, ring=SWEEP_PROBE_RING, rows=rows, cta_rows=cta_rows,
                          block=32 * (cta_rows // rows),
                          smem=SWEEP_PROBE_RING * (2 * 32 * q * entry + 16))


def sweep_probe_attributes(mp: int, variant: str, device):
    """``(plan, registers, local bytes)`` of H11 at ``mp`` for ``variant`` as
    the C entry makes them (csl_sweep_probe_plan) on the CUDA ``device``;
    launches nothing."""
    lib = cuda.library()
    fn = lib.csl_sweep_probe_plan
    fn.argtypes = [cuda.I, cuda.I, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * SP_PLAN)()
    with torch.cuda.device(device):
        err = fn(mp, SWEEP_VARIANTS.index(variant), out)
    if err != 0:
        raise RuntimeError(f"sweep_probe plan failed: {lib.csl_error_string(err).decode()} ({err})")
    q, cluster, ring, rows, cta_rows, block, smem, regs, local, _grid = out
    return (SweepProbePlan(q=q, cluster=cluster, ring=ring, rows=rows, cta_rows=cta_rows,
                           block=block, smem=smem), regs, local)


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

PROBE_DOTS_MAX_MP = 128      # csrc/probe_mosaic.cu PD_MAX_MP: 4 CTAs x 16 row pairs
PD_W = 16                    # columns a panel
PD_G = 4                     # CTAs a cluster: one panel
PD_THREADS = 128             # a CTA: 8 column pairs x 16 row pairs
PD_PLAN = 10                 # values csl_probe_dots_plan reports


class ProbeDotsPlan(NamedTuple):
    """H13's geometry: a cluster of ``cluster`` CTAs a panel of ``width``
    columns of D; CTA g of it holds rows g rows .. g rows + rows - 1 of MP
    (those inside MP)."""

    width: int      # columns of D a panel
    panels: int     # panels of D
    grid: int       # CTAs launched: whole clusters
    cluster: int    # CTAs a panel
    block: int      # threads a CTA
    rows: int       # rows of MP a CTA
    smem: int       # dynamic shared memory a CTA, bytes


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def probe_dots_plan(d: int, mp: int, rp: int) -> ProbeDotsPlan | None:
    """H13's plan at D = ``d``, MP = ``mp``, RP = ``rp`` (csrc/probe_mosaic.cu
    make_plan), or None where the shapes are out of its range or a CTA's
    shared memory would not fit: panels of 16 columns, 4 CTAs a panel, each
    MP / 4 rows (rounded up to even), and in shared memory the (RP, 16)
    panel of prows, its rows of hc and si (row strides padded to 4 mod 8
    floats), the (MP, 16) panel of phtt, siv and 8 x 16 partial sums, each
    count rounded up to 4."""
    if d <= 0 or not 0 < mp <= PROBE_DOTS_MAX_MP or rp <= 0:
        return None
    rows = _round_up(-(-mp // PD_G), 2)
    rp4, mp4 = _round_up(rp, 4), _round_up(mp, 4)
    pad = lambda n4: _round_up(n4, 8) + 4     # noqa: E731
    floats = (rp4 * PD_W + rows * pad(rp4) + rows * pad(mp4) + mp4 * PD_W + mp4 + 8 * PD_W)
    if 4 * floats > cuda.MAX_SMEM_BYTES:
        return None
    panels = -(-d // PD_W)
    return ProbeDotsPlan(width=PD_W, panels=panels, grid=panels * PD_G, cluster=PD_G,
                         block=PD_THREADS, rows=rows, smem=4 * floats)


def probe_dots_attributes(d: int, mp: int, rp: int, device):
    """``(plan, registers, local bytes, clusters)`` of H13 at these shapes as
    the C entry makes them (csl_probe_dots_plan) on the CUDA ``device``: the
    clusters are those the card holds at once; launches nothing."""
    lib = cuda.library()
    fn = lib.csl_probe_dots_plan
    fn.argtypes = [cuda.I] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * PD_PLAN)()
    with torch.cuda.device(device):
        err = fn(d, mp, rp, out)
    if err != 0:
        raise RuntimeError(f"probe_dots plan failed: {lib.csl_error_string(err).decode()} ({err})")
    width, panels, grid, cluster, block, rows, smem, regs, local, clusters = out
    return (ProbeDotsPlan(width=width, panels=panels, grid=grid, cluster=cluster, block=block,
                          rows=rows, smem=smem), regs, local, clusters)


def probe_dots_reference(prows, hc, si, siv):
    """Plain version of H13: phtt = prows^T hc^T (D, MP), sipht = si phtt^T
    (MP, D), sivpht = siv phtt^T (1, D)."""
    phtt = prows.T @ hc.T
    return phtt, si @ phtt.T, siv @ phtt.T


def probe_dots(prows, hc, si, siv):
    """The three contractions of the probe: the plain version for CPU
    tensors, kernel H13 (``probe_dots_plan``) for CUDA tensors.  prows
    (RP, D), hc (MP, RP), si (MP, MP), siv (1, MP)."""
    if cuda.on_cpu(prows, hc, si, siv):
        return probe_dots_reference(prows, hc, si, siv)
    rp, d = prows.shape
    mp = hc.shape[0]
    if probe_dots_plan(d, mp, rp) is None:
        raise ValueError(f"probe_dots: MP must be at most {PROBE_DOTS_MAX_MP} and a CTA's "
                         f"operands fit its shared memory, got D={d}, MP={mp}, RP={rp}")
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
PO_ROWS = 2                  # csrc/probe_mosaic.cu: output rows a CTA (whole measurements)
PO_THREADS = 128             # threads a CTA
PO_PLAN = 6                  # values csl_probe_observe_plan reports


class ProbeObservePlan(NamedTuple):
    """H14's geometry: CTA b writes output rows b rows .. b rows + rows - 1
    of Hc, R and v (those inside MP) and forms their measurements."""

    rows: int       # output rows a CTA
    grid: int       # CTAs
    block: int      # threads a CTA
    smem: int       # static shared memory a CTA, bytes


def probe_observe_plan(mp: int, rp: int) -> ProbeObservePlan | None:
    """H14's plan at MP = ``mp``, RP = ``rp`` (csrc/probe_mosaic.cu
    observe_grid), or None for the shapes its entry refuses: MP odd or not
    positive, RP < 3, or past the parent's one-block limit (its shared
    memory, 2 RP + 1.5 MP + 8 MP + 32 floats each rounded up to 4, within
    48 KB).  In shared memory a CTA holds its gathered mean and P e2 rows
    (3 + rows each), its zin (3, rows / 2), its compact Hc (8, rows), the
    frame scalars (32) and R's entries (4), each count rounded up to 4."""
    if mp <= 0 or mp % 2 or rp < 3:
        return None
    parent = 2 * _round_up(rp, 4) + _round_up(3 * (mp // 2), 4) + 8 * mp + 32
    if 4 * parent > 48 * 1024:
        return None
    floats = (2 * _round_up(3 + PO_ROWS, 4) + _round_up(3 * (PO_ROWS // 2), 4) + 8 * PO_ROWS
              + 32 + 4)
    return ProbeObservePlan(rows=PO_ROWS, grid=-(-mp // PO_ROWS), block=PO_THREADS,
                            smem=4 * floats)


def _observe_entry(symbol: str, argtypes: list):
    lib = cuda.library()
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def probe_observe_attributes(mp: int, rp: int, device):
    """``(plan, registers, local bytes)`` of H14 at these shapes as the C
    entry makes them (csl_probe_observe_plan) on the CUDA ``device``;
    launches nothing."""
    lib, fn = _observe_entry("csl_probe_observe_plan",
                             [cuda.I] * 2 + [ctypes.POINTER(ctypes.c_int)])
    out = (ctypes.c_int * PO_PLAN)()
    with torch.cuda.device(device):
        err = fn(mp, rp, out)
    if err != 0:
        raise RuntimeError(f"probe_observe plan failed: {lib.csl_error_string(err).decode()} "
                           f"({err})")
    rows, grid, block, smem, regs, local = out
    return ProbeObservePlan(rows=rows, grid=grid, block=block, smem=smem), regs, local


def probe_observe_reference(xrows, zin, rsc, mp: int, rp: int):
    """Plain version of H14 (either path): the port's observe
    (``ops.frame_kernel._observe_reference``) as the dense Hc (MP, RP),
    R (MP, MP) and v (MP,)."""
    hcc, rmat, v = _observe_reference(xrows, zin, rsc, mp, rp)
    return _dense_hc(hcc, rp), rmat, v


def _observe_args(xrows, zin, rsc, mp: int, rp: int):
    """The outputs and the C arguments of H14 at these inputs but the path,
    checked."""
    if mp % 2 or mp <= 0 or rp < 3:
        raise ValueError(f"probe_observe: MP must be even and RP at least 3, got {mp}, {rp}")
    cuda.check(xrows, "xrows", (rp,))
    cuda.check(zin, "zin", (3, mp // 2))
    cuda.check(rsc, "rsc", (4,))
    dev, f32 = xrows.device, torch.float32
    outs = (torch.empty((mp, rp), dtype=f32, device=dev),
            torch.empty((mp, mp), dtype=f32, device=dev), torch.empty((mp,), dtype=f32, device=dev))
    return outs, [cuda.ptr(t) for t in (xrows, zin, rsc, *outs)] + [mp, rp]


def probe_observe(xrows, zin, rsc, mp: int, rp: int, path: str = "gated"):
    """The observe alone on the gathered mean ``xrows`` (RP,), ``zin``
    (3, MP / 2) [range, bearing, mask] and R's entries ``rsc`` (4,): the
    plain version for CPU tensors, kernel H14 (``probe_observe_plan``) for
    CUDA tensors, which runs the known frame's device code
    (``path="known"``: csl_chain_observe, of H2 and H9) or the gated
    frame's (``"gated"``: csl_obs_observe, of H7 and H10).  Returns
    (Hc (MP, RP), R (MP, MP), v (MP,))."""
    if path not in OBSERVE_PATHS:
        raise ValueError(f"probe_observe: path must be one of {OBSERVE_PATHS}, got {path!r}")
    if cuda.on_cpu(xrows, zin, rsc):
        return probe_observe_reference(xrows, zin, rsc, mp, rp)
    outs, args = _observe_args(xrows, zin, rsc, mp, rp)
    PROBE_OBSERVE(xrows.device, *args, OBSERVE_PATHS.index(path))
    return outs


def probe_observe_floor(xrows, zin, rsc, mp: int, rp: int):
    """The card's floor for H14's launch: an empty kernel at its grid,
    block and arguments (csl_probe_observe_floor), on CUDA tensors only.
    Writes nothing (its outputs are left as allocated) and counts no
    launch of H14."""
    outs, args = _observe_args(xrows, zin, rsc, mp, rp)
    lib, fn = _observe_entry("csl_probe_observe_floor", PROBE_OBSERVE.argtypes)
    with torch.cuda.device(xrows.device):
        err = fn(*args, 0, cuda.P(torch.cuda.current_stream(xrows.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe_observe floor failed to launch: "
                           f"{lib.csl_error_string(err).decode()} ({err})")
    return outs
