"""The least time one H100 could take for a frame, from its shapes alone.

Frozen from the port's measurement arithmetic (``chip_smoke.py``'s
``bound``, ``h9_work``, ``h10_work``), which ``PERF.md`` section 6's kernel
table uses: each input byte read once and each output byte written once,
fp32 operations counted from the frame's shapes, and the larger of
bytes / peak bandwidth and operations / peak fp32 rate.

The peaks are NVIDIA's data sheet for the H100 SXM at 700 W: 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores (the port keeps
TF32 off, so its products run there).
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
F32, I64, BOOL = 4, 8, 1


def round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def frame_shapes(nz: int) -> tuple[int, int]:
    """(MP, RP): the kernels' padded measurement rows and gathered rows for
    NZ measurement slots."""
    return round_up(2 * nz, 32), round_up(3 + 2 * nz, 8)


def factor_rows(s_steps: int, heading: bool) -> int:
    """NBP: the gated frame's factor rows, 2 + 2S (+ S with the heading
    observation) padded to 8."""
    return round_up(2 + 2 * s_steps + (s_steps if heading else 0), 8)


def bound_us(n_bytes: float, flops: float) -> tuple[float, str]:
    """(least microseconds, "bytes" or "operations", whichever bounds)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e6
    t_ops = flops / PEAK_FP32_FLOPS * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def h9_work(d: int, mp: int, rp: int, nblk: int) -> float:
    """The known frame's operations: the chain, the sweep over ``nblk``
    pivots, P H^T and the mean, -S^-1 P H^T, the P pass's upper triangle at
    r = MP + 8, and its add."""
    return (20.0 * mp * rp + 10.0 * mp * mp + 4.0 * mp * mp * nblk + 22.0 * mp * d
            + 2.0 * mp * mp + 2.0 * mp * mp * d + d * (d + 1.0) * (mp + 8) + d * d)


def h10_work(d: int, mp: int, rp: int, nbp: int, nblk: int) -> float:
    """The gated frame update's operations: the chain, the sweep, P H^T
    through the factors and the mean, -S^-1 P H^T and B vtf, the P pass's
    upper triangle at r = NBP + MP, and its add."""
    chain = (10.0 * mp * nbp + 2.0 * mp * nbp * nbp + 10.0 * mp * rp + 2.0 * mp * nbp * rp
             + 10.0 * mp * mp)
    return (chain + 4.0 * mp * mp * nblk + (12.0 + 2.0 * nbp) * mp * d + 2.0 * mp * mp * d
            + 2.0 * nbp * nbp * d + d * (d + 1.0) * (nbp + mp) + d * d)


def h9_bytes(d: int, nz: int, s_steps: int) -> int:
    """The known frame's inputs (P, x, the slots, S controls, headings and
    flags, Q, the measurements and their mask, R) and outputs (P, x, the
    pose trace, the NIS)."""
    ins = (d * d + d) * F32 + nz * I64 + 3 * s_steps * F32 + s_steps * BOOL + 4 * F32 \
        + 2 * nz * F32 + nz * BOOL + 4 * F32
    outs = (d * d + d) * F32 + 3 * s_steps * F32 + F32
    return ins + outs


def h10_bytes(d: int, nz: int, nbp: int) -> int:
    """The gated frame update's inputs (P, x, the slots, the measurements
    and their mask, R, B, the factor strip vtf) and outputs (P, x, NIS)."""
    ins = (d * d + d) * F32 + nz * I64 + 2 * nz * F32 + nz * BOOL + 4 * F32 \
        + nbp * nbp * F32 + nbp * d * F32
    outs = (d * d + d) * F32 + F32
    return ins + outs


def frame_bound_us(path: str, d: int, nz: int, s_steps: int, heading: bool) -> tuple[float, str]:
    """The least time of one frame's update on ``path`` ("known": the
    known frame, H9's work; "gated": the gated update, H10's work), from
    its state width D, NZ measurement slots and S sub-steps."""
    mp, rp = frame_shapes(nz)
    nblk = mp // 2
    if path == "known":
        return bound_us(h9_bytes(d, nz, s_steps), h9_work(d, mp, rp, nblk))
    if path == "gated":
        nbp = factor_rows(s_steps, heading)
        return bound_us(h10_bytes(d, nz, nbp), h10_work(d, mp, rp, nbp, nblk))
    raise ValueError(f"no frame bound for path {path!r}")
