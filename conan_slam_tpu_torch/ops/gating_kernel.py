"""Mahalanobis nearest-neighbour gating scores (port of
conan_slam_tpu.ops.gating_kernel.gating_scores).

H6's entry (``csl_gating_scores``) launches the gating blocks of H15
(``csrc/factor_gate.cu``) alone: each block takes a tile of map slots,
forms each slot's innovation covariance once and scores every measurement
against the tile; the last block to finish reduces the blocks' packed
(nd, slot) minima to the best slot.  The frame loop runs the gating inside
H15 itself (ops.factor_kernel.factor_gate); this entry scores blocks a
caller folded (``gate_state``).  Its plain version, ``_gating_scores_reference``, is the
same algebra as (NZ, K) tensors: the per-slot 2x2 innovation covariance
expanded to scalar products of the pose block, the slot's pose-feature
strip and its diagonal block (the TPU kernel's ``_gating_kernel``), then a
masked argmin.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.ops import cuda

if TYPE_CHECKING:   # filters.ekf imports this module
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

GATING_SCORES = cuda.CudaKernel(
    "gating_scores", "csl_gating_scores",
    [cuda.P] * 12 + [cuda.I, cuda.I, cuda.I, cuda.F],
    source="conan_slam_tpu_torch/csrc/factor_gate.cu",
    replaces="conan_slam_tpu/ops/gating_kernel.py:170 (gating_scores -> pallas_call :222)",
)
BIG = 3.0e38       # "no slot passed the gate": callers read found = best_nd < 1e38
MAX_TILE = 224     # slots a gating block (FG_MAX_TILE: one a thread of warps 1-7)
GATE_WAVES = 2     # gating blocks an SM that the tile aims for

_scratch: dict[tuple[torch.device, int, int], torch.Tensor] = {}   # (device, stream, NZ)


def gate_tile(k: int, device) -> int:
    """Slots a gating block takes: a multiple of 32 up to MAX_TILE, so that
    the gating blocks number about GATE_WAVES an SM (32 slots a block at
    config 2's K, 64 at the 10k shape's on 132 SMs)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = -(-k // (32 * GATE_WAVES * sms))
    return 32 * min(max(per, 1), MAX_TILE // 32)


def reduction_scratch(device, nz: int) -> torch.Tensor:
    """The gating's cross-block scratch for ``nz`` measurements on the
    current stream of ``device``: NZ u64 keys, then NZ u32 minimum NIS, all
    ones, and a u32 arrival counter at 0.  Every launch leaves it so again.

    One buffer a (device, stream, NZ), made by the first launch on that
    stream, so that launches on two streams never share one.  A CUDA graph
    uses the buffer of the stream it was captured on (replay it there); the
    buffer is never made during a capture, where it would come from the
    graph's private pool: launch once on the capturing stream first."""
    dev = torch.device(device)
    key = (dev, torch.cuda.current_stream(dev).cuda_stream, nz)
    buf = _scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"gating scratch for NZ {nz} on the capturing stream does not exist yet: launch "
                "factor_gate or gating_scores once on that stream before capturing")
        buf = torch.full((3 * nz + 2,), -1, dtype=torch.int32, device=dev)
        buf[3 * nz] = 0
        _scratch[key] = buf
    return buf


def _innovation_blocks(state: EKFState, vmat=None, bmat=None):
    """The blocks of P the per-slot innovation covariance reads: the pose
    block pvv (3, 3), the pose-feature strips pvm (K, 3, 2) and the
    diagonal feature blocks pjj (K, 2, 2), with the virtual correction
    P + V B V^T folded in when ``vmat`` (D, r) / ``bmat`` (r, r) are given
    (only those blocks of V B V^T are formed: O(K r) work, not O(D^2)).

    pjj indexes exactly the 4K entries of the diagonal blocks (the
    reference gathers a band of P for the same reason: a reshape of the
    (2K, 2K) map block is quadratic in K)."""
    k = state.capacity
    p = state.p
    pvv = p[:3, :3]
    pvm = p[:3, 3 : 3 + 2 * k].reshape(3, k, 2).permute(1, 0, 2)
    two = torch.arange(2, device=p.device)[:, None]
    rows = 3 + 2 * torch.arange(k, device=p.device)[:, None, None] + two   # (K, 2, 1)
    pjj = p[rows, rows.transpose(1, 2)]          # pjj[j, a, b] = P[3 + 2j + a, 3 + 2j + b]
    if vmat is not None:
        v3 = vmat[:3]                                           # (3, r)
        vm = vmat[3 : 3 + 2 * k].reshape(k, 2, -1)              # (K, 2, r)
        v3b = v3 @ bmat
        pvv = pvv + v3b @ v3.T
        pvm = pvm + torch.einsum("ir,kjr->kij", v3b, vm)
        vmb = torch.einsum("kir,rs->kis", vm, bmat)
        pjj = pjj + torch.einsum("kir,kjr->kij", vmb, vm)
    return pvv, pvm, pjj


def _gating_scores_reference(z, pose, features, active, pvv, pvm, pjj, r_cov,
                             gate_reject: float):
    """Plain version of H6 (``gating_scores``'s arguments and results)."""
    px, py, phi = pose[0], pose[1], pose[2]
    dx = features[:, 0] - px                                 # (K,)
    dy = features[:, 1] - py
    d2 = torch.clamp(dx * dx + dy * dy, min=1e-12)
    dist = torch.sqrt(d2)
    zpb = torch.atan2(dy, dx) - phi
    xd, yd = dx / dist, dy / dist
    xd2, yd2 = dx / d2, dy / d2

    q00, q01, q02 = pvv[0, 0], pvv[0, 1], pvv[0, 2]
    q11, q12, q22 = pvv[1, 1], pvv[1, 2], pvv[2, 2]
    apa = q00 * xd * xd + 2.0 * q01 * xd * yd + q11 * yd * yd
    apb = -xd * (q00 * yd2 - q01 * xd2 - q02) - yd * (q01 * yd2 - q11 * xd2 - q12)
    bpb = (yd2 * (q00 * yd2 - q01 * xd2 - q02) - xd2 * (q01 * yd2 - q11 * xd2 - q12)
           - (q02 * yd2 - q12 * xd2 - q22))
    pvx0, pvx1, pvx2 = pvm[:, 0, 0], pvm[:, 1, 0], pvm[:, 2, 0]
    pvy0, pvy1, pvy2 = pvm[:, 0, 1], pvm[:, 1, 1], pvm[:, 2, 1]
    apx = -xd * pvx0 - yd * pvx1
    apy = -xd * pvy0 - yd * pvy1
    bpx = yd2 * pvx0 - xd2 * pvx1 - pvx2
    bpy = yd2 * pvy0 - xd2 * pvy1 - pvy2
    apc = apx * xd + apy * yd
    ape = -apx * yd2 + apy * xd2
    bpc = bpx * xd + bpy * yd
    bpe = -bpx * yd2 + bpy * xd2
    p00, p01, p11 = pjj[:, 0, 0], 0.5 * (pjj[:, 0, 1] + pjj[:, 1, 0]), pjj[:, 1, 1]
    cjc = xd * (p00 * xd + p01 * yd) + yd * (p01 * xd + p11 * yd)
    cje = -(p00 * xd + p01 * yd) * yd2 + (p01 * xd + p11 * yd) * xd2
    eje = -yd2 * (-p00 * yd2 + p01 * xd2) + xd2 * (-p01 * yd2 + p11 * xd2)

    s00 = apa + 2.0 * apc + cjc + r_cov[0, 0]
    s01 = apb + ape + bpc + cje + r_cov[0, 1]
    s11 = bpb + 2.0 * bpe + eje + r_cov[1, 1]
    det = torch.clamp(s00 * s11 - s01 * s01, min=1e-30)
    idet = 1.0 / det
    i00, i01, i11 = s11 * idet, -s01 * idet, s00 * idet

    vr = z[:, 0:1] - dist                                    # (NZ, K)
    vb = wrap_angle(z[:, 1:2] - zpb)
    nis = i00 * vr * vr + 2.0 * i01 * vr * vb + i11 * vb * vb
    nd = nis + torch.log(det)
    big = torch.full_like(nis, BIG)
    nis_act = torch.where(active, nis, big)
    nd_g = torch.where(active & (nis < gate_reject), nd, big)
    best_nd = nd_g.min(dim=1).values
    found = best_nd < BIG
    k = features.shape[0]
    jidx = torch.arange(k, device=z.device).expand_as(nd_g)
    # The lowest j among the minima (the kernel's tie rule).
    best_j = torch.where(nd_g == best_nd[:, None], jidx, k).min(dim=1).values
    best_j = torch.where(found, best_j, -1).to(torch.int32)
    return best_nd, best_j, nis_act.min(dim=1).values


def gating_scores(z, pose, features, active, pvv, pvm, pjj, r_cov,
                  gate_reject: float):
    """Per measurement: the best slot's nd = nis + log|S_j| among active
    slots whose nis passes ``gate_reject`` (3e38 when none does), that slot
    (lowest j on a tie, -1 when none) and the min nis over active slots.

    Args: ``z`` (NZ, 2) range/bearing; ``pose`` (3,); ``features`` (K, 2)
    slot positions; ``active`` (K,) bool; ``pvv`` (3, 3), ``pvm``
    (K, 3, 2) and ``pjj`` (K, 2, 2) the pose block, pose-feature strips and
    diagonal feature blocks of P (virtual correction folded in by the
    caller); ``r_cov`` (2, 2).  Returns ``(best_nd (NZ,) f32, best_j (NZ,)
    int32, min_nis (NZ,) f32)``.  The plain version for CPU tensors, H6's
    entry of H15 for CUDA tensors.
    """
    if cuda.on_cpu(z, pose, features, active, pvv, pvm, pjj, r_cov):
        return _gating_scores_reference(z, pose, features, active, pvv, pvm, pjj,
                                        r_cov, gate_reject)
    nz, k = z.shape[0], features.shape[0]
    cuda.check(z, "z", (nz, 2))
    cuda.check(pose, "pose", (3,))
    cuda.check(features, "features", (k, 2))
    cuda.check(active, "active", (k,), torch.bool)
    cuda.check(pvv, "pvv", (3, 3))
    cuda.check(pvm, "pvm", (k, 3, 2))
    cuda.check(pjj, "pjj", (k, 2, 2))
    cuda.check(r_cov, "r_cov", (2, 2))
    dev = z.device
    best_nd = torch.empty((nz,), dtype=torch.float32, device=dev)
    best_j = torch.empty((nz,), dtype=torch.int32, device=dev)
    min_nis = torch.empty((nz,), dtype=torch.float32, device=dev)
    GATING_SCORES(
        dev, *(cuda.ptr(t) for t in (z, pose, features, active, pvv, pvm, pjj, r_cov,
                                     best_nd, best_j, min_nis, reduction_scratch(dev, nz))),
        nz, k, gate_tile(k, dev), float(gate_reject),
    )
    return best_nd, best_j, min_nis


def gate_state(state: EKFState, z, zmask, r_cov, gate_reject: float, gate_augment: float,
               vmat=None, bmat=None, *, plain: bool = False):
    """The gating of ``state``'s slots as H6's route runs it: the innovation
    blocks with the virtual correction folded on the host
    (``_innovation_blocks``), the scores (``gating_scores``; its plain
    version with ``plain=True``), then associate_gated's mask rule.
    Returns ``(best_nd, best_j, min_nis, known_mask, slots (int64),
    new_mask)``."""
    pvv, pvm, pjj = _innovation_blocks(state, vmat, bmat)
    score = _gating_scores_reference if plain else gating_scores
    best_nd, best_j, min_nis = score(
        z.contiguous(), state.pose, state.features, state.active_mask,
        pvv.contiguous(), pvm.contiguous(), pjj.contiguous(), r_cov, gate_reject,
    )
    found = best_nd < 1.0e38
    return (best_nd, best_j, min_nis, zmask & found, torch.where(found, best_j.to(torch.int64), 0),
            zmask & ~found & (min_nis > gate_augment))
