"""Mahalanobis nearest-neighbour gating scores (port of
conan_slam_tpu.ops.gating_kernel.gating_scores).

Kernel H6 (``csrc/gating_scores.cu``) scores every measurement against
every map slot and reduces to the best slot, one block per measurement.
Its plain version, ``_gating_scores_reference``, is the same algebra as
(NZ, K) tensors: the per-slot 2x2 innovation covariance expanded to scalar
products of the pose block, the slot's pose-feature strip and its diagonal
block (the TPU kernel's ``_gating_kernel``), then a masked argmin.
"""

from __future__ import annotations

import torch

from conan_slam_tpu_torch.core.geometry import wrap_angle
from conan_slam_tpu_torch.ops import cuda

GATING_SCORES = cuda.CudaKernel(
    "gating_scores", "csl_gating_scores",
    [cuda.P] * 11 + [cuda.I, cuda.I, cuda.F],
    source="conan_slam_tpu_torch/csrc/gating_scores.cu",
    replaces="conan_slam_tpu/ops/gating_kernel.py:170 (gating_scores -> pallas_call :222)",
)
BIG = 3.0e38       # "no slot passed the gate": callers read found = best_nd < 1e38


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
    int32, min_nis (NZ,) f32)``.  The plain version for CPU tensors, kernel
    H6 for CUDA tensors.
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
                                     best_nd, best_j, min_nis)),
        nz, k, float(gate_reject),
    )
    return best_nd, best_j, min_nis
