"""The frame's one O(D^2) pass: P + G^T (M G) (port of
conan_slam_tpu.ops.pallas_update.rank_update_t, fp32 only).

Kernel H4 (``csrc/rank_update.cu``) computes only the upper triangle of
square output tiles and mirrors each tile into the lower triangle, so it
relies on Vt^T VBt being symmetric, which holds for every caller: M =
blockdiag(-S^-1, K4) in ``frame_step``, blockdiag(B, -S^-1) in
``frame_update_obs`` and blockdiag(M_A, M_B) in ``frame_step_pair``
(tests/test_torch_rank_symmetry.py holds each to it).  Its output's lower
triangle therefore differs from the plain version's by fp32 rounding only,
and P comes out exactly symmetric whenever it goes in exactly symmetric.
Persistent blocks walk the list of triangle tiles (edge 32 or 128, chosen
from D; ``rank_update_plan``), stream k-chunks of the two (r, D) row strips
through a cp.async ring in shared memory, and run fp32 FMA (TF32 stays
off).  It writes out of place: the frame's G holds a row of P
(``_frame_gm``), so an in-place pass would read a strip that it is
overwriting.  The small M G = (r, r) x (r, D) product stays
``torch.matmul``, as the reference computed it outside its kernel;
``rank_update_vbt`` takes it from a caller that has it already (the frame
pair).
"""

from __future__ import annotations

import ctypes

import torch

from conan_slam_tpu_torch.ops import cuda

RANK_UPDATE = cuda.CudaKernel(
    "rank_update", "csl_rank_update",
    [cuda.P, cuda.P, cuda.P, cuda.P, cuda.I, cuda.I],
    source="conan_slam_tpu_torch/csrc/rank_update.cu",
    replaces="conan_slam_tpu/ops/pallas_update.py:50 (rank_update_t -> pallas_call :164, :191)",
)


def rank_update_t_reference(p: torch.Tensor, vt: torch.Tensor,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain version of H4: P + Vt^T (B Vt) for row strips Vt (r, D)."""
    return p + vt.T @ (b @ vt)


def rank_update_vbt_reference(p: torch.Tensor, vt: torch.Tensor,
                              vbt: torch.Tensor) -> torch.Tensor:
    """Plain version of H4 with VBt = B Vt given: P + Vt^T VBt."""
    return p + vt.T @ vbt


def rank_update_t2_reference(p, vt1, vbt1, vt2, vbt2):
    """P + vt1^T vbt1 + vt2^T vbt2 (row strips (r_i, D))."""
    return p + vt1.T @ vbt1 + vt2.T @ vbt2


def rank_update_t(p: torch.Tensor, vt: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """P + Vt^T (B Vt): the plain version for CPU tensors, kernel H4 for
    CUDA tensors (a new output; P is not modified).

    B must be symmetric: the kernel computes the upper triangle of
    Vt^T (B Vt) and mirrors it."""
    if cuda.on_cpu(p, vt, b):
        return rank_update_t_reference(p, vt, b)
    r = vt.shape[0]
    cuda.check(b, "b", (r, r))
    return rank_update_vbt(p, vt, torch.matmul(b, vt))


def rank_update_vbt(p: torch.Tensor, vt: torch.Tensor, vbt: torch.Tensor) -> torch.Tensor:
    """P + Vt^T VBt for a caller that already holds VBt = B Vt (r, D): the
    plain version for CPU tensors, kernel H4 for CUDA tensors.

    Vt^T VBt must be symmetric (B symmetric): the kernel computes its upper
    triangle and mirrors it."""
    if cuda.on_cpu(p, vt, vbt):
        return rank_update_vbt_reference(p, vt, vbt)
    d = p.shape[0]
    r = vt.shape[0]
    cuda.check(p, "p", (d, d))
    cuda.check(vt, "vt", (r, d))
    cuda.check(vbt, "vbt", (r, d))
    out = torch.empty_like(p)
    RANK_UPDATE(p.device, cuda.ptr(p), cuda.ptr(vt), cuda.ptr(vbt), cuda.ptr(out), d, r)
    return out


def rank_update_plan(d: int, device: torch.device) -> tuple[int, int]:
    """``(tile edge, grid)`` that H4 takes at D = ``d`` on the CUDA
    ``device``; launches nothing."""
    lib = cuda.library()
    fn = lib.csl_rank_update_plan
    fn.argtypes = [cuda.I, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    tile, grid = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = fn(d, ctypes.byref(tile), ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"rank_update plan failed: {lib.csl_error_string(err).decode()} ({err})")
    return tile.value, grid.value


def rank_update_attributes(d: int, device: torch.device) -> tuple[int, int]:
    """``(registers, local-memory bytes)`` a thread of the variant H4 takes
    at D = ``d`` on the CUDA ``device``; launches nothing."""
    return cuda.attributes("csl_rank_update_attributes", device, d)
