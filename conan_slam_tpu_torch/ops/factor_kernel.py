"""The gated frame's factors and its association in one launch (port of
conan_slam_tpu.ops.factor_kernel.frame_factors_fused, with the reference's
gating kernel and the host work between them).

The frame's S predict + heading sub-steps compound into one symmetric rank
update P0 + vtf^T B vtf (filters.ekf.fastframe).  Kernel H15
(``csrc/factor_gate.cu``, ``factor_gate``) writes the post-frame mean, the
pose trace, the row-major factor strip vtf (NBP, D) and B (NBP, NBP),
zero-padded from NB = 2 + 3S to NBP = round_up(NB, 8), and in the same
launch scores every measurement against every map slot under the virtual
covariance P0 + vtf^T B vtf and writes the association result.  Every
block reruns the coefficient recursion that H2 runs too
(``csrc/coeff.cuh``, to 256 sub-steps), packing the raw controls itself.

H5's entry (``frame_factors_fused``) launches H15's strip blocks alone.
The plain versions are ``fastframe.frame_factors`` padded the same way
(``_frame_factors_reference``) and, for H15, that followed by H6's route
in its plain version (``gating_kernel.gate_state``: the host fold of the
virtual correction, H6's plain version, associate_gated's mask rule;
``_factor_gate_reference``).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, NamedTuple

import torch
import torch.nn.functional as F

from conan_slam_tpu_torch.ops import cuda
from conan_slam_tpu_torch.ops.frame_kernel import MAX_STEPS, _past_the_kernels
from conan_slam_tpu_torch.ops.gating_kernel import gate_state, gate_tile, reduction_scratch

if TYPE_CHECKING:   # filters.ekf imports this module
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

_CONTROLS = [cuda.P] * 4 + [cuda.L] * 4   # vns, swans, phis, actives and their strides
FACTOR_STRIP = cuda.CudaKernel(
    "factor_strip", "csl_factor_strip",
    _CONTROLS + [cuda.P] * 8 + [cuda.I, cuda.I, cuda.I, cuda.F, cuda.F, cuda.F, cuda.I],
    source="conan_slam_tpu_torch/csrc/factor_gate.cu",
    replaces="conan_slam_tpu/ops/factor_kernel.py:266 (frame_factors_fused -> pallas_call :316)",
)
FACTOR_GATE = cuda.CudaKernel(
    "factor_gate", "csl_factor_gate",
    _CONTROLS + [cuda.P, cuda.P, cuda.P, cuda.L] + [cuda.P] * 16 + [cuda.I] * 6
    + [cuda.F] * 3 + [cuda.I, cuda.F, cuda.F],
    source="conan_slam_tpu_torch/csrc/factor_gate.cu",
    replaces="conan_slam_tpu/ops/factor_kernel.py:266 (frame_factors_fused -> pallas_call :316)"
             " and conan_slam_tpu/ops/gating_kernel.py:170 (gating_scores -> pallas_call :222)",
)
FG_STAMPS = 5      # H15's phase stamps a block (csrc/factor_gate.cu fg_stamp)
FG_THREADS = 256   # threads a block; a strip block writes as many columns


class FactorGate(NamedTuple):
    x: torch.Tensor           # (D,) post-frame mean
    pose_trace: torch.Tensor  # (S, 3)
    vtf: torch.Tensor         # (NBP, D) the factor strip
    bmat: torch.Tensor        # (NBP, NBP)
    best_nd: torch.Tensor     # (NZ,) f32, 3e38 where no slot passes the gate
    best_j: torch.Tensor      # (NZ,) int32, -1 where none passes
    min_nis: torch.Tensor     # (NZ,) f32
    known_mask: torch.Tensor  # (NZ,) bool
    slots: torch.Tensor       # (NZ,) int64
    new_mask: torch.Tensor    # (NZ,) bool


def factor_shapes(s_steps: int, use_heading: bool) -> tuple[int, int]:
    """(NB, NBP): factor columns of an S-step frame and their padding to 8."""
    nb = 2 + 2 * s_steps + (s_steps if use_heading else 0)
    return nb, ((nb + 7) // 8) * 8


def factor_gate_grid(d: int, k: int, device) -> tuple[int, int, int]:
    """H15's ``(strip blocks, gating blocks, slots a gating block)``."""
    tile = gate_tile(k, device)
    return -(-d // FG_THREADS), max(1, -(-k // tile)), tile


def _frame_factors_reference(state: EKFState, vns, swans, phi_meas, active, q_cov,
                             wheel_base, dt, sigma_heading, use_heading: bool):
    """Plain version of H5: fastframe.frame_factors with the strip
    transposed and zero-padded to NBP rows."""
    from conan_slam_tpu_torch.filters.ekf.fastframe import frame_factors

    new_state, pose_trace, vmat, bmat = frame_factors(
        state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
        sigma_heading, use_heading,
    )
    nb, nbp = factor_shapes(vns.shape[0], use_heading)
    vtf = F.pad(vmat.T, (0, 0, 0, nbp - nb)).contiguous()   # row-major, as H5 writes it
    return new_state, pose_trace, vtf, F.pad(bmat, (0, nbp - nb, 0, nbp - nb))


def _control_args(vns, swans, phi_meas, active, q_cov, s_steps: int) -> list:
    """The raw controls as H5 and H15 read them: four pointers, four
    strides (the kernels pack them and chol(Q) themselves), Q's pointer."""
    cuda.check(q_cov, "q_cov", (2, 2))
    strides = [cuda.vector_stride(vns, "vns", s_steps),
               cuda.vector_stride(swans, "swans", s_steps),
               cuda.vector_stride(phi_meas, "phi_meas", s_steps),
               cuda.vector_stride(active, "active", s_steps, torch.bool)]
    return [*(cuda.ptr(t) for t in (vns, swans, phi_meas, active)), *strides, cuda.ptr(q_cov)]


def frame_factors_fused(state: EKFState, vns, swans, phi_meas, active, q_cov,
                        wheel_base, dt, sigma_heading, use_heading: bool,
                        *, plain: bool = False, stamps=None):
    """The frame factors without materialising P: returns ``(state with the
    post-frame mean and the frame-start P, pose_trace (S, 3), vtf (NBP, D),
    bmat (NBP, NBP))``, the frame covariance being P + vtf^T bmat vtf.

    The plain version for CPU tensors (or with ``plain=True``), H5's entry
    of H15 for CUDA tensors up to MAX_STEPS = 256 sub-steps.  Past that
    bound the plain version runs on the card where the reference, too, runs
    its jnp route (D not a multiple of 128), and the frame raises where the
    reference runs its TPU kernel (``_past_the_kernels``).  ``stamps``, a
    (strip blocks, FG_STAMPS) int64 tensor, takes each block's %globaltimer
    at its start, after the recursion and after its columns.
    """
    tensors = (state.x, state.p, vns, swans, phi_meas, active, q_cov)
    s_steps, d = vns.shape[0], state.x.shape[0]
    route = "kernel" if s_steps <= MAX_STEPS else "unported" if d % 128 == 0 else "plain"
    if plain or cuda.on_cpu(*tensors) or _past_the_kernels(route, "frame_factors_fused", plain,
                                                             *tensors):
        return _frame_factors_reference(state, vns, swans, phi_meas, active, q_cov,
                                        wheel_base, dt, sigma_heading, use_heading)
    _, nbp = factor_shapes(s_steps, use_heading)
    controls = _control_args(vns, swans, phi_meas, active, q_cov, s_steps)
    p2 = state.p[2]               # row 2 of the symmetric P: contiguous
    cuda.check(state.x, "x", (d,))
    cuda.check(p2, "p[2]", (d,))
    if stamps is not None:
        cuda.check(stamps, "stamps", (-(-d // FG_THREADS), FG_STAMPS), torch.int64)
    dev, f32 = state.x.device, torch.float32
    xf = torch.empty((d,), dtype=f32, device=dev)
    pt = torch.empty((s_steps, 3), dtype=f32, device=dev)
    vtf = torch.empty((nbp, d), dtype=f32, device=dev)
    bm = torch.empty((nbp, nbp), dtype=f32, device=dev)
    FACTOR_STRIP(
        dev, *controls, *(cuda.ptr(t) for t in (state.x, p2, xf, pt, vtf, bm)),
        None if stamps is None else cuda.ptr(stamps),
        s_steps, nbp, d, float(wheel_base), float(dt), float(sigma_heading),
        int(bool(use_heading)),
    )
    return state._replace(x=xf), pt, vtf, bm


def _factor_gate_reference(state: EKFState, vns, swans, phi_meas, active, q_cov, wheel_base,
                           dt, sigma_heading, use_heading: bool, z, zmask, r_cov,
                           gate_reject: float, gate_augment: float) -> FactorGate:
    """Plain version of H15: H5's plain version, then H6's route in its
    plain version on the virtual covariance (gating_kernel.gate_state)."""
    st1, pt, vtf, bmat = _frame_factors_reference(state, vns, swans, phi_meas, active, q_cov,
                                                  wheel_base, dt, sigma_heading, use_heading)
    return FactorGate(st1.x, pt, vtf, bmat, *gate_state(st1, z, zmask, r_cov, gate_reject,
                                                        gate_augment, vtf.T, bmat, plain=True))


def factor_gate(state: EKFState, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
                sigma_heading, use_heading: bool, z, zmask, r_cov, gate_reject: float,
                gate_augment: float, *, plain: bool = False, stamps=None) -> FactorGate:
    """The gated frame's factors and its association in one launch (H15).

    ``frame_factors_fused``'s arguments, then the frame's measurements ``z``
    (NZ, 2) and their validity ``zmask`` (NZ,), ``r_cov`` (2, 2) and the
    two gates.  Every measurement is scored against the active slots under
    the virtual covariance P + vtf^T bmat vtf at the post-frame mean, as
    ``associate_gated`` scores it; returns the factors, ``gating_scores``'s
    three results and associate_gated's masks and slots (``FactorGate``).

    The plain version for CPU tensors (or with ``plain=True``), kernel H15
    for CUDA tensors; it holds MAX_STEPS = 256 sub-steps and raises past
    them (associate.factor_and_associate_gated routes such frames).
    ``stamps``, a (grid, FG_STAMPS) int64 tensor (``factor_gate_grid``:
    strip blocks, then gating blocks), takes each block's %globaltimer at
    its start, after the recursion, after its columns or its slot table,
    after its scores, and in the last gating block after the result.
    """
    tensors = (state.x, state.p, state.n_active, vns, swans, phi_meas, active, q_cov, z, zmask,
               r_cov)
    if plain or cuda.on_cpu(*tensors):
        return _factor_gate_reference(state, vns, swans, phi_meas, active, q_cov, wheel_base, dt,
                                      sigma_heading, use_heading, z, zmask, r_cov, gate_reject,
                                      gate_augment)
    s_steps, d, k, nz = vns.shape[0], state.x.shape[0], state.capacity, z.shape[0]
    if s_steps > MAX_STEPS:
        raise ValueError(f"factor_gate: {s_steps} sub-steps, past the kernel's {MAX_STEPS}")
    _, nbp = factor_shapes(s_steps, use_heading)
    controls = _control_args(vns, swans, phi_meas, active, q_cov, s_steps)
    cuda.check(state.x, "x", (d,))
    cuda.check(state.p, "p", (d, d))
    cuda.check(state.n_active, "n_active", (), torch.int64)
    cuda.check(z, "z", (nz, 2))
    cuda.check(zmask, "zmask", (nz,), torch.bool)
    cuda.check(r_cov, "r_cov", (2, 2))
    dev, f32 = state.x.device, torch.float32
    n_strip, n_gate, tile = factor_gate_grid(d, k, dev)
    if stamps is not None:
        cuda.check(stamps, "stamps", (n_strip + n_gate, FG_STAMPS), torch.int64)
    out = FactorGate(
        x=torch.empty((d,), dtype=f32, device=dev),
        pose_trace=torch.empty((s_steps, 3), dtype=f32, device=dev),
        vtf=torch.empty((nbp, d), dtype=f32, device=dev),
        bmat=torch.empty((nbp, nbp), dtype=f32, device=dev),
        best_nd=torch.empty((nz,), dtype=f32, device=dev),
        best_j=torch.empty((nz,), dtype=torch.int32, device=dev),
        min_nis=torch.empty((nz,), dtype=f32, device=dev),
        known_mask=torch.empty((nz,), dtype=torch.bool, device=dev),
        slots=torch.empty((nz,), dtype=torch.int64, device=dev),
        new_mask=torch.empty((nz,), dtype=torch.bool, device=dev),
    )
    FACTOR_GATE(
        dev, *controls, cuda.ptr(state.x), cuda.ptr(state.p), d, cuda.ptr(state.n_active),
        *(cuda.ptr(t) for t in (z, zmask, r_cov, *out, reduction_scratch(dev, nz))),
        None if stamps is None else cuda.ptr(stamps),
        s_steps, nbp, d, nz, k, tile, float(wheel_base), float(dt), float(sigma_heading),
        int(bool(use_heading)), float(gate_reject), float(gate_augment),
    )
    return out


def factor_gate_attributes(device) -> dict[str, tuple[int, int]]:
    """``(registers, local-memory bytes)`` a thread of H15's kernel and of
    H5's and H6's entries (cudaFuncGetAttributes); launches nothing."""
    return {name: cuda.attributes("csl_factor_gate_attributes", device, which)
            for which, name in enumerate(("factor_gate_kernel", "factor_strip_kernel",
                                          "gating_scores_kernel"))}
