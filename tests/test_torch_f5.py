"""F5 (ROADMAP Queue 3): the fp32 sweep's rounding on ill-conditioned S,
over more frames of its conditioning.

The known frame without the heading update over 33 sub-steps with 64
measurements (tests/test_torch_obsstep.py's S 33 frame, on other seeds):
S's Jacobi-scaled condition number kappa is 4,000-7,000 there, and every
fp32 route of the sweep inverse scatters around a float64 witness (the
port's oracle: fastframe factors, dense products, a Cholesky inverse).
Each frame holds, with its reason:
  * x: every fp32 route (the port's plain version, H9's on the CPU; the
    reference's resident kernel in interpret mode and its jnp route)
    within 8 kappa u |dx| of the witness, u = 2^-24 and |dx| the frame's
    largest mean correction: the first-order forward error of an fp32
    solve, with a small constant.  A route that missed or doubled a term
    would lie orders of magnitude outside it.
  * P: the port no further than twice the farther of the reference's two
    routes, plus 1e-4 (the card tests' rule for H9 on these frames).
  * the pose trace: the reference kernel's to a few fp32 ulps of ~55 m.
Each route's distance, as a multiple of kappa u |dx|, goes to the test's
output and to ROADMAP.md's F5 entry; F5 closes only when the port is no
further from the witness than the reference's kernel on every frame.
"""

import jax
import numpy as np
import pytest
import torch

from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu_torch.ops import frame_kernel as tfk
from test_torch_obsstep import KEYS, TAIL, _frame_step_args, _jax_args, _problem, _witness_distances

torch.set_num_threads(2)

NZ, S = 64, 33


@pytest.mark.parametrize("seed", [107, 108, 109])
def test_s33_frame_without_heading_within_the_conditioning_bound(seed):
    prob = _problem(seed, NZ, S)
    d = prob["p"].shape[0]
    assert tfk.frame_route(d, NZ, "cpu", S) == "resident" and jfk.can_fuse_frame_step(d, NZ)
    jargs = _jax_args(prob)
    routes = {
        "reference kernel": jfk.frame_step(*jargs, *TAIL, False, interpret=True),
        "reference jnp route": jax.jit(jfk.frame_step, static_argnums=(12, 13, 14, 15))(
            *jargs, *TAIL, False),
        "port": tfk.frame_step(*_frame_step_args(prob), *TAIL, False),
    }
    t = {k: torch.as_tensor(prob[k]) for k in KEYS}
    t = {k: v.double() if v.dtype == torch.float32 else v for k, v in t.items()}
    mp, rp = tfk.frame_shapes(NZ)
    zin, rsc, _ = tfk._pack_meas(t["zr"], t["zb"], t["mask"], t["r"], mp // 2)
    wit = tfk._frame_step_reference(*(t[k] for k in KEYS[:8]), zin, rsc, mp, rp, *TAIL, False)
    fi = tfk.frame_inputs(*(t[k] for k in KEYS))
    sm = tfk._frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp,
                                    *TAIL, False).s[:2 * int(fi.nblk), :2 * int(fi.nblk)]
    scale = torch.rsqrt(torch.diagonal(sm))
    kappa = float(torch.linalg.cond(sm * scale[:, None] * scale[None, :]))
    dx = float((wit.x - t["x"]).abs().max())
    unit = kappa * 2.0**-24 * dx
    e = _witness_distances(routes, wit)
    print(f"F5 seed {seed}: kappa {kappa:.0f}, |dx| {dx:.3e}; x from the witness in kappa u |dx|: "
          + ", ".join(f"{k} {ex / unit:.2f} ({ex:.3e})" for k, (ex, _) in e.items())
          + "; P: " + ", ".join(f"{k} {ep:.3e}" for k, (_, ep) in e.items()))
    assert 1000.0 < kappa < 20000.0          # the S 33 frame's conditioning
    assert all(ex <= 8.0 * unit for ex, _ in e.values()), (8.0 * unit, e)
    far = max(e["reference kernel"][1], e["reference jnp route"][1])
    assert e["port"][1] <= 2.0 * far + 1e-4, e
    np.testing.assert_allclose(routes["port"].pose_trace.numpy(),
                               np.asarray(routes["reference kernel"].pose_trace), rtol=1e-5,
                               atol=1e-4)
