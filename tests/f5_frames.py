"""F5 (ROADMAP Queue 3): tests/test_torch_f5.py's measurement on more frames
of its conditioning, as a table.

The known frame without the heading update over 33 sub-steps with 64
measurements (tests/test_torch_obsstep.py ``_problem(seed, 64, 33)``), on
the CPU: each route's largest distance from the float64 witness in x, as
a multiple of kappa u |dx| (u = 2^-24, |dx| the frame's largest mean
correction), and in P, for the reference's resident kernel in interpret
mode, its jnp route and the port's plain version.

    python tests/f5_frames.py 110 111 ... 117

One row per seed (~30 s each): ``| seed | kappa | reference kernel |
reference jnp route | port |``, then the largest and the median of each
route's x column.  Not part of tier 1 (the reference kernel in interpret
mode takes most of the time).
"""

from __future__ import annotations

import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NZ, S = 64, 33
ROUTES = ("reference kernel", "reference jnp route", "port")


def measure(seed: int) -> dict:
    """``{"kappa", route: (x in kappa u |dx|, |P - P64|)}`` of the seed's frame."""
    import jax
    import torch

    from conan_slam_tpu.ops import frame_kernel as jfk
    from conan_slam_tpu_torch.ops import frame_kernel as tfk
    from test_torch_obsstep import (
        KEYS,
        TAIL,
        _frame_step_args,
        _jax_args,
        _problem,
        _witness_distances,
    )

    prob = _problem(seed, NZ, S)
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
    unit = kappa * 2.0**-24 * float((wit.x - t["x"]).abs().max())
    e = _witness_distances(routes, wit)
    return {"kappa": kappa, **{k: (ex / unit, ep) for k, (ex, ep) in e.items()}}


def main(argv: list[str]) -> None:
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=1")
    sys.path.insert(0, os.path.dirname(HERE))
    sys.path.insert(0, HERE)
    import jax
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    cols = {k: [] for k in ROUTES}
    print("| Frame (seed) | kappa | " + " | ".join(ROUTES) + " |")
    for seed in (int(a) for a in argv):
        t0 = time.perf_counter()
        m = measure(seed)
        for k in ROUTES:
            cols[k].append(m[k][0])
        print(f"| {seed} | {m['kappa']:,.0f} | "
              + " | ".join(f"{m[k][0]:.2f} (P {m[k][1]:.2e})" for k in ROUTES)
              + f" |  ({time.perf_counter() - t0:.1f} s)", flush=True)
    for name, f in (("largest", max), ("median", statistics.median)):
        print(f"{name}: " + ", ".join(f"{k} {f(v):.2f}" for k, v in cols.items()))


if __name__ == "__main__":
    main(sys.argv[1:])
