"""Kernel microbenchmark (port of benchmarks/bench_kernels.py): H4, the
fused rank update and downdate, against its plain version and one
PyTorch call.

    python -m conan_slam_tpu_torch.benchmarks.bench_kernels [D ...]

At each D (default 1,024, 2,051, 4,096 and 8,192), r = 20 and m = 64:
P' = P + V B V^T - W1 W1^T with the downdate folded into the middle matrix,
[V W1] diag(B, -I) [V W1]^T, as the reference folds it, through
``ops.rank_update.rank_update_t`` (H4 on the card, its plain version on the
CPU).  Three chains of ITERS = 50 applications each, through
``utils.profiling.scan_graph`` (one CUDA graph a block of applications,
the carry held bit for bit to the eager loop's, ``require_replay``):
  h4      - rank_update_t with the fold inside each application;
  plain   - the plain version of the same (rank_update_t_reference);
  addmm   - one torch.addmm(P, G^T, M G) an application, M G formed once.
Reports µs an application and the effective GB/s (P read and written once,
the two strips read), and each chain's one-application max abs error
against the plain version, which must stay within 1e-6 of max |P'| (fp32
summation order).  P is symmetric (a covariance): H4 forms the upper
triangle's tiles and mirrors them, so it needs P and the middle matrix
symmetric, where the reference's fused kernel took a nonsymmetric P too.
The inputs come from numpy seed 0, as the reference's.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import card_line, clock, require_replay
from conan_slam_tpu_torch.ops.rank_update import rank_update_t, rank_update_t_reference
from conan_slam_tpu_torch.utils.profiling import scan_graph

ITERS = 50
BLOCK = 10              # applications a captured graph
DEFAULT = (1024, 2051, 4096, 8192)
RANK, DOWNDATE = 20, 64
REL_TOL = 1e-6          # max abs error against the plain version, of max |P'|


def folded(v, b, w1):
    """[V W1]^T and diag(B, -I): the downdate folded into the middle matrix."""
    r, m = v.shape[1], w1.shape[1]
    vt = torch.cat([v.T, w1.T], dim=0)
    bb = torch.zeros((r + m, r + m), dtype=v.dtype, device=v.device)
    bb[:r, :r] = b
    bb[r:, r:] = -torch.eye(m, dtype=v.dtype, device=v.device)
    return vt, bb


def main(argv=None, device="cuda") -> dict:
    dims = [int(a) for a in argv] if argv else list(DEFAULT)
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    rng = np.random.default_rng(0)
    results = {}
    for d in dims:
        r, m = RANK, DOWNDATE
        a = rng.normal(size=(d, d)).astype(np.float32)
        p = torch.as_tensor((a + a.T) / 2, device=dev)
        v = torch.as_tensor(rng.normal(size=(d, r)).astype(np.float32) * 1e-3, device=dev)
        b = torch.eye(r, dtype=torch.float32, device=dev)
        w1 = torch.as_tensor(rng.normal(size=(d, m)).astype(np.float32) * 1e-3, device=dev)
        vt, bb = folded(v, b, w1)
        gt, mg = vt.T.contiguous(), bb @ vt

        variants = {
            "h4": lambda q: rank_update_t(q, *folded(v, b, w1)),
            "plain": lambda q: rank_update_t_reference(q, *folded(v, b, w1)),
            "addmm": lambda q: torch.addmm(q, gt, mg),
        }
        want = rank_update_t_reference(p, vt, bb)
        scale = float(want.abs().max())
        gb = (2 * d * d * 4 + 2 * d * (r + m) * 4) / 1e9
        row = {}
        for name, fn in variants.items():
            err = float((fn(p) - want).abs().max())
            if err > REL_TOL * scale:
                raise AssertionError(f"D={d} {name}: {err:.3e} off the plain version "
                                     f"(bound {REL_TOL * scale:.3e})")
            res = scan_graph(lambda c, fn=fn: (fn(c[0]),), (p,), ITERS, min(BLOCK, ITERS))
            require_replay(f"D={d} {name}", res)
            us = res.us_per_frame
            print(f"D={d:5d} {name:6s}: {us:9.1f} us/app ({gb / (us * 1e-6):7.1f} GB/s "
                  f"effective; max abs err {err:.2e}; {clock(dev, min(BLOCK, ITERS))}, "
                  f"eager {res.eager_us_per_frame:.1f} us/app)", flush=True)
            row[name] = dict(us=us, eager_us=res.eager_us_per_frame,
                             gb_per_s=gb / (us * 1e-6), max_abs_err=err,
                             launches=res.launches, frames=res.frames)
        row["bound"] = REL_TOL * scale
        results[d] = row
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
