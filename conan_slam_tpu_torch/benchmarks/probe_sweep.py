"""The sweep variants of the serial sweep inverse on the card (port of
benchmarks/probe_sweep.py).

  v0      - H1, the port's sweep (ops.spd_inverse.sweep_si) over NBLK pivots
  unroll2 - H11, H1's register sweep with two pivots a loop body
  unroll4 - H11, four pivots a loop body
  wide4   - H11, the paired sweep: two pivots fused into one rank-4 update,
            one block barrier a pair

S is the probe's: rng 0, a a^T + MP I scaled to a unit diagonal.  Gate
first: every variant's swept 2 NBLK x 2 NBLK block against np.linalg.inv
within 1e-4.  Then FRAMES dependent sweeps (S fed back with a zero weight,
as the probe feeds it) through ``scan_graph``: one line a variant,
"<name>: X us/sweep" (graph replays), with the eager loop's time and
torch.linalg.inv_ex's on the whole S beside it.  For an odd NBLK the port
sweeps every pivot; the reference probe drops the last (ROADMAP R6).

Knobs: PS_MP (128), PS_NBLK (40), PS_FRAMES (4000).
Run on the card: python -m conan_slam_tpu_torch.benchmarks.probe_sweep [variants...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import require_replay, call_us, card_line, clock
from conan_slam_tpu_torch.ops.probes import sweep_probe
from conan_slam_tpu_torch.ops.spd_inverse import sweep_si
from conan_slam_tpu_torch.utils.profiling import scan_graph

VARIANTS = ("v0", "unroll2", "unroll4", "wide4")
BLOCK = 100      # sweeps a captured graph


def probe_matrix(mp: int) -> np.ndarray:
    """The probe's S: rng 0, a a^T + MP I, scaled to a unit diagonal."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(mp, mp)).astype(np.float32)
    s = (a @ a.T + mp * np.eye(mp)).astype(np.float32)
    dsc = 1.0 / np.sqrt(np.diag(s))
    return s * dsc[:, None] * dsc[None, :]


def make(variant: str, nblk: int, device: torch.device):
    """One sweep of ``variant`` on S: the swept matrix."""
    if variant == "v0":
        nb = torch.full((1,), nblk, dtype=torch.int32, device=device)
        return lambda s: sweep_si(s, nb)
    return lambda s: sweep_probe(s, nblk, variant)


def main(argv=None, device="cuda") -> dict:
    variants = list(argv or VARIANTS)
    mp = int(os.environ.get("PS_MP", "128"))
    nblk = int(os.environ.get("PS_NBLK", "40"))
    frames = int(os.environ.get("PS_FRAMES", "4000"))
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    s_np = probe_matrix(mp)
    s0 = torch.as_tensor(s_np, device=dev)

    # Correctness gate first (vs numpy inverse on the swept block).
    ref = np.linalg.inv(s_np[: 2 * nblk, : 2 * nblk])
    results = {}
    for name in variants:
        out = make(name, nblk, dev)(s0).cpu().numpy()
        err = float(np.abs(out[: 2 * nblk, : 2 * nblk] - ref).max())
        print(f"{name}: maxerr {err:.2e}", file=sys.stderr, flush=True)
        if not err < 1e-4:
            raise AssertionError(f"{name}: swept block off np.linalg.inv by {err:.2e} >= 1e-4")
        results[name] = {"maxerr": err}

    block = min(BLOCK, frames)
    lib_us = call_us(lambda: torch.linalg.inv_ex(s0), dev, max(1, frames // 10))
    for name in variants:
        fn = make(name, nblk, dev)
        # Feed back so sweeps are dependent, with a zero weight keeping S fixed.
        res = scan_graph(lambda c, fn=fn: (c[0] + 0.0 * fn(c[0])[0, 0],), (s0,), frames, block)
        require_replay(name, res)
        print(f"{name:8s}: {res.us_per_frame:8.2f} us/sweep ({clock(dev, block)}; "
              f"eager {res.eager_us_per_frame:.2f} us/sweep; torch.linalg.inv_ex {lib_us:.2f} us)",
              flush=True)
        results[name].update(us=res.us_per_frame, eager_us=res.eager_us_per_frame,
                             library_us=lib_us, launches=res.launches, frames=res.frames)
    return {"mp": mp, "nblk": nblk, "frames": frames, "variants": results}


if __name__ == "__main__":
    main(sys.argv[1:])
