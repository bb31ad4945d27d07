"""Schedules of the O(D^2) rank pass P + Vt^T B Vt on the card (port of
benchmarks/probe_rankpass.py), fp32 only: the reference's bf16 split tiers
(its mode "split3") are not ported (ROADMAP precision contract).

  v0      - H4 (ops.rank_update.rank_update_t): its own plan, B Vt formed
  tr128   - H4's tile pass with its tile edge forced to 32
  tr256   - ... forced to 64
  grid2d  - ... forced to 128
  arb     - H4 with one tile a block instead of persistent blocks
  accum   - three H4 passes at rank r, one after the other
  stack3  - one H4 pass at rank 3 r (three terms stacked along K)
  stack4  - one H4 pass at rank 2 r (two terms stacked)
  copy    - H12, out = P: the byte floor of a pass
  mmonly  - H4's tiles with no P read: out = Vt^T (B Vt)

Inputs as the probe's: P = I, Vt ~ N(0, 1e-4^2) (rng 0), B = 1e-6 I.  Gate
first: every variant's one step against its plain version.  The update
Vt^T B Vt is ~1e-12, below P's rounding on the diagonal, so the gate holds
the update itself, out - P, within 1e-4 of its largest entry (mmonly: the
product's raw output; copy: the output, bit for bit).  Then FRAMES
dependent passes through ``scan_graph``, the graph's carry bit for bit the
eager loop's: one line a variant, "<name>: X us/pass" (graph replays), with
the eager loop's time and the matching library call's (torch.addmm,
Tensor.copy_, torch.mm) beside it.

Knobs: RP_D (2304), RP_RANK (288), RP_FRAMES (4000).
Run on the card: python -m conan_slam_tpu_torch.benchmarks.probe_rankpass [variants...]
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import call_us, card_line, clock, require_replay
from conan_slam_tpu_torch.ops.probes import (
    rank_update_tile,
    rank_update_tile_reference,
    stream_copy,
    stream_copy_reference,
)
from conan_slam_tpu_torch.ops.rank_update import (
    rank_update_plan,
    rank_update_t,
    rank_update_t_reference,
    rank_update_vbt,
    rank_update_vbt_reference,
)
from conan_slam_tpu_torch.utils.profiling import scan_graph

DEFAULT = ("v0", "tr128", "tr256", "accum", "arb", "grid2d")
ALL = DEFAULT + ("stack3", "stack4", "copy", "mmonly")
FORCED_TILE = {"tr128": 32, "tr256": 64, "grid2d": 128}
STACKED = {"stack3": 3, "stack4": 2}
ACCUM_PASSES = 3
BLOCK = 20       # passes a captured graph


def variants_of(d: int, p0, vt, b, device):
    """Each variant's (kernel step, plain step, library call) on P, and the
    pair of calls (kernel, plain) whose outputs its gate compares."""
    vbt = b @ vt
    kr = {k: (torch.cat([vt] * k), torch.cat([vbt] * k)) for k in set(STACKED.values())}
    plan_tile = rank_update_plan(d, device)[0] if device.type == "cuda" else 32
    out = torch.empty_like(p0)
    v = {
        "v0": (lambda p: rank_update_t(p, vt, b), lambda p: rank_update_t_reference(p, vt, b),
               ("torch.addmm", lambda: torch.addmm(p0, vt.T, vbt))),
        "arb": (lambda p: rank_update_tile(p, vt, vbt, plan_tile, grid=0),
                lambda p: rank_update_vbt_reference(p, vt, vbt),
                ("torch.addmm", lambda: torch.addmm(p0, vt.T, vbt))),
        "copy": (stream_copy, stream_copy_reference, ("Tensor.copy_", lambda: out.copy_(p0))),
        "mmonly": (lambda p: p + 0.0 * rank_update_tile(None, vt, vbt, plan_tile)[0, 0],
                   lambda p: p + 0.0 * rank_update_tile_reference(None, vt, vbt)[0, 0],
                   ("torch.mm", lambda: torch.mm(vt.T, vbt))),
    }
    for name, tile in FORCED_TILE.items():
        v[name] = (lambda p, tile=tile: rank_update_tile(p, vt, vbt, tile),
                   lambda p: rank_update_vbt_reference(p, vt, vbt),
                   ("torch.addmm", lambda: torch.addmm(p0, vt.T, vbt)))

    def accum(p, update):
        for _ in range(ACCUM_PASSES):
            p = update(p, vt, vbt)
        return p

    def accum_lib():
        p = p0
        for _ in range(ACCUM_PASSES):
            p = torch.addmm(p, vt.T, vbt)
        return p

    v["accum"] = (lambda p: accum(p, rank_update_vbt),
                  lambda p: accum(p, rank_update_vbt_reference),
                  (f"{ACCUM_PASSES} x torch.addmm", accum_lib))
    for name, k in STACKED.items():
        gk, mk = kr[k]
        v[name] = (lambda p, gk=gk, mk=mk: rank_update_vbt(p, gk, mk),
                   lambda p, gk=gk, mk=mk: rank_update_vbt_reference(p, gk, mk),
                   ("torch.addmm", lambda gk=gk, mk=mk: torch.addmm(p0, gk.T, mk)))
    gates = {name: (lambda step=step: step(p0) - p0, lambda plain=plain: plain(p0) - p0)
             for name, (step, plain, _) in v.items()}
    gates["copy"] = (lambda: stream_copy(p0), lambda: stream_copy_reference(p0))
    gates["mmonly"] = (lambda: rank_update_tile(None, vt, vbt, plan_tile),
                       lambda: rank_update_tile_reference(None, vt, vbt))
    return v, gates


def main(argv=None, device="cuda") -> dict:
    variants = list(argv or DEFAULT)
    unknown = [n for n in variants if n not in ALL]
    if unknown:
        raise ValueError(f"probe_rankpass: unknown variants {unknown}; known: {ALL}")
    d = int(os.environ.get("RP_D", "2304"))
    rank = int(os.environ.get("RP_RANK", "288"))
    frames = int(os.environ.get("RP_FRAMES", "4000"))
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    rng = np.random.default_rng(0)
    p0 = torch.eye(d, dtype=torch.float32, device=dev)
    vt = torch.as_tensor(rng.normal(size=(rank, d)).astype(np.float32) * 1e-4, device=dev)
    b = torch.eye(rank, dtype=torch.float32, device=dev) * 1e-6
    table, gates = variants_of(d, p0, vt, b, dev)

    results = {}
    for name in variants:
        kernel, plain = gates[name]
        got, ref = kernel(), plain()
        err = float((got - ref).abs().max())
        tol = 0.0 if name == "copy" else 1e-4 * float(ref.abs().max())
        print(f"{name}: maxerr {err:.2e} (tolerance {tol:.1e})", file=sys.stderr, flush=True)
        if not err <= tol:
            raise AssertionError(f"{name}: off its plain version by {err:.2e} > {tol:.1e}")
        if name != "copy" and not float(ref.abs().max()) > 0.0:
            raise AssertionError(f"{name}: the plain update is zero, the gate would hold nothing")
        results[name] = {"maxerr": err}

    block = min(BLOCK, frames)
    for name in variants:
        step, _, (lib_name, lib) = table[name]
        res = scan_graph(lambda c, step=step: (step(c[0]),), (p0,), frames, block)
        require_replay(name, res)
        lib_us = call_us(lib, dev, max(1, frames // 10))
        extra = ""
        if name == "copy":
            tbs = 2 * d * d * 4 / (res.us_per_frame * 1e-6) / 1e12
            extra = f"; {tbs:.3f} TB/s against the 3.35 TB/s spec"
            results[name]["tb_per_s"] = tbs
        print(f"{name:8s}: {res.us_per_frame:8.1f} us/pass ({clock(dev, block)}; "
              f"eager {res.eager_us_per_frame:.1f} us/pass; {lib_name} {lib_us:.1f} us{extra})",
              flush=True)
        results[name].update(us=res.us_per_frame, eager_us=res.eager_us_per_frame,
                             library=lib_name, library_us=lib_us, launches=res.launches,
                             frames=res.frames)
    return {"d": d, "rank": rank, "frames": frames, "variants": results}


if __name__ == "__main__":
    main(sys.argv[1:] or None)
