"""F5 (ROADMAP Queue 3) on the card: the sweep's rounding at the F1 frames,
H1, H9 and H10 against a float64 witness (the port's oracle: fastframe
factors, dense products, a Cholesky inverse).

The F1 frames are the known frames without the heading update over 16
sub-steps and more (tests/test_torch_cuda.py's cases), where S's
conditioning lets fp32 rounding before and in the sweep move x and P by
1e-4 to 1e-3 in any route; the gated frames are H10's cases without the
heading update and its MP 224 edge.  For each frame, each route's largest
distance from the witness in x and in P: H9 (or H10), the split
schedule's kernels, and the plain version on the card; for H1 alone, the
frame's S inverted by H1 and by the plain sweep, against S's float64
inverse over the swept block.  The test bounds are
``test_frame_step_kernel_matches_plain``'s and
``test_obs_step_kernel_at_the_resident_edge``'s.

Then, on H9's worst F1 frame (the largest distance in x, among the frames
of 16 sub-steps and among them all), the split route
(H2 -> H1 -> H3 -> H4) three times: as it runs; with H1 fed the float64 S
(the plain chain in float64 on the same float32 inputs), rounded to
float32, in place of H2's S; and with H3 fed the float64 S^-1 (the plain
sweep in float64 on that S), rounded to float32, in place of H1's.  Each
run's distance from the float64 witness in x and P says whether the
chain's S or the sweep carries the frame's error.

    python tests/f5_card.py [out.json]

Needs a CUDA card (no JAX); about a minute after the build.
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def _dist(a, w) -> float:
    return float((a.double() - w).abs().max())


def known_frames(dev) -> list[dict]:
    from test_torch_cuda import _VARIANT_CASES, _frame_args, _witness

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si, sweep_si_reference

    cases = [(d, nz, 16, False) for d in (2304, 2051) for nz in (10, 64, 112)]
    cases += [c for c in _VARIANT_CASES if not c[3]]
    rows = []
    for d, nz, s_steps, h in cases:
        args = list(_frame_args(dev, d, nz=nz, s_steps=s_steps, use_heading=h))
        args[0] = 0.5 * (args[0] + args[0].T)
        got = fk.frame_step(*args)
        split = fk.frame_step(*args, schedule="split")
        plain = fk.frame_step(*args, plain=True)
        wit = _witness(args)
        row = {"frame": f"D {d}, NZ {nz}, S {s_steps}", "case": (d, nz, s_steps, h)}
        for key in ("x", "p"):
            w = getattr(wit, key)
            e = {n: _dist(getattr(r, key), w) for n, r in
                 (("h9", got), ("split", split), ("plain", plain))}
            variant = (d, nz, s_steps, h) in _VARIANT_CASES
            limit = 2.0 * (max(e["plain"], e["split"]) if variant else e["plain"]) + 1e-4
            row[key] = {**e, "limit": limit, "within": e["h9"] <= limit}
        # H1 alone on the frame's S, over the swept block.
        p, x, slots, cap, *rest = args
        fi = fk.frame_inputs(p, x, fk.frame_rows(slots, cap), *rest[:9])
        ch = fk._frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc,
                                       fi.mp, *rest[9:])
        k = 2 * int(fi.nblk)
        s64 = ch.s[:k, :k].double()
        inv64 = torch.linalg.inv(0.5 * (s64 + s64.T))
        row["h1"] = {n: _dist(si[:k, :k], inv64) for n, si in
                     (("h1", sweep_si(ch.s, fi.nblk)), ("plain", sweep_si_reference(ch.s, fi.nblk)))}
        rows.append(row)
    return rows


def split_swaps(dev, case) -> dict:
    """The split route of the known frame ``case`` (d, nz, s_steps,
    use_heading) as it runs, with H1 on the float64 S rounded to float32,
    and with H3 on the float64 S^-1 rounded to float32: each run's distance
    from the float64 witness in x and P, and whether the first equals
    ``frame_step(..., schedule="split")`` bit for bit."""
    from test_torch_cuda import _frame_args, _witness

    from conan_slam_tpu_torch.ops import frame_kernel as fk
    from conan_slam_tpu_torch.ops.rank_update import rank_update_t
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si, sweep_si_reference

    d, nz, s_steps, h = case
    args = list(_frame_args(dev, d, nz=nz, s_steps=s_steps, use_heading=h))
    args[0] = 0.5 * (args[0] + args[0].T)
    p, x, slots, cap, *rest = args
    tail = tuple(rest[9:])
    fi = fk.frame_inputs(p, x, fk.frame_rows(slots, cap), *rest[:9])
    chain = (fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc)
    ch = fk.frame_chain(*chain, fi.mp, *tail)
    s64 = fk._frame_chain_reference(*(t.double() for t in chain), fi.mp, *tail).s
    si64 = sweep_si_reference(s64, fi.nblk)
    wit = _witness(args)

    def finish(si):
        """H3 and H4 behind the chain: the frame's mean and covariance."""
        pht, xn, _ = fk.frame_panels(ch.rowc, ch.ms, si, fi.prows, x)
        gmat, mmid = fk._frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp)
        return xn, rank_update_t(p, gmat, mmid)

    runs = {"split": finish(sweep_si(ch.s, fi.nblk)),
            "h1_on_f64_s": finish(sweep_si(s64.float(), fi.nblk)),
            "h3_on_f64_si": finish(si64.float())}
    ref = fk.frame_step(*args, schedule="split")
    out = {name: {"x": _dist(xn, wit.x), "p": _dist(pn, wit.p)} for name, (xn, pn) in runs.items()}
    out["split_is_frame_step"] = bool(torch.equal(runs["split"][0], ref.x)
                                      and torch.equal(runs["split"][1], ref.p))
    out["s_f32_vs_f64"] = _dist(ch.s, s64)
    return out


def gated_frames(dev) -> list[dict]:
    from test_torch_cuda import _obs_args, _obs_witness

    from conan_slam_tpu_torch.ops import frame_kernel as fk

    cases = [(d, nz, 6, False) for d in (1024, 1003) for nz in (10, 64, 112)]
    cases += [(1024, 112, 71, True)]
    rows = []
    for d, nz, s_steps, h in cases:
        args = _obs_args(dev, d, nz, s_steps, h)
        got = fk.frame_update_obs(*args)
        split = fk.frame_update_obs(*args, schedule="split")
        plain = fk.frame_update_obs(*args, plain=True)
        wit = _obs_witness(args)
        row = {"frame": f"D {d}, NZ {nz}, S {s_steps}{'' if not h else ', heading'}"}
        for key in ("x", "p"):
            w = getattr(wit, key)
            e = {n: _dist(getattr(r, key), w) for n, r in
                 (("h10", got), ("split", split), ("plain", plain))}
            row[key] = {**e, "limit": 2.0 * max(e["plain"], e["split"]) + 1e-4}
            row[key]["within"] = e["h10"] <= row[key]["limit"]
        rows.append(row)
    return rows


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("f5_card: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    known, gated = known_frames(dev), gated_frames(dev)
    for row in known + gated:
        route = "h9" if "h1" in row else "h10"
        print(f"{row['frame']}: x {route} {row['x'][route]:.3e} split {row['x']['split']:.3e} "
              f"plain {row['x']['plain']:.3e} (limit {row['x']['limit']:.3e}); "
              f"P {route} {row['p'][route]:.3e} split {row['p']['split']:.3e} "
              f"plain {row['p']['plain']:.3e} (limit {row['p']['limit']:.3e})"
              + (f"; H1 {row['h1']['h1']:.3e} plain sweep {row['h1']['plain']:.3e}"
                 if "h1" in row else ""), flush=True)
    for name, rows, route in (("H9", known, "h9"), ("H10", gated, "h10")):
        for key in ("x", "p"):
            vals = [r[key][route] for r in rows]
            print(f"{name} {key}: largest {max(vals):.3e}, median {statistics.median(vals):.3e}, "
                  f"within the test bound on {sum(r[key]['within'] for r in rows)} of {len(rows)}")
    h1 = [r["h1"]["h1"] for r in known]
    print(f"H1: largest {max(h1):.3e}, median {statistics.median(h1):.3e}")
    swaps = {}
    for label, rows in (("S 16", [r for r in known if r["case"][2] == 16]), ("any S", known)):
        worst = max(rows, key=lambda r: r["x"]["h9"])
        sw = swaps[label] = dict(split_swaps(dev, worst["case"]), frame=worst["frame"])
        print(f"H9's worst F1 frame, {label} ({worst['frame']}, x {worst['x']['h9']:.3e}), the "
              "split route from the witness: " + "; ".join(
                  f"{n} x {sw[n]['x']:.3e} P {sw[n]['p']:.3e}"
                  for n in ("split", "h1_on_f64_s", "h3_on_f64_si"))
              + f" (the split run bit for bit frame_step's: {sw['split_is_frame_step']}; "
              f"|S - S64| {sw['s_f32_vs_f64']:.3e})")
    if argv:
        with open(argv[0], "w") as f:
            json.dump({"known": known, "gated": gated, "worst_split_swaps": swaps}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
