"""The two constructs the reference probed on its hardware, on the card
(port of benchmarks/probe_mosaic.py): each runs one kernel on the probe's
own inputs and checks it against numpy at the probe's tolerances.

  dots    - H13: phtt = prows^T hc^T, sipht = si phtt^T, sivpht = siv phtt^T
            (D 512, MP 128, RP 136; rel 1e-4)
  observe - H14: the observe alone, Hc (1e-4), R (1e-5) and v (1e-4), through
            the known frame's device code and the gated frame's

Beside each check, the kernel's time a call through ``scan_graph`` (graph
and eager) and the library call's (torch.matmul of the three products for
dots; none for the observe).

Usage: python -m conan_slam_tpu_torch.benchmarks.probe_mosaic [dots|observe|all]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import call_us, card_line, clock, require_replay
from conan_slam_tpu_torch.ops.probes import OBSERVE_PATHS, probe_dots, probe_observe
from conan_slam_tpu_torch.utils.profiling import scan_graph

BLOCK = 100      # calls a captured graph
FRAMES = 2000    # calls timed


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def dots_inputs(d: int = 512, mp: int = 128, rp: int = 136):
    """The probe's inputs (rng 0): prows (RP, D), hc (MP, RP), si (MP, MP),
    siv (1, MP), at the probe's shape unless another is given."""
    rng = np.random.default_rng(0)
    prows = rng.normal(size=(rp, d)).astype(np.float32)
    hc = rng.normal(size=(mp, rp)).astype(np.float32)
    si = rng.normal(size=(mp, mp)).astype(np.float32)
    siv = rng.normal(size=(1, mp)).astype(np.float32)
    return prows, hc, si, siv


def time_call(name, fn, args, device) -> dict:
    """A call of ``fn(*args)``, chained through ``scan_graph`` (the first
    input fed back with a zero weight), graph and eager."""
    def step(c):
        out = fn(c[0], *args[1:])
        return (c[0] + 0.0 * out[0].reshape(-1)[0],)
    res = scan_graph(step, (args[0],), FRAMES, min(BLOCK, FRAMES))
    require_replay(name, res)
    return dict(us=res.us_per_frame, eager_us=res.eager_us_per_frame, launches=res.launches,
                frames=res.frames)


def probe_dots_check(device) -> dict:
    """Transposed contractions in the orientations the gated frame reads."""
    prows, hc, si, siv = dots_inputs()
    args = tuple(torch.as_tensor(a, device=device) for a in (prows, hc, si, siv))
    o1, o2, o3 = (t.cpu().numpy() for t in probe_dots(*args))
    ref1 = prows.T @ hc.T
    ref2 = si @ ref1.T
    ref3 = siv @ ref1.T
    errs = {}
    for name, got, ref in (("phtt", o1, ref1), ("sipht", o2, ref2), ("sivpht", o3, ref3)):
        err = float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-9))
        log(f"dots/{name}: rel {err:.2e}")
        if not err < 1e-4:
            raise AssertionError(f"dots/{name}: rel {err:.2e} >= 1e-4")
        errs[name] = err
    log("probe dots: PASS")
    st = time_call("dots", probe_dots, args, device)

    def library():
        phtt = torch.matmul(args[0].T, args[1].T)
        return phtt, torch.matmul(args[2], phtt.T), torch.matmul(args[3], phtt.T)
    st.update(rel=errs, library="torch.matmul x 3", library_us=call_us(library, device, FRAMES))
    print(f"dots    : {st['us']:8.2f} us/call ({clock(device, min(BLOCK, FRAMES))}; "
          f"eager {st['eager_us']:.2f} us/call; {st['library']} {st['library_us']:.2f} us)",
          flush=True)
    return st


def observe_inputs():
    """The probe's inputs (rng 1): 64 measurements of features within 60 m,
    one masked, as xrows (RP,), zin (3, MP / 2), rsc (4,), and its numpy
    reference (Hc, R, v)."""
    rng = np.random.default_rng(1)
    nz, mp, rp = 64, 128, 136
    nzl = mp // 2
    xrows = np.zeros((rp,), np.float32)
    xrows[:3] = [1.0, -2.0, 0.3]
    feats = rng.uniform(-60, 60, size=(nz, 2)).astype(np.float32)
    xrows[3: 3 + 2 * nz] = feats.reshape(-1)
    mask = np.ones(nz, np.float32)
    mask[5] = 0.0
    dx = feats[:, 0] - xrows[0]
    dy = feats[:, 1] - xrows[1]
    dist = np.hypot(dx, dy)
    brg = np.arctan2(dy, dx) - xrows[2]
    zin = np.zeros((3, nzl), np.float32)
    zin[0, :nz] = (dist + rng.normal(size=nz) * 0.1) * mask
    zin[1, :nz] = (brg + rng.normal(size=nz) * 0.01) * mask
    zin[2, :nz] = mask
    rsc = np.asarray([0.01, 0.0, 0.0, 7.6e-5], np.float32)

    # numpy reference (the probe's, the same algebra as the frame's).
    idx = np.arange(nzl)
    fxs = np.zeros(nzl, np.float64)
    fys = np.zeros(nzl, np.float64)
    fxs[:nz] = feats[:, 0]
    fys[:nz] = feats[:, 1]
    m = zin[2].astype(np.float64)
    px, py, phi = xrows[:3].astype(np.float64)
    dxl = fxs - px
    dyl = fys - py
    d2 = np.maximum(dxl**2 + dyl**2, 1e-12)
    dd = np.sqrt(d2)
    bpred = np.arctan2(dyl, dxl) - phi
    vr = (zin[0].astype(np.float64) - dd) * m
    dbr = zin[1].astype(np.float64) - bpred
    vb = (dbr - 2 * np.pi * np.floor((dbr + np.pi) / (2 * np.pi))) * m
    v_ref = np.zeros(mp)
    v_ref[2 * idx] = vr
    v_ref[2 * idx + 1] = vb
    hc_ref = np.zeros((mp, rp))
    hc_ref[2 * idx, 0] = -dxl / dd * m
    hc_ref[2 * idx, 1] = -dyl / dd * m
    hc_ref[2 * idx + 1, 0] = dyl / d2 * m
    hc_ref[2 * idx + 1, 1] = -dxl / d2 * m
    hc_ref[2 * idx + 1, 2] = -m
    hc_ref[2 * idx, 3 + 2 * idx] = dxl / dd * m
    hc_ref[2 * idx, 4 + 2 * idx] = dyl / dd * m
    hc_ref[2 * idx + 1, 3 + 2 * idx] = -dyl / d2 * m
    hc_ref[2 * idx + 1, 4 + 2 * idx] = dxl / d2 * m
    rm_ref = np.zeros((mp, mp))
    rm_ref[2 * idx, 2 * idx] = np.where(m > 0, rsc[0], 1.0)
    rm_ref[2 * idx + 1, 2 * idx + 1] = np.where(m > 0, rsc[3], 1.0)
    return (xrows, zin, rsc, mp, rp), (hc_ref, rm_ref, v_ref)


OBSERVE_TOL = (("hc", 1e-4), ("rmat", 1e-5), ("v", 1e-4))


def probe_observe_check(device) -> dict:
    """The observe (atan2, the wrap, the spreads into Hc and R) alone."""
    (xrows, zin, rsc, mp, rp), refs = observe_inputs()
    args = tuple(torch.as_tensor(a, device=device) for a in (xrows, zin, rsc))
    out = {}
    for path in OBSERVE_PATHS:
        got = probe_observe(*args, mp, rp, path)
        errs = {}
        for (name, tol), g, ref in zip(OBSERVE_TOL, got, refs):
            err = float(np.max(np.abs(g.cpu().numpy() - ref)))
            log(f"observe/{path}/{name}: max abs {err:.2e}")
            if not err < tol:
                raise AssertionError(f"observe/{path}/{name}: max abs {err:.2e} >= {tol:g}")
            errs[name] = err
        st = time_call(f"observe/{path}", lambda *a, path=path: probe_observe(*a, mp, rp, path),
                       args, device)
        st.update(max_abs=errs)
        print(f"observe/{path}: {st['us']:8.2f} us/call ({clock(device, min(BLOCK, FRAMES))}; "
              f"eager {st['eager_us']:.2f} us/call; no library call)", flush=True)
        out[path] = st
    log("probe observe: PASS")
    return out


def main(argv=None, device="cuda") -> dict:
    which = argv[0] if argv else "all"
    if which not in ("dots", "observe", "all"):
        raise ValueError(f"probe_mosaic: expected dots, observe or all, got {which!r}")
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    res = {}
    if which in ("dots", "all"):
        res["dots"] = probe_dots_check(dev)
    if which in ("observe", "all"):
        res["observe"] = probe_observe_check(dev)
    log("probe_mosaic: ALL PASS")
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
