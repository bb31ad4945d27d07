"""Frame-step time breakdown at bench scale (port of
benchmarks/bench_framestep.py): D = 2051 (P padded to 2304), 64-slot
buffer.

Each mode chains n_frames = FS_STEPS / 6 steps through ``scan_graph``, the
counterpart of the reference's chained ``lax.scan``: one CUDA graph a block
of frames, replayed, so the time a frame is the card's with the host out of
the loop ("graph"), beside the same steps dispatched eagerly ("eager").

  sweeponly      - H1 alone on an (MP, MP) S = a a^T / MP + I, all pivots,
                   S fed back as s += 1e-12 acc I
  sweep          - spd_inverse (H1's full sweep) on S = a a^T + M I, M = 2 NZ
  chol           - torch.linalg.cholesky_ex + solve_triangular on that S
                   (the reference mode is plain jnp too)
  noop           - the feedback alone
  ppass          - H4 at rank FS_RANK (152) on the bench's P
  stepkernel     - frame_step on its default route (H9): fixed measurement
                   and control inputs, P and x carried
  stepkernel_big - frame_step(..., schedule="split") (H2 -> H1 -> H3 -> H4)
  fullkernel     - frame_update_obs on its default route (H10), 8 factor rows
  factkernel     - frame_factors_fused (H5) over the rollout's controls,
                   factors weighted 1e-20 into the carried mean
  full, fullpair - the port's run_ekf_slam_precomputed (per frame, in frame
                   pairs), eager and host-timed: the driver's own graph is
                   ROADMAP item 10

The reference's other modes (factors, smallchain, gather, chainkernel,
chainonly, gmrank, glue, body_*, gbody_*, gating, assoc, megaprep, prep_*)
are not ported yet (ROADMAP item 15).  The world is the bench's: 1024
landmarks from numpy seed 42 over a 13 km square, all pre-registered
(``benchmarks.world``).  Every mode's carry after the graph's replays must
equal, bit for bit, its carry after the same steps run eagerly.

Knobs: FS_LANDMARKS (1024), FS_STEPS (2400), FS_NVALID (NZ: the valid
measurements of stepkernel), FS_RANK (152: ppass).
Run on the card: python -m conan_slam_tpu_torch.benchmarks.bench_framestep [modes...]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from conan_slam_tpu_torch.benchmarks import card_line, clock, require_replay
from conan_slam_tpu_torch.benchmarks.world import SEED, bench_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.core.linalg import safe_cholesky
from conan_slam_tpu_torch.ops.factor_kernel import frame_factors_fused
from conan_slam_tpu_torch.ops.frame_kernel import frame_step, frame_update_obs
from conan_slam_tpu_torch.ops.rank_update import rank_update_t
from conan_slam_tpu_torch.ops.spd_inverse import spd_inverse, sweep_si
from conan_slam_tpu_torch.runner.loop import (
    make_noise,
    precompute_rollout,
    run_ekf_slam_precomputed,
)
from conan_slam_tpu_torch.utils.profiling import scan_graph

BLOCK = 20              # frames a captured graph
SCAN_MODES = ("sweeponly", "sweep", "chol", "noop", "ppass", "stepkernel", "stepkernel_big",
              "fullkernel", "factkernel")
DRIVER_MODES = ("full", "fullpair")
DEFAULT = ("full", "ppass", "chol")     # the reference's default, less its unported modes


def main(argv=None, device="cuda") -> dict:
    modes = list(argv or DEFAULT)
    unknown = [m for m in modes if m not in SCAN_MODES + DRIVER_MODES]
    if unknown:
        raise ValueError(f"bench_framestep: modes {unknown} are not ported (ROADMAP item 15); "
                         f"ported: {SCAN_MODES + DRIVER_MODES}")
    n_landmarks = int(os.environ.get("FS_LANDMARKS", "1024"))
    bench_steps = int(os.environ.get("FS_STEPS", "2400"))
    dev = torch.device(device)
    print(card_line(dev), flush=True)
    f32 = torch.float32

    lm, world, state0 = bench_world(n_landmarks, dev)
    cfg = SlamConfig(max_landmarks=n_landmarks, max_obs=64, enable_augment=False)
    noise = make_noise(cfg, "ekf", dev)
    interval = cfg.observe_interval
    n_steps = ((bench_steps + interval - 1) // interval) * interval
    n_frames = n_steps // interval
    nz = min(world.num_landmarks, cfg.max_observations())
    d = state0.x.shape[0]
    block = min(BLOCK, n_frames)
    rng = np.random.default_rng(0)
    tail = (cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading)

    slots = torch.arange(nz, dtype=torch.int64, device=dev)
    zr = torch.as_tensor(np.hypot(lm[:nz, 0], lm[:nz, 1]).astype(np.float32), device=dev)
    zb = torch.as_tensor(np.arctan2(lm[:nz, 1], lm[:nz, 0]).astype(np.float32), device=dev)
    nvalid = int(os.environ.get("FS_NVALID", str(nz)))
    ctrl = (torch.full((interval,), cfg.velocity, dtype=f32, device=dev),
            torch.zeros((interval,), dtype=f32, device=dev),
            torch.zeros((interval,), dtype=f32, device=dev),
            torch.ones((interval,), dtype=torch.bool, device=dev))
    eye_m = lambda m: torch.eye(m, dtype=f32, device=dev)   # noqa: E731

    def scan_carries():
        """Each scan mode's (step, carry0)."""
        c = {}
        mp = -(-2 * nz // 128) * 128
        a = rng.normal(size=(mp, mp)).astype(np.float32)
        s_sweep = torch.as_tensor(a @ a.T / mp + np.eye(mp, dtype=np.float32), device=dev)
        nb_all = torch.full((1,), mp // 2, dtype=torch.int32, device=dev)

        def sweeponly(carry):
            s, acc = carry
            si = sweep_si(s, nb_all)
            acc = acc + si[0, 0]
            return s + 1e-12 * acc * eye_m(mp), acc
        c["sweeponly"] = (sweeponly, (s_sweep, torch.zeros((), dtype=f32, device=dev)))

        m = 2 * nz
        a = rng.normal(size=(m, m)).astype(np.float32)
        s0 = torch.as_tensor(a @ a.T + m * np.eye(m, dtype=np.float32), device=dev)
        acc0 = torch.zeros((), dtype=f32, device=dev)

        def sweep(carry):
            s, acc = carry
            acc = acc + spd_inverse(s)[0, 0]
            return s + 1e-12 * acc * eye_m(m), acc

        def chol(carry):
            s, acc = carry
            linv = torch.linalg.solve_triangular(safe_cholesky(s), eye_m(m), upper=False)
            acc = acc + linv[0, 0]
            return s + 1e-12 * acc * eye_m(m), acc

        def noop(carry):
            s, acc = carry
            acc = acc + s[0, 0] * 1e-12
            return s * (1.0 + 1e-12 * acc), acc
        for name, fn in (("sweep", sweep), ("chol", chol), ("noop", noop)):
            c[name] = (fn, (s0, acc0))

        r = int(os.environ.get("FS_RANK", "152"))   # the fused frame's rank (MP + factors)
        vt = torch.as_tensor(rng.normal(size=(r, d)).astype(np.float32) * 1e-4, device=dev)
        bmat = eye_m(r) * 1e-6
        c["ppass"] = (lambda carry: (rank_update_t(carry[0], vt, bmat),), (state0.p,))

        mask_n = torch.as_tensor(np.arange(nz) < nvalid, device=dev)
        mask = torch.ones((nz,), dtype=torch.bool, device=dev)

        def stepkernel(schedule, m_):
            def step(carry):
                p, x = carry
                fs = frame_step(p, x, slots, state0.capacity, *ctrl, noise.qe, zr, zb, m_,
                                noise.re, *tail, True, schedule=schedule)
                return fs.p, fs.x
            return step
        c["stepkernel"] = (stepkernel("auto", mask_n), (state0.p, state0.x))
        c["stepkernel_big"] = (stepkernel("split", mask), (state0.p, state0.x))

        nb = 8
        bf = eye_m(nb) * 1e-8
        vtf = torch.as_tensor(rng.normal(size=(nb, d)).astype(np.float32) * 1e-4, device=dev)

        def fullkernel(carry):
            p, x = carry
            fu = frame_update_obs(p, x, slots, state0.capacity, zr, zb, mask, noise.re, bf, vtf)
            return fu.p, fu.x
        c["fullkernel"] = (fullkernel, (state0.p, state0.x))

        # The rollout's per-frame controls, picked on the card by a carried
        # frame counter (an index_select: no host read).
        (x_true, swa, active, _), _ = precompute_rollout(world, cfg, n_steps)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        cn = torch.randn((n_frames, interval, 2), generator=gen, device=dev)
        per_frame = (cfg.velocity + cn[..., 0] * cfg.sigma_v,
                     swa.reshape(n_frames, interval) + cn[..., 1] * cfg.sigma_swa,
                     x_true[:, 2].reshape(n_frames, interval),
                     active.reshape(n_frames, interval))

        def factkernel(carry):
            x, f = carry
            fi = [torch.index_select(t, 0, f.reshape(1))[0] for t in per_frame]
            st, _, vtf_f, bm = frame_factors_fused(state0._replace(x=x), *fi, noise.qe, *tail,
                                                   cfg.switch_heading_known)
            return st.x + 1e-20 * (bm[0, 0] * vtf_f[0]), (f + 1) % n_frames
        c["factkernel"] = (factkernel, (state0.x, torch.zeros((), dtype=torch.int64, device=dev)))
        return c

    results = {}
    scans = [m for m in modes if m in SCAN_MODES]
    if scans:
        table = scan_carries()
        for mode in scans:
            step, carry0 = table[mode]
            res = scan_graph(step, carry0, n_frames, block)
            require_replay(mode, res)
            finite = all(bool(torch.isfinite(t.float()).all()) for t in res.carry)
            if not finite:
                raise AssertionError(f"{mode}: the carried state is not finite")
            print(f"{mode:14s}: {res.us_per_frame:9.1f} us/frame ({clock(dev, block)}, "
                  f"{res.frames} frames; eager {res.eager_us_per_frame:.1f} us/frame)", flush=True)
            results[mode] = dict(us=res.us_per_frame, eager_us=res.eager_us_per_frame,
                                 launches=res.launches, frames=res.frames, block=block)

    drivers = [m for m in modes if m in DRIVER_MODES]
    if drivers:
        roll = precompute_rollout(world, cfg, n_steps)
    for mode in drivers:
        cfg_m = cfg.replace(frame_pair=mode == "fullpair")
        ts = []
        for _ in range(4):      # a warm run, then three timed ones
            gen = torch.Generator(device=dev).manual_seed(SEED)
            t0 = time.perf_counter()
            _, outs = run_ekf_slam_precomputed(world, cfg_m, gen, n_steps, state0, roll)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ts.append(time.perf_counter() - t0)
            if not bool(torch.isfinite(outs.x_est).all()):
                raise AssertionError(f"{mode}: the estimate is not finite")
        best = min(ts[1:])
        print(f"{mode:14s}: {best / n_frames * 1e6:9.1f} us/frame ({best:.3f}s / {n_frames} "
              f"frames; host clock, eager)", flush=True)
        results[mode] = dict(us=best / n_frames * 1e6, seconds=best, frames=n_frames)
    return {"d": d, "nz": nz, "frames": n_frames, "modes": results}


if __name__ == "__main__":
    main(sys.argv[1:] or None)
