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
  factors        - the frame factors (filters.ekf.frame_factors, plain
                   PyTorch as the reference's jnp) over the rollout's
                   controls, then H4 at their rank: no measurement chain
  smallchain     - the split route's measurement chain with P held fixed:
                   the on-device sensor and compaction, association, the
                   gathers, H2 -> H1 -> H3; x carried (+1e-20 of the update)
  gather         - the row gathers before the fused update (P[rows],
                   P[rows][:, rows], x[rows]) on fixed rows
  chainkernel    - those gathers plus H2, x carried, P fixed
  chainonly      - H2 alone on strips gathered once
  gmrank         - G/M assembly (the split route's _frame_gm) plus H4, pht fixed
  glue           - the precomputed driver's frame body
                   (runner.loop.ekf_precomp_frame_step) with the frame
                   kernel replaced by a touch of the mean
  body_noaug     - that body with its kernel, augmentation off
  body_uncond    - that body with augmentation on: the port's augment is
                   unconditional (runner.loop.fused_frame)
  gbody_aug, gbody_noaug
                 - the gated body (H15 then H10, augmentation on / off) on
                   the pre-registered map; run them at FS_LANDMARKS=10240
  gating         - H15 alone (filters.ekf.factor_and_associate_gated: the
                   factors and the gated association), its slots touched
                   into the mean
  assoc          - the on-device sensor, compaction and the known
                   association alone
  megaprep       - the gated frame's input assembly
                   (ops.frame_kernel.obs_inputs: the rows, their padding,
                   the P row and lane gathers, x and vtf at the rows, the
                   measurement buffer); H10 does this inside its launch,
                   the split route (past MP 224) before H7
  prep_prc, prep_pads, prep_zin
                 - its parts: the lane gather P[rows][:, rows]; the padded
                   row gather; the measurement buffer
  full, fullpair - the port's run_ekf_slam_precomputed (per frame, in frame
                   pairs), eager and host-timed: the driver's own graph is
                   ROADMAP item 10

The prep modes touch P[0, 0] in place (+1e-20 of what they gathered), as
the reference does, so that their gathers stay in the loop without a P
rewrite.  Refused by name, with no counterpart in the port: full_u<N>
(lax.scan's unroll of the driver loop; the port's loop is eager) and
body_aug (the reference's lax.cond around augmentation, which needs the
device's answer on the host before it branches; the port augments
unconditionally, with no host sync: body_uncond).  The world is the
bench's: 1024 landmarks from numpy seed 42 over a 13 km square, all
pre-registered (``benchmarks.world``); the rollout's noise draws come from
a ``torch.Generator`` seeded 42 where the reference took its PRNGKey(42).
Every mode's carry after the graph's replays must equal, bit for bit, its
carry after the same steps run eagerly.

Knobs: FS_LANDMARKS (1024), FS_STEPS (2400), FS_NVALID (NZ: the valid
measurements of stepkernel), FS_RANK (152: ppass).
Run on the card: python -m conan_slam_tpu_torch.benchmarks.bench_framestep [modes...]
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from conan_slam_tpu_torch.benchmarks import card_line, clock, require_replay
from conan_slam_tpu_torch.benchmarks.world import SEED, bench_world
from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.core.linalg import safe_cholesky
from conan_slam_tpu_torch.filters.common import compact
from conan_slam_tpu_torch.filters.ekf import (
    associate_known,
    factor_and_associate_gated,
    frame_factors,
)
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.ops.factor_kernel import frame_factors_fused
from conan_slam_tpu_torch.ops.frame_kernel import (
    _frame_gm,
    _frame_measure,
    _pack_meas,
    frame_chain,
    frame_inputs,
    frame_rows,
    frame_shapes,
    frame_step,
    frame_update_obs,
    obs_inputs,
)
from conan_slam_tpu_torch.ops.rank_update import rank_update_t
from conan_slam_tpu_torch.ops.spd_inverse import spd_inverse, sweep_si
from conan_slam_tpu_torch.runner import loop
from conan_slam_tpu_torch.runner.loop import (
    ekf_precomp_frame_step,
    make_noise,
    precompute_rollout,
    run_ekf_slam_precomputed,
)
from conan_slam_tpu_torch.sim import sensor_sim
from conan_slam_tpu_torch.utils.profiling import scan_graph

BLOCK = 20              # frames a captured graph
SCAN_MODES = ("sweeponly", "sweep", "chol", "noop", "ppass", "stepkernel", "stepkernel_big",
              "fullkernel", "factkernel", "factors", "smallchain", "gather", "chainkernel",
              "chainonly", "gmrank", "glue", "body_noaug", "body_uncond", "gbody_aug",
              "gbody_noaug", "gating", "assoc", "megaprep", "prep_prc", "prep_pads", "prep_zin")
DRIVER_MODES = ("full", "fullpair")
# The reference's modes with no counterpart in the port (module docstring).
REFUSED = {"body_aug": "the reference's lax.cond around augmentation: the port augments "
                       "unconditionally, with no host sync (body_uncond)",
           "full_u": "lax.scan's unroll of the driver loop: the port's loop is eager"}
DEFAULT = ("full", "factors", "ppass", "smallchain", "chol")   # the reference's default


def refusal(mode: str) -> str | None:
    """Why ``mode`` has no counterpart in the port, or None."""
    if mode.startswith("full_u"):
        return REFUSED["full_u"]
    return REFUSED.get(mode)


@contextlib.contextmanager
def _touched_frame_kernel():
    """The driver's frame kernel (runner.loop's fused_frame_step) replaced by
    a touch of the mean (the glue mode), as the reference stubs its
    fused_frame_step."""
    def stub(state, vns, swans, phis, actives, q_cov, obs, slots, mask, r_cov, *args, **kw):
        nis = vns.sum() * 1e-20 + torch.where(mask, obs.z[:, 0], 0.0).sum() * 1e-20
        x = state.x + F.pad(nis.reshape(1), (0, state.x.shape[0] - 1))
        return state._replace(x=x), torch.zeros((vns.shape[0], 3), device=x.device) + x[0], nis

    real = loop.fused_frame_step
    loop.fused_frame_step = stub
    try:
        yield
    finally:
        loop.fused_frame_step = real


def main(argv=None, device="cuda") -> dict:
    modes = list(argv or DEFAULT)
    refused = {m: refusal(m) for m in modes if refusal(m)}
    if refused:
        raise ValueError("bench_framestep: no counterpart in the port: "
                         + "; ".join(f"{m}: {why}" for m, why in refused.items()))
    unknown = [m for m in modes if m not in SCAN_MODES + DRIVER_MODES]
    if unknown:
        raise ValueError(f"bench_framestep: unknown modes {unknown}; "
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
    cap = state0.capacity
    block = min(BLOCK, n_frames)
    rng = np.random.default_rng(0)
    tail = (cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading)
    tail4 = (*tail, cfg.switch_heading_known)
    mp, rp = frame_shapes(nz)

    slots = torch.arange(nz, dtype=torch.int64, device=dev)
    rows = frame_rows(slots, cap)
    rows_full = F.pad(rows, (0, rp - rows.shape[0]))
    zr = torch.as_tensor(np.hypot(lm[:nz, 0], lm[:nz, 1]).astype(np.float32), device=dev)
    zb = torch.as_tensor(np.arctan2(lm[:nz, 1], lm[:nz, 0]).astype(np.float32), device=dev)
    nvalid = int(os.environ.get("FS_NVALID", str(nz)))
    ctrl = (torch.full((interval,), cfg.velocity, dtype=f32, device=dev),
            torch.zeros((interval,), dtype=f32, device=dev),
            torch.zeros((interval,), dtype=f32, device=dev),
            torch.ones((interval,), dtype=torch.bool, device=dev))
    mask = torch.ones((nz,), dtype=torch.bool, device=dev)
    eye_m = lambda m: torch.eye(m, dtype=f32, device=dev)   # noqa: E731
    state_carry = (state0.x, state0.p, state0.n_active, state0.table)

    def frames_of_rollout():
        """The rollout's frames on the card, as the driver forms them, and
        the noise draws over every landmark (the on-device sensor's): picked
        by a carried frame counter (an index_select, no host read)."""
        (x_true, swa, active, done), (z_true, ids, zmask) = precompute_rollout(world, cfg,
                                                                               n_steps)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        ctrl_noise = torch.randn((n_frames, interval, 2), generator=gen, device=dev)
        obs_noise = torch.randn((n_frames, world.num_landmarks, 2), generator=gen, device=dev)
        return (x_true.reshape(n_frames, interval, 3), swa.reshape(n_frames, interval),
                active.reshape(n_frames, interval), done.reshape(n_frames, interval),
                ctrl_noise, z_true, ids, zmask, obs_noise)

    def pick(tensors, f):
        return tuple(torch.index_select(t, 0, f.reshape(1))[0] for t in tensors)

    def controls(frame):
        """``(vns, swans, phis, actives)`` of a frame's truth and draws."""
        x_true_f, swa_f, active_f, _, ctrl_noise_f = frame[:5]
        vns, swans = sensor_sim.add_control_noise(ctrl_noise_f, cfg.velocity, swa_f, cfg.sigma_v,
                                                 cfg.sigma_swa, cfg.switch_control_noise)
        return vns, swans, x_true_f[:, 2], active_f

    def sensed(frame):
        """The on-device sensor at the frame's end: every return, its noise,
        compacted to the NZ-slot buffer (the reference's get_obs)."""
        obs = sensor_sim.get_observations(frame[0][-1], world.landmarks, cfg.max_range)
        obs = sensor_sim.add_observation_noise(frame[8], obs, cfg.sigma_r, cfg.sigma_b,
                                               cfg.switch_sensor_noise)
        return compact(obs, nz)

    def as_state(c):
        return EKFState(*c[:4])

    def scan_carries():
        """Each scan mode's (step, carry0)."""
        c = {}
        counter = torch.zeros((), dtype=torch.int64, device=dev)
        mpw = -(-2 * nz // 128) * 128
        a = rng.normal(size=(mpw, mpw)).astype(np.float32)
        s_sweep = torch.as_tensor(a @ a.T / mpw + np.eye(mpw, dtype=np.float32), device=dev)
        nb_all = torch.full((1,), mpw // 2, dtype=torch.int32, device=dev)

        def sweeponly(carry):
            s, acc = carry
            si = sweep_si(s, nb_all)
            acc = acc + si[0, 0]
            return s + 1e-12 * acc * eye_m(mpw), acc
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

        def stepkernel(schedule, m_):
            def step(carry):
                p, x = carry
                fs = frame_step(p, x, slots, cap, *ctrl, noise.qe, zr, zb, m_,
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
            fu = frame_update_obs(p, x, slots, cap, zr, zb, mask, noise.re, bf, vtf)
            return fu.p, fu.x
        c["fullkernel"] = (fullkernel, (state0.p, state0.x))

        frames = frames_of_rollout()
        driver_frame = frames[:8] + (frames[8][:, :nz],)

        def factkernel(carry):
            x, f = carry
            st, _, vtf_f, bm = frame_factors_fused(state0._replace(x=x),
                                                   *controls(pick(frames[:5], f)), noise.qe,
                                                   *tail4)
            return st.x + 1e-20 * (bm[0, 0] * vtf_f[0]), (f + 1) % n_frames
        c["factkernel"] = (factkernel, (state0.x, counter))

        def factors(carry):
            x, p, f = carry
            st, _, vmat, bm = frame_factors(state0._replace(x=x, p=p),
                                            *controls(pick(frames[:5], f)), noise.qe, *tail4)
            return st.x, rank_update_t(p, vmat.T.contiguous(), bm), (f + 1) % n_frames
        c["factors"] = (factors, (state0.x, state0.p, counter))

        def smallchain(carry):
            x, f = carry
            frame = pick(frames, f)
            obs = sensed(frame)
            st = state0._replace(x=x)
            assoc = associate_known(st, obs)
            live = torch.logical_not(frame[3][-1])
            fi = frame_inputs(st.p, x, frame_rows(assoc.slots, cap), *controls(frame), noise.qe,
                              obs.z[:, 0], obs.z[:, 1], assoc.known_mask & live, noise.re)
            _, _, _, xn, _ = _frame_measure(fi, x, tail4, False)
            return x + 1e-20 * xn, (f + 1) % n_frames
        c["smallchain"] = (smallchain, (state0.x, counter))

        p_fix = state0.p

        def gather(carry):
            (x,) = carry
            prows = p_fix[rows_full]
            prc = prows[:, rows_full]
            return (x + 1e-20 * (prows[0] + prc[0, 0] + x[rows_full][0]),)
        c["gather"] = (gather, (state0.x,))

        fi0 = frame_inputs(p_fix, state0.x, rows, *ctrl, noise.qe, zr, zb, mask, noise.re)

        def chain(prc_of):
            def step(carry):
                (x,) = carry
                ch = frame_chain(fi0.subs, fi0.qc, fi0.zin, fi0.rsc, x[rows_full], prc_of(), mp,
                                 *tail4)
                return (x + 1e-20 * ch.s[0, 0],)
            return step
        c["chainkernel"] = (chain(lambda: p_fix[rows_full][:, rows_full].contiguous()),
                            (state0.x,))
        c["chainonly"] = (chain(lambda: fi0.prc), (state0.x,))

        pht_fix = torch.as_tensor(rng.normal(size=(mp, d)).astype(np.float32) * 1e-4,
                                  device=dev)
        si_fix = eye_m(mp) * 1e-6
        k4_fix = torch.zeros((4, 4), dtype=f32, device=dev)

        def gmrank(carry):
            (p,) = carry
            g, mm = _frame_gm(pht_fix, si_fix, k4_fix, p[2:3, :], mp)
            return (rank_update_t(p, g, mm),)
        c["gmrank"] = (gmrank, (state0.p,))

        def body(cfg_b):
            def step(carry):
                *st, f = carry
                out, _, _ = ekf_precomp_frame_step(as_state(st), pick(driver_frame, f), cfg=cfg_b,
                                                   noise=noise)
                return (*out, (f + 1) % n_frames)
            return step
        for name, cfg_b in (
                ("glue", cfg), ("body_noaug", cfg), ("body_uncond",
                                                     cfg.replace(enable_augment=True)),
                ("gbody_aug", cfg.replace(switch_association_known=False, enable_augment=True)),
                ("gbody_noaug", cfg.replace(switch_association_known=False))):
            c[name] = (body(cfg_b), (*state_carry, counter))

        def gating(carry):
            x, f = carry
            frame = pick(driver_frame, f)
            obs = loop._noisy_obs(cfg, *frame[5:])
            *_, assoc = factor_and_associate_gated(state0._replace(x=x), *controls(frame),
                                                   noise.qe, *tail4, obs, noise.re,
                                                   cfg.gate_reject, cfg.gate_augment)
            return x + 1e-20 * assoc.slots.sum(), (f + 1) % n_frames
        c["gating"] = (gating, (state0.x, counter))

        def assoc(carry):
            x, f = carry
            res = associate_known(state0._replace(x=x), sensed(pick(frames, f)))
            return x + 1e-20 * res.slots.sum(), (f + 1) % n_frames
        c["assoc"] = (assoc, (state0.x, counter))

        vtf0 = torch.as_tensor(rng.normal(size=(nb, d)).astype(np.float32) * 1e-4, device=dev)

        def touch(gathered):
            def step(carry):
                p, x = carry
                p[0, 0] += 1e-20 * gathered(p, x)
                return p, x
            return step

        def megaprep(p, x):
            oi = obs_inputs(p, x, rows, zr, zb, mask, noise.re, vtf0)
            return oi.prows[0, 0] + oi.prc[0, 0] + oi.vrows[0, 0] + oi.xrows[0] + oi.zin[0, 0]
        c["megaprep"] = (touch(megaprep), (state0.p, state0.x))
        c["prep_prc"] = (touch(lambda p, x: p[rows][:, rows][0, 0]), (state0.p, state0.x))
        c["prep_pads"] = (touch(lambda p, x: p[F.pad(rows, (0, rp - rows.shape[0]))][0, 0]),
                          (state0.p, state0.x))
        c["prep_zin"] = (touch(lambda p, x: _pack_meas(zr, zb, mask, noise.re, mp // 2)[0][0, 0]),
                         (state0.p, state0.x))
        return c

    results = {}
    scans = [m for m in modes if m in SCAN_MODES]
    if scans:
        table = scan_carries()
        for mode in scans:
            step, carry0 = table[mode]
            with _touched_frame_kernel() if mode == "glue" else contextlib.nullcontext():
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
