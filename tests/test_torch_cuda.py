"""The CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA GPU (sm_90a, nvcc on PATH or under CUDA_HOME):
the kernels have no CPU mode, so without a card they skip.  Run them with

    python -m pytest -m cuda tests/test_torch_cuda.py -q

No JAX here: the machine with the card need not have it.  Tolerances
follow the reference's frame test (pose 1e-5, x 1e-4, P rtol 1e-3 /
atol 1e-4, NIS rtol 1e-3); kernel and plain version differ only in fp32
summation order and FMA contraction.
"""

import numpy as np
import pytest
import torch

from conan_slam_tpu_torch.config import SlamConfig
from conan_slam_tpu_torch.filters.ekf import init_state_with_map
from conan_slam_tpu_torch.filters.ekf.associate import _innovation_blocks
from conan_slam_tpu_torch.ops import cuda, frame_kernel as fk
from conan_slam_tpu_torch.ops.factor_kernel import (
    _factor_gate_reference,
    _frame_factors_reference,
    factor_gate,
    frame_factors_fused,
)
from conan_slam_tpu_torch.ops.gating_kernel import _gating_scores_reference, gating_scores
from conan_slam_tpu_torch.ops.rank_update import (
    rank_update_plan,
    rank_update_t,
    rank_update_t_reference,
    rank_update_vbt,
    rank_update_vbt_reference,
)
from conan_slam_tpu_torch.ops.spd_inverse import (
    spd_inverse,
    spd_inverse_reference,
    sweep_si,
    sweep_si_reference,
)
from conan_slam_tpu_torch.runner.loop import run_ekf_slam_precomputed
from conan_slam_tpu_torch.sim.world import config2_world, default_world
from conan_slam_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _frame_args(dev, d, seed=79, nz=10, s_steps=6, use_heading=True):
    """A frame at D = d: NZ = nz measurements of distinct landmarks (one
    masked) and S = s_steps sub-steps (the last inactive when S > 1), as
    frame_step takes it (the slots and the capacity)."""
    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-50, 50, size=(cap, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5, pad_multiple=128 if d % 128 == 0 else 0)
    assert st.x.shape[0] == d
    a = rng.normal(size=(d, 8)).astype(np.float32) * 0.05
    ids = rng.choice(cap, size=nz, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01], -1)
    mask = np.ones(nz, bool)
    mask[-2] = False
    t = lambda v: torch.as_tensor(np.asarray(v)).to(dev)  # noqa: E731
    return (
        (st.p + torch.as_tensor(a @ a.T)).to(dev), st.x.to(dev), t(ids.astype(np.int64)), cap,
        t((83.33 + rng.normal(size=s_steps) * 0.3).astype(np.float32)),
        t((rng.normal(size=s_steps) * 0.2).astype(np.float32)),
        t((rng.normal(size=s_steps) * 0.5).astype(np.float32)),
        t(np.arange(s_steps) < max(1, s_steps - 1)),
        t(np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)),
        t(z[:, 0].astype(np.float32)), t(z[:, 1].astype(np.float32)), t(mask),
        t(np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32)),
        73.0, 0.01, 0.01 * np.pi / 180, use_heading,
    )


def _assert_frame_close(got, ref):
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("d", [256, 203])
def test_frame_kernels_match_plain_versions(dev, d):
    # The default route (H9: its frame kernel and its P pass) and the split
    # schedule (H2, H1, H3, H4 once each), each against its plain version.
    args = _frame_args(dev, d)
    for schedule, want in (("auto", {"frame_step": fk.FS_LAUNCHES}),
                           ("split", {"sweep_inverse": 1, "frame_chain": 1, "frame_panels": 1,
                                      "rank_update": 1})):
        cuda.reset_launch_counts()
        got = fk.frame_step(*args, schedule=schedule)
        ref = fk.frame_step(*args, plain=True, schedule=schedule)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda.KERNELS.values()}
        assert counts == {**dict.fromkeys(counts, 0), **want}
        _assert_frame_close(got, ref)


def _witness(args):
    """The frame of frame_step's ``args`` in float64 through the port's
    independent oracle (fastframe factors, dense products, a Cholesky
    inverse)."""
    p, x, slots, cap, *rest = (a.double() if torch.is_tensor(a) and a.dtype == torch.float32
                               else a for a in args)
    return fk._plain_frame(p, x, fk.frame_rows(slots, cap), *rest[:9], tuple(rest[9:]))


def _ulp_bounds(args, got):
    """Elementwise bounds on two fp32 routes of one frame that differ only
    in the order of their sums (H9 and the split schedule: the same chain,
    sweep and pht code, M G and the mean summed in other orders).  Each
    route rounds two nested sums of at most r = MP + 8 terms (M G, then
    G^T M G; siv, then the mean), each within r eps of its terms'
    magnitudes to first order, so the two differ by at most 4 r eps times
    the magnitudes, from the plain versions: |P| + |G|^T |M| |G| for P,
    |x| + |xn| + |v|^T |S^-1| |pht| for the mean, |v|^T |S^-1| |v| for the
    NIS."""
    p, x, slots, cap, *rest = args
    fi = fk.frame_inputs(p, x, fk.frame_rows(slots, cap), *rest[:9])
    ch = fk._frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp,
                                   *rest[9:])
    si = sweep_si_reference(ch.s, fi.nblk)
    pht = fk._frame_panels_reference(ch.rowc, ch.ms, si, fi.prows, x)[0]
    gmat, mmid = fk._frame_gm(pht, si, ch.k4[:4, :4], fi.prows[2:3], fi.mp)
    vsi = ch.rowc[:, 7].abs() @ si.abs()
    u = 4.0 * (fi.mp + 8) * 2.0**-23
    return dict(pose_trace=u * got.pose_trace.abs(),
                x=u * (x.abs() + got.x.abs() + vsi @ pht.abs()),
                p=u * (p.abs() + gmat.abs().T @ (mmid.abs() @ gmat.abs())),
                nis=u * (vsi @ ch.rowc[:, 7].abs()))


# H9 over MP 32, 128 and 224, S = 1, 6 and 16, the heading update on and
# off, at the bench D, a ragged D and a D smaller than one tile.
_RESIDENT_CASES = [(d, nz, s, h) for d in (2304, 2051) for nz in (10, 64, 112)
                   for s in (1, 6, 16) for h in (True, False)]
_RESIDENT_CASES += [(13, 5, s, h) for s in (1, 6, 16) for h in (True, False)]
# Every other variant of its frame kernel (RX 2, 3, 5, 6: MP 64 to 192;
# RX 1, 4 and 7 are MP 32, 128 and 224 above) at the bench D over S = 1, 6
# and 16, and every RX over S = 256, the heading update on and off.
_VARIANT_CASES = [(2304, nz, s, h) for nz in (30, 45, 70, 90) for s in (1, 6, 16)
                  for h in (True, False)]
_VARIANT_CASES += [(2304, nz, 256, h) for nz in (10, 30, 45, 64, 70, 90, 112)
                   for h in (True, False)]
# The valet loop's shape (K 32: D 67, unpadded; NZ 30), which run_ekf_slam
# runs at its defaults.
_VALET_CASES = [(67, 30, 6, h) for h in (True, False)]


@pytest.mark.parametrize("d,nz,s_steps,use_heading", _RESIDENT_CASES + _VARIANT_CASES + _VALET_CASES)
def test_frame_step_kernel_matches_plain(dev, d, nz, s_steps, use_heading):
    args = list(_frame_args(dev, d, nz=nz, s_steps=s_steps, use_heading=use_heading))
    args[0] = 0.5 * (args[0] + args[0].T)          # exactly symmetric P
    cuda.reset_launch_counts()
    got, again = fk.frame_step(*args), fk.frame_step(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "frame_step": 2 * fk.FS_LAUNCHES}
    # Against the split schedule's kernels (H2, H1, H3, H4): the same device
    # code up to the order of M G's and the mean's sums, so within fp32
    # rounding of those sums (_ulp_bounds), at every shape: a fault of H9
    # shows here whatever the conditioning of S.
    split = fk.frame_step(*args, schedule="split")
    for key, tol in _ulp_bounds(args, got).items():
        err = (getattr(got, key) - getattr(split, key)).abs()
        assert bool((err <= tol).all()), (key, float(err.max()), float((err - tol).max()))
    # Against its plain version at the reference's frame-test tolerances;
    # the F1 frames (heading update off over 16 sub-steps) condition S so
    # that fp32 rounding before the sweep moves x and P by ~1e-4 to 1e-3 in
    # any route, so there x and P are held to a float64 witness (the port's
    # oracle) instead: H9 no further from it than twice its plain version,
    # plus the reference's 1e-4.
    # The variant cases hold the pose trace to the float64 witness, as F1
    # holds x and P: over 16 sub-steps and more, fp32's own rounding of the
    # recursion moves a coordinate by ~2e-5 m in the plain version too, more
    # than the reference's 1e-5 at coordinates of a few metres.
    ref = fk.frame_step(*args, plain=True)
    if (d, nz, s_steps, use_heading) in _VARIANT_CASES:
        wit = _witness(args)
        e_h9, e_plain = ((t.double() - wit.pose_trace).abs().max()
                         for t in (got.pose_trace, ref.pose_trace))
        assert e_h9 <= 2.0 * e_plain + 1e-5, (float(e_h9), float(e_plain))
    else:
        torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    if (d, nz, s_steps, use_heading) in _VARIANT_CASES and (not use_heading or s_steps == 256):
        # Over 256 sub-steps, or 16 and more without the heading update, S
        # is conditioned so that every fp32 route scatters around the
        # float64 witness, by up to ~0.2 in x and ~0.9 in P over 256
        # sub-steps without the heading update (F1), and which of the plain
        # version, the split schedule's kernels and H9 lands nearest changes
        # from frame to frame.  There H9 is held to the witness no further
        # than twice the farther of the other two routes, plus 1e-4; its
        # agreement with the split kernels within their fp32 bounds is held
        # above.
        wit = _witness(args)
        for a, b, c, w in ((got.x, ref.x, split.x, wit.x), (got.p, ref.p, split.p, wit.p)):
            e_h9, e_plain, e_split = ((t.double() - w).abs().max() for t in (a, b, c))
            assert e_h9 <= 2.0 * max(e_plain, e_split) + 1e-4, (
                float(e_h9), float(e_plain), float(e_split))
    elif not use_heading and s_steps >= 16:
        wit = _witness(args)
        for a, b, w in ((got.x, ref.x, wit.x), (got.p, ref.p, wit.p)):
            e_h9, e_plain = ((t.double() - w).abs().max() for t in (a, b))
            assert e_h9 <= 2.0 * e_plain + 1e-4, (float(e_h9), float(e_plain))
    else:
        torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    # One fixed order of every sum, no atomics: two calls are bit-identical;
    # the P pass mirrors the upper triangle: P stays exactly symmetric.
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got.p, got.p.T)


def test_frame_step_kernel_all_masked_is_factor_only(dev):
    args = list(_frame_args(dev, 2304, nz=64))
    args[11] = torch.zeros_like(args[11])
    got = fk.frame_step(*args)
    ref = fk.frame_step(*args, plain=True)
    torch.cuda.synchronize()
    _assert_frame_close(got, ref)
    assert float(got.nis) == 0.0


def test_frame_step_kernel_takes_strided_inputs(dev):
    # The driver hands H9 columns of the measurement buffer and of the truth
    # rollout: strided views, read in place.
    args = list(_frame_args(dev, 2304, nz=64))
    z = torch.stack([args[9], args[10]], dim=1)
    trace = torch.stack([args[6], args[6], args[6]], dim=1)
    args[9], args[10], args[6] = z[:, 0], z[:, 1], trace[:, 2]
    got = fk.frame_step(*args)
    ref = fk.frame_step(*(a.contiguous() if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_frame_step_kernel_replays_in_a_cuda_graph(dev):
    # H9's two launches captured in a CUDA graph and replayed give the eager
    # launches' bits: the C entry allocates nothing and launches on the
    # capturing stream, and the P pass's programmatic dependence on the
    # frame kernel is captured as a programmatic edge.
    args = _frame_args(dev, 2304, nz=64)
    eager = fk.frame_step(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        captured = fk.frame_step(*args)
    assert cuda.programmatic_edges(graph.raw_cuda_graph()) == 1
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_frame_step_plan(dev):
    # The frame kernel: one block an SM; the P pass at D 2304: H4's 32-tile
    # blocks, one a tile, 12 or 13 resident an SM (as H4's), without
    # spills; units of FS_UNIT = 24 columns at every MP.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk.frame_step_plan(2304, 128, dev)
    mp, rp = fk.frame_shapes(64)
    assert plan.grid == sms
    assert plan.block == fk.FS_THREADS
    assert plan.smem == fk._frame_step_smem_bytes(mp, rp, fk.frame_chain_plan(mp).band)
    assert (plan.bands, plan.panels, plan.tiles) == (64, 144, 72 * 73 // 2)
    assert (plan.unit, plan.units) == (24, 96)
    assert plan.tile == fk.PASS_SMALL == fk.pass_tile(2304, sms)
    assert plan.pass_block == 64 and plan.pass_occ >= 12 and plan.pass_grid == plan.tiles
    assert plan.pass_smem == 4 * 4 * 2 * 16 * 32 and plan.pass_local == 0
    tile, h4_grid = rank_update_plan(2304, dev)
    assert tile == fk.PASS_SMALL and h4_grid == sms * plan.pass_occ
    # At the 10k-landmark shape: the streamed 128-tiles, one 352-thread
    # block an SM with the strips' ring and P's ring of half-blocks, without
    # spills.
    big = fk.frame_step_plan(20_224, 128, dev)
    assert big.tile == fk.PASS_BIG == fk.pass_tile(20_224, sms) and big.tiles == 158 * 159 // 2
    assert big.pass_block == fk.SP_THREADS and big.pass_occ == 1 and big.pass_grid == sms
    assert big.pass_smem == fk.stream_pass_smem_bytes() and big.pass_local == 0
    assert fk.frame_pass_plan(20_224, dev) == fk.frame_pass_plan(20_224, dev, "tile128") == (
        128, sms, fk.SP_THREADS, fk.stream_pass_smem_bytes(), big.pass_regs, 0, 1, big.tiles)
    for rx in range(1, 8):
        p = fk.frame_step_plan(2304, 32 * rx, dev)
        assert p.unit == fk.FS_UNIT and p.grid == sms
        assert p.smem == fk._frame_step_smem_bytes(32 * rx, fk._round_up(3 + 32 * rx, 8),
                                                    fk.frame_chain_plan(32 * rx).band)


@pytest.mark.parametrize("d", [2304, 403])
def test_split_schedule_past_mp_224_matches_plain(dev, d):
    # MP 240 (NZ 120): past H1's registers the frame and the pair take the
    # split schedule, whose H1 is one cooperative launch; each against its
    # plain version.
    args = _frame_args(dev, d, nz=120)
    assert fk.frame_route(d, 120, dev, 6) == "split"
    cuda.reset_launch_counts()
    got = fk.frame_step(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "sweep_inverse": 1, "frame_chain": 1,
                      "frame_panels": 1, "rank_update": 1}
    _assert_frame_close(got, fk.frame_step(*args, plain=True))
    pargs = _pair_args(dev, d, nz=120)
    got = fk.frame_step_pair(*pargs)
    ref = fk.frame_step_pair(*pargs, plain=True)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


def test_frames_past_the_kernels_take_the_plain_route(dev):
    # Neither the port's kernels nor the reference's TPU schedules (D not a
    # multiple of 128) hold these frames: frame_step over 257 sub-steps, and
    # frame_update_obs at MP 2080 (NZ 1030), past H1's 2048.  Both run the
    # plain route on the card, as on the CPU.
    args = _frame_args(dev, 403, nz=10, s_steps=257)
    assert fk.frame_route(403, 10, dev, 257) == "plain"
    cpu = lambda a: a.cpu() if torch.is_tensor(a) else a   # noqa: E731
    cuda.reset_launch_counts()
    got = fk.frame_step(*args)
    st, fargs, meas = _gated_frame(dev, 2063, nz=1030)
    st1, _, vtf, bmat = _frame_factors_reference(st, *fargs)
    uargs = (st1.p, st1.x, *meas, bmat, vtf)
    assert fk.obs_route(2063, 1030, bmat.shape[0], dev) == "plain"
    got_obs = fk.frame_update_obs(*uargs)
    torch.cuda.synchronize()
    assert not any(k.launches for k in cuda.KERNELS.values())
    ref = fk.frame_step(*map(cpu, args))
    # Over 257 sub-steps the pose reaches ~200 m: a few ulps (1.5e-5 m) there.
    torch.testing.assert_close(got.pose_trace.cpu(), ref.pose_trace, rtol=1e-5, atol=1e-4)
    _assert_frame_close(fk.FrameStep(*map(cpu, got))._replace(pose_trace=ref.pose_trace), ref)
    ref_obs = fk.frame_update_obs(*map(cpu, uargs))
    # MP 2080: S's fp32 Cholesky on the card and on the CPU round apart by
    # ~3e-4 in the mean (S's conditioning at this size), so the mean is held
    # to a float64 witness: the card no further from it than twice the CPU,
    # plus the reference's 1e-4.
    wit = fk.frame_update_obs(*(a.cpu().double() if torch.is_tensor(a) and a.is_floating_point()
                                else cpu(a) for a in uargs))
    e_card, e_cpu = ((t.cpu().double() - wit.x).abs().max() for t in (got_obs.x, ref_obs.x))
    assert e_card <= 2.0 * e_cpu + 1e-4, (float(e_card), float(e_cpu))
    torch.testing.assert_close(got_obs.p.cpu(), ref_obs.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got_obs.nis.cpu(), ref_obs.nis, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("entry", ["frame_step", "frame_step_pair", "frame_factors_fused"])
def test_frames_only_the_reference_holds_raise(dev, entry):
    # 257 sub-steps at D = 2304 (the known frame, the pair) and D = 1024
    # (the gated frame's factors): the reference runs a TPU kernel there and
    # no kernel of the port holds the frame, so the card raises before any
    # launch.  (Every gated frame the reference's one-dispatch kernel holds
    # runs H10 or the split: tests/test_torch_obsstep.py.)
    cuda.reset_launch_counts()
    if entry == "frame_factors_fused":
        st, fargs, _ = _gated_frame(dev, 1024, s_steps=257)
        with pytest.raises(ValueError, match="reference runs a TPU kernel"):
            frame_factors_fused(st, *fargs)
    else:
        args = _frame_args(dev, 2304, nz=10, s_steps=257)
        assert fk.frame_route(2304, 10, dev, 257) == "unported"
        p, x, slots, cap, *rest = args
        rows = fk.frame_rows(slots, cap)
        ctrl, meas = tuple(rest[:4]), tuple(rest[5:8])
        with pytest.raises(ValueError, match="reference runs a TPU kernel"):
            if entry == "frame_step":
                fk.frame_step(*args)
            else:
                fk.frame_step_pair(p, x, rows, ctrl, meas, rows, ctrl, meas, rest[4], rest[8],
                                   *rest[9:])
    torch.cuda.synchronize()
    assert not any(k.launches for k in cuda.KERNELS.values())


# H2's bands and H3's panels: MP 32, 128 and 224, S = 1, 6 and 16, the
# heading update on and off, at the bench D, a ragged D and a D smaller
# than one 16-column panel (5 landmarks, MP 32).
_CHAIN_CASES = [(d, nz, s, h) for d in (2304, 2051) for nz in (10, 64, 112)
                for s in (1, 6, 16) for h in (True, False)]
_CHAIN_CASES += [(13, 5, s, h) for s in (1, 6, 16) for h in (True, False)]


@pytest.mark.parametrize("d,nz,s_steps,use_heading", _CHAIN_CASES)
def test_chain_and_panels_kernels_match_plain(dev, d, nz, s_steps, use_heading):
    p, x, slots, cap, *rest = _frame_args(dev, d, nz=nz, s_steps=s_steps, use_heading=use_heading)
    fi = fk.frame_inputs(p, x, fk.frame_rows(slots, cap), *rest[:9])
    chain = (fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp, *rest[9:])
    cuda.reset_launch_counts()
    ch_k, ch_again = fk.frame_chain(*chain), fk.frame_chain(*chain)
    ch_p = fk._frame_chain_reference(*chain)
    si = sweep_si_reference(ch_p.s, fi.nblk)
    pargs = (ch_p.rowc, ch_p.ms, si, fi.prows, x)
    pk, pk_again = fk.frame_panels(*pargs), fk.frame_panels(*pargs)
    pp = fk._frame_panels_reference(*pargs)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "frame_chain": 2, "frame_panels": 2}
    # chip_smoke.py phase 3a's tolerances: same algebra, fp32 order and
    # FMA contraction; K4 carries the heading gain's amplified cancellation.
    torch.testing.assert_close(ch_k.pt, ch_p.pt, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(ch_k.rowc[:, :7], ch_p.rowc[:, :7], rtol=1e-3, atol=1e-6)
    torch.testing.assert_close(ch_k.rowc[:, 7], ch_p.rowc[:, 7], rtol=0, atol=5e-4)
    torch.testing.assert_close(ch_k.ms, ch_p.ms, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(ch_k.k4, ch_p.k4, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(ch_k.s, ch_p.s, rtol=1e-3, atol=1e-6 * float(ch_p.s.abs().max()))
    torch.testing.assert_close(pk[0], pp[0], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(pk[1], pp[1], rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(pk[2], pp[2], rtol=1e-4, atol=1e-5)
    # One fixed order of every sum, no atomics: two calls are bit-identical.
    for a, b in zip((*ch_k, *pk), (*ch_again, *pk_again)):
        assert torch.equal(a, b)


def test_recursion_sincos_is_cudas_sincosf(dev, tmp_path):
    # The recursion's csl_sincosf (no local memory) gives CUDA's sincosf
    # bits for every float with |x| < 105,615, NaN and inf: 2^32 inputs.
    import subprocess
    from pathlib import Path

    exe = tmp_path / "sincos_check"
    subprocess.run([cuda._nvcc(), *cuda.NVCC_FLAGS, "-I", str(cuda.CSRC), "-o", str(exe),
                    str(Path(__file__).with_name("cuda_sincos_check.cu"))],
                   check=True, capture_output=True)
    res = subprocess.run([str(exe)], capture_output=True, text=True)
    assert res.returncode == 0, res.stdout + res.stderr


# Every even size up to MAX_MP, and the sweep bound from none to all; past
# it, the cooperative sweep.
_SWEEP_CASES = [(mp, nblk) for mp in (2, 60, 128, 224) for nblk in (0, 1, 7, mp // 2)] + [(128, 40)]
_SWEEP_CASES += [(mp, nblk) for mp in (226, 480) for nblk in (0, 1, 7, mp // 2)] + [(2048, 1024)]


@pytest.mark.parametrize("mp,nblk", _SWEEP_CASES)
def test_sweep_inverse_kernel_matches_plain(dev, mp, nblk):
    g = torch.Generator(device=dev).manual_seed(mp * 100 + nblk)
    a = torch.randn((mp, mp), generator=g, device=dev)
    s = a @ a.T / mp + torch.eye(mp, device=dev)
    nb = torch.tensor([nblk], dtype=torch.int32, device=dev)
    got = sweep_si(s, nb)
    torch.cuda.synchronize()
    # Same sweep; fp32 contraction differs: a few ulps of |S^-1| ~ 1.
    torch.testing.assert_close(got, sweep_si_reference(s, nb), rtol=1e-4, atol=1e-5)
    assert torch.equal(got, got.T)
    # An asymmetric S gives an exactly symmetric S^-1 of sym(S); a
    # non-finite entry zeroes the whole output.
    e = torch.randn((mp, mp), generator=g, device=dev) * 1e-3
    asym = sweep_si(s + (e - e.T), nb)
    assert torch.equal(asym, asym.T)
    bad = s.clone()
    bad[mp - 1, 0] = float("nan")
    assert torch.equal(sweep_si(bad, nb), torch.zeros_like(s))


def test_spd_inverse_kernel_odd_size_and_guard(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((61, 61), generator=g, device=dev)
    s = a @ a.T / 61 + torch.eye(61, device=dev)
    torch.testing.assert_close(spd_inverse(s), spd_inverse_reference(s), rtol=1e-3, atol=1e-4)
    bad = torch.full((8, 8), float("nan"), device=dev)
    assert torch.equal(spd_inverse(bad), torch.zeros_like(bad))


@pytest.mark.parametrize("r", [1, 8, 136, 152, 272])
@pytest.mark.parametrize("d", [64, 203, 256, 1003, 1024, 2051, 2304])
def test_rank_update_kernel_matches_plain(dev, d, r):
    # A symmetric P and B, as every caller's: the kernel computes the upper
    # triangle of Vt^T B Vt and mirrors it.  B / r keeps the update O(1).
    g = torch.Generator(device=dev).manual_seed(d * 1000 + r)
    a = torch.randn((d, d), generator=g, device=dev)
    p = 0.5 * (a + a.T)
    vt = torch.randn((r, d), generator=g, device=dev)
    c = torch.randn((r, r), generator=g, device=dev)
    b = 0.5 * (c + c.T) / r
    vbt = b @ vt
    got = rank_update_vbt(p, vt, vbt)
    again = rank_update_vbt(p, vt, vbt)
    via_b = rank_update_t(p, vt, b)
    torch.cuda.synchronize()
    # fp32 sums of r O(1/sqrt(r)) products, in another order than cuBLAS.
    torch.testing.assert_close(got, rank_update_vbt_reference(p, vt, vbt), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(via_b, rank_update_t_reference(p, vt, b), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, got.T)          # exactly symmetric in, exactly symmetric out
    assert torch.equal(got, again)          # one fixed summation order: bit-identical


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    p = torch.randn((64, 64), device=dev)
    vt = torch.randn((8, 64), device=dev)
    b = torch.randn((8, 8), device=dev)
    with pytest.raises(ValueError):
        rank_update_t(p.double(), vt.double(), b.double())
    with pytest.raises(ValueError):
        rank_update_t(p.T, vt, b)                       # not contiguous
    with pytest.raises(ValueError):
        sweep_si(p, torch.tensor([4], device=dev))      # nblk must be int32


def _gated_frame(dev, d, use_heading=True, nz=10, s_steps=6):
    """A frame-start state (an exactly symmetric P), its H5 arguments, and
    the frame's measurement inputs as frame_update_obs takes them: (slots,
    capacity, zr, zb, mask, r_cov)."""
    (p, x, slots, cap, vns, swans, phis, actives, q, zr, zb, mask, r, wb, dt, sh,
     _) = _frame_args(dev, d, nz=nz, s_steps=s_steps)
    from conan_slam_tpu_torch.filters.ekf.state import EKFState

    st = EKFState(x=x, p=0.5 * (p + p.T), n_active=torch.tensor(0, device=dev),
                  table=torch.zeros(1, dtype=torch.int64, device=dev))
    fargs = (vns, swans, phis, actives, q, wb, dt, sh, use_heading)
    return st, fargs, (slots, cap, zr, zb, mask, r)


@pytest.mark.parametrize("d,use_heading", [(256, True), (203, True), (256, False)])
def test_factor_strip_kernel_matches_plain(dev, d, use_heading):
    st, fargs, _ = _gated_frame(dev, d, use_heading)
    cuda.reset_launch_counts()
    got = frame_factors_fused(st, *fargs)
    ref = _frame_factors_reference(st, *fargs)
    torch.cuda.synchronize()
    assert cuda.KERNELS["factor_strip"].launches == 1
    # The reference's own factor-kernel tolerances (tests/test_pallas_ops.py).
    torch.testing.assert_close(got[0].x, ref[0].x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-6)
    nb = 2 + 2 * 6 + (6 if use_heading else 0)
    assert torch.equal(got[2][nb:], torch.zeros_like(got[2][nb:]))


@pytest.mark.parametrize("k", [87, 10_110])
def test_gating_scores_kernel_matches_plain(dev, k):
    rng = np.random.default_rng(k)
    lm = rng.uniform(-60, 60, size=(k, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.4, pad_multiple=0, device=dev)
    a = torch.as_tensor(rng.normal(size=(st.x.shape[0], 6)).astype(np.float32) * 0.03).to(dev)
    st = st._replace(p=st.p + a @ a.T, n_active=torch.tensor(k - 5, device=dev))
    ids = rng.choice(k - 5, size=64, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=64) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=64) * 0.01], -1)
    z[-1] = [500.0, 1.0]
    z = torch.as_tensor(z.astype(np.float32)).to(dev)
    r = torch.diag(torch.tensor([0.1**2, (np.pi / 180) ** 2], device=dev))
    pvv, pvm, pjj = _innovation_blocks(st)
    args = (z, st.pose, st.features, st.active_mask, pvv.contiguous(), pvm.contiguous(),
            pjj.contiguous(), r, 50.0)
    cuda.reset_launch_counts()
    nd, j, mn = gating_scores(*args)
    rnd, rj, rmn = _gating_scores_reference(*args)
    torch.cuda.synchronize()
    assert cuda.KERNELS["gating_scores"].launches == 1
    # Same algebra; atan2f/remainder wrap and FMA contraction differ by ulps.
    torch.testing.assert_close(nd, rnd, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(mn, rmn, rtol=1e-4, atol=1e-3)
    found = rnd < 1e38
    assert torch.equal(nd < 1e38, found) and bool(found[:-1].all()) and not bool(found[-1])
    assert torch.equal(j[found], rj[found]) and int(j[-1]) == -1


def _gate_case(dev, d, seed, use_heading=True, tie=None, nz=64, s_steps=6):
    """H15's arguments at D = d: a frame-start state with its slots mapped
    (five inactive) and an exactly symmetric P, a frame's ``s_steps``
    controls, and ``nz`` measurements of active landmarks from the
    post-frame pose (one masked, the last far from every slot).  ``tie`` =
    (j1, j2) makes slot j2 a copy of slot j1 and measurement 0 an exact
    measurement of it."""
    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-60, 60, size=(cap, 2)).astype(np.float32)
    if tie is not None:
        lm[tie[1]] = lm[tie[0]]
    st = init_state_with_map(torch.as_tensor(lm, device=dev), sigma0=0.4,
                             pad_multiple=128 if d % 128 == 0 else 0)
    assert st.x.shape[0] == d
    a = torch.as_tensor(rng.normal(size=(d, 6)).astype(np.float32) * 0.03, device=dev)
    p = st.p + a @ a.T
    if tie is not None:
        r1, r2 = (3 + 2 * j + torch.arange(2, device=dev) for j in tie)
        p[r2, :] = p[r1, :]
        p[:, r2] = p[:, r1]
    st = st._replace(p=0.5 * (p + p.T), n_active=torch.tensor(cap - 5, device=dev))
    t = lambda v: torch.as_tensor(np.asarray(v)).to(dev)  # noqa: E731
    fargs = (t((83.33 + rng.normal(size=s_steps) * 0.3).astype(np.float32)),
             t((rng.normal(size=s_steps) * 0.2).astype(np.float32)),
             t((rng.normal(size=s_steps) * 0.5).astype(np.float32)),
             t(np.arange(s_steps) < max(1, s_steps - 1)),
             t(np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32)),
             73.0, 0.01, 0.01 * np.pi / 180, use_heading)
    pose = _frame_factors_reference(st, *fargs)[0].x[:3].cpu().numpy()
    ids = rng.choice(cap - 5, size=nz, replace=False)
    if tie is not None:
        ids[0] = tie[0]
    dl = lm[ids] - pose[:2]
    z = np.stack([np.hypot(dl[:, 0], dl[:, 1]) + rng.normal(size=nz) * 0.05,
                  np.arctan2(dl[:, 1], dl[:, 0]) - pose[2] + rng.normal(size=nz) * 0.005], -1)
    if tie is not None:
        z[0] = [np.hypot(*dl[0]), np.arctan2(dl[0, 1], dl[0, 0]) - pose[2]]
    z[-1] = [500.0, 1.0]
    mask = np.ones(nz, bool)
    mask[-2] = False
    r = t(np.diag([0.1**2, (np.pi / 180) ** 2]).astype(np.float32))
    return (st, *fargs, t(z.astype(np.float32)), t(mask), r, 50.0, 1000.0)


def _assert_gating_close(got, ref, margins_of):
    """A gating's (best_nd, best_j, min_nis) against its plain version's:
    nd and min NIS rtol 1e-4 / atol 1e-3 (same algebra; atan2f, the
    remainder wrap and FMA contraction move a NIS by ~1e-4); found and the
    best slot equal except a measurement with a slot's nis within that
    tolerance of gate_reject, or with a runner-up nd within it of the best
    (``margins_of()``: (near_reject, tie) from the dense scores)."""
    (nd, j, mn), (rnd, rj, rmn) = got, ref
    found, rfound = nd < 1e38, rnd < 1e38
    both = found & rfound
    torch.testing.assert_close(nd[both], rnd[both], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(mn, rmn, rtol=1e-4, atol=1e-3)
    near_reject, tie = margins_of()
    assert bool(((found == rfound) | near_reject).all())
    exact = both & ~tie
    assert torch.equal(j[exact], rj[exact]) and bool(exact.sum() >= 32)
    assert not bool(found[-1]) and int(j[-1]) == -1          # the far measurement


def _margins(st1, z, r, vtf, bmat, gate_reject):
    from conan_slam_tpu_torch.filters.ekf.associate import gated_scores_dense

    def margins():
        nis, nd = gated_scores_dense(st1, z, r, vtf.T, bmat)
        nd_g = torch.where(nis < gate_reject, nd, torch.inf)
        two = nd_g.topk(2, dim=1, largest=False).values
        tol = lambda v: 1e-3 + 1e-4 * v.abs()  # noqa: E731
        near = ((nis - gate_reject).abs() <= tol(torch.tensor(gate_reject))).any(dim=1)
        return near, (two[:, 1] - two[:, 0]) <= tol(two[:, 0])
    return margins


# config 2's unpadded D, a D below one strip block's 256 columns past it,
# and the 10k shape's K (10,110 slots: 158 gating blocks of 64 slots); at
# config 2's D, 33 sub-steps (the recursion's terms past one warp's lanes,
# 101 factor columns in the fold) and NZ 100 and 300 (two thread groups a
# tile; one, striding past the block's 256 threads).
@pytest.mark.parametrize("d,use_heading,nz,s_steps", [
    (256, True, 64, 6), (203, True, 64, 6), (256, False, 64, 6), (1003, True, 64, 6),
    (20_224, True, 64, 6), (1024, True, 64, 33), (1024, True, 100, 6), (1024, False, 300, 6),
])
def test_factor_gate_kernel_matches_plain(dev, d, use_heading, nz, s_steps):
    args = _gate_case(dev, d, 101 + d, use_heading, nz=nz, s_steps=s_steps)
    cuda.reset_launch_counts()
    got = factor_gate(*args)
    ref = _factor_gate_reference(*args)
    h5 = frame_factors_fused(*args[:10])
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "factor_gate": 1, "factor_strip": 1}
    # The factors: H5's entry's device code, bit for bit; against the plain
    # version at the reference's factor-kernel tolerances.
    for a, b in zip(got[:4], (h5[0].x, *h5[1:])):
        assert torch.equal(a, b)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.vtf, ref.vtf, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.bmat, ref.bmat, rtol=1e-5, atol=1e-6)
    st1 = args[0]._replace(x=ref.x)
    _assert_gating_close(got[4:7], ref[4:7],
                         _margins(st1, args[10], args[12], ref.vtf, ref.bmat, args[13]))
    # The association result is associate_gated's mask rule on its scores.
    found = got.best_nd < 1e38
    mask = args[11]
    assert torch.equal(got.known_mask, mask & found)
    assert torch.equal(got.slots, torch.where(found, got.best_j.to(torch.int64), 0))
    assert torch.equal(got.new_mask, mask & ~found & (got.min_nis > args[14]))
    assert bool(got.new_mask[-1]) and not bool(got.known_mask[-2])


def test_factor_gate_kernel_breaks_an_exact_tie_to_the_lower_slot(dev):
    # Slot 150 copies slot 7, and measurement 0 measures it: the two score
    # the same nd exactly, in different gating blocks (32 slots a block),
    # and the packed (nd, j) minimum keeps the lower slot, as the plain
    # version's argmin does.
    args = _gate_case(dev, 1024, 7, tie=(7, 150))
    got = factor_gate(*args)
    ref = _factor_gate_reference(*args)
    torch.cuda.synchronize()
    assert int(ref.best_j[0]) == 7 and int(got.best_j[0]) == 7
    assert bool(got.known_mask[0]) and int(got.slots[0]) == 7


def test_factor_gate_kernel_resets_its_scratch(dev):
    # Two frames in a row equal two fresh launches: the last gating block
    # leaves the reduction's scratch as it found it.
    a1 = _gate_case(dev, 1024, 11)
    a2 = _gate_case(dev, 1024, 12)
    first = [factor_gate(*a1), factor_gate(*a2)]
    torch.cuda.synchronize()
    from conan_slam_tpu_torch.ops import gating_kernel

    gating_kernel._scratch.clear()          # fresh scratch for each launch
    fresh = []
    for a in (a1, a2):
        fresh.append(factor_gate(*a))
        torch.cuda.synchronize()
        gating_kernel._scratch.clear()
    for got, want in zip(first, fresh):
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert not torch.equal(first[0].best_nd, first[1].best_nd)


def test_factor_gate_kernel_on_two_streams(dev):
    # Launches on two streams at once each use their stream's scratch, so
    # each equals its frame launched alone.
    from conan_slam_tpu_torch.ops import gating_kernel

    a1 = _gate_case(dev, 1024, 14)
    a2 = _gate_case(dev, 1024, 15)
    want = [factor_gate(*a1), factor_gate(*a2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = [[], []]
    for _ in range(10):
        for s, a, out in zip(streams, (a1, a2), got):
            with torch.cuda.stream(s):
                out.append(factor_gate(*a))
    torch.cuda.synchronize()
    for outs, w in zip(got, want):
        for o in outs:
            assert all(torch.equal(x, y) for x, y in zip(o, w))
    keys = {(torch.device(dev), s.cuda_stream, 64) for s in streams}
    assert keys <= set(gating_kernel._scratch)


def test_factor_gate_kernel_replays_in_a_cuda_graph(dev):
    # One captured H15 launch replays the eager launch's bits, and replays
    # again (the scratch resets inside the graph too).  The capture uses
    # its stream's scratch, which an eager launch on that stream makes
    # first; a first launch during the capture raises instead of taking a
    # buffer from the graph's pool.
    args = _gate_case(dev, 1024, 13)
    eager = factor_gate(*args)
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    with pytest.raises(RuntimeError, match="before capturing"):
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=stream):
            factor_gate(*args)
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        factor_gate(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = factor_gate(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


@pytest.mark.parametrize("d", [256, 203])
def test_gated_frame_kernels_match_plain_versions(dev, d):
    st, fargs, (slots, cap, zr, zb, mask, r) = _gated_frame(dev, d)
    st1, _, vtf, bmat = _frame_factors_reference(st, *fargs)
    args = (st1.p, st1.x, slots, cap, zr, zb, mask, r, bmat, vtf)
    oi = fk.obs_inputs(st1.p, st1.x, fk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    chain = (oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    s_k, rowc_k, hvb_k = fk.obs_chain(*chain)
    s_p, rowc_p, hvb_p = fk._obs_chain_reference(*chain)
    # Compact vs dense Hc products, fp32 summation order.
    torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-6 * float(s_p.abs().max()))
    torch.testing.assert_close(rowc_k, rowc_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hvb_k, hvb_p, rtol=1e-4, atol=1e-6)
    si = sweep_si_reference(s_p, oi.nblk)
    pk = fk.obs_panels(rowc_p, hvb_p, si, oi.prows, vtf, st1.x)
    pp = fk._obs_panels_reference(rowc_p, hvb_p, si, oi.prows, vtf, st1.x)
    for got, ref in zip(pk, pp):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)
    # The default route (H10, one launch) and the split schedule (H7, H1,
    # H8, H4 once each), each against its plain version.
    for schedule, want in (("auto", {"obs_step": fk.OS_LAUNCHES}),
                           ("split", {"obs_chain": 1, "sweep_inverse": 1, "obs_panels": 1,
                                      "rank_update": 1})):
        cuda.reset_launch_counts()
        got = fk.frame_update_obs(*args, schedule=schedule)
        ref = fk.frame_update_obs(*args, plain=True, schedule=schedule)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda.KERNELS.values()}
        assert counts == {**dict.fromkeys(counts, 0), **want}
        torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


def test_gated_run_matches_plain(dev):
    # 600 steps of BASELINE config 2 from an empty map: H15 (the factors
    # and the association) once a frame and H10's two kernels, H5's and
    # H6's own entries never, H2/H3 never, and the run maps landmarks as
    # the plain versions do.
    world = config2_world(device=dev)
    cfg = SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)
    out = {}
    for plain in (False, True):
        cuda.reset_launch_counts()
        gen = torch.Generator(device=dev).manual_seed(0)
        out[plain] = run_ekf_slam_precomputed(world, cfg, gen, 600, plain=plain)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda.KERNELS.values()}
        if plain:
            assert not any(counts.values())
        else:
            want = {"factor_gate": 100, "obs_step": 100 * fk.OS_LAUNCHES}
            assert counts == {**dict.fromkeys(counts, 0), **want}
    (sk, ok), (sp, op) = out[False], out[True]
    assert bool(torch.isfinite(sk.p).all()) and int(sk.n_active) > 0
    assert torch.equal(ok.n_active, op.n_active)
    # The same association over 100 frames: trajectories agree to the
    # ulp-level drift of ~5 km positions (slice 1's bound).
    torch.testing.assert_close(ok.x_est, op.x_est, rtol=0, atol=2e-2)


def _obs_args(dev, d, nz, s_steps=6, use_heading=True):
    """A gated frame at D = d: frame_update_obs's arguments, the factors
    from H5's plain version (NBP 16, 24 or 56 at S 6 without and with the
    heading update, S 18 with it)."""
    st, fargs, meas = _gated_frame(dev, d, use_heading, nz=nz, s_steps=s_steps)
    st1, _, vtf, bmat = _frame_factors_reference(st, *fargs)
    return (st1.p, st1.x, *meas, bmat, vtf)


def _obs_ulp_bounds(args, got):
    """Elementwise bounds on two fp32 routes of one gated frame that differ
    only in the order of their sums (H10 and the split: the same chain,
    sweep and pht code; M G and the mean summed in other orders).  Each
    rounds two nested sums of at most r = MP + NBP + 8 terms, each within
    r eps of its terms' magnitudes to first order: 4 r eps times |P| +
    |G|^T |M| |G| for P, |x| + |xn| + |v|^T |S^-1| |pht| for the mean,
    |v|^T |S^-1| |v| for the NIS, from the plain versions."""
    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = args
    oi = fk.obs_inputs(p, x, fk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    s, rowc, hvb = fk._obs_chain_reference(oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    si = sweep_si_reference(s, oi.nblk)
    pht = fk._obs_panels_reference(rowc, hvb, si, oi.prows, vtf, x)[0]
    gmat = torch.cat([vtf, pht]).abs()
    mabs = torch.block_diag(bmat.abs(), si.abs())
    vsi = rowc[:, 7].abs() @ si.abs()
    u = 4.0 * (oi.mp + bmat.shape[0] + 8) * 2.0**-23
    return dict(x=u * (x.abs() + got.x.abs() + vsi @ pht.abs()),
                p=u * (p.abs() + gmat.T @ (mabs @ gmat)), nis=u * (vsi @ rowc[:, 7].abs()))


# H10 over MP 32, 128 and 224, NBP 16, 24 and 56, at config 2's D, an
# unpadded D and a D smaller than one tile.
_OBS_CASES = [(d, nz, s, h) for d in (1024, 1003) for nz in (10, 64, 112)
              for s, h in ((6, False), (6, True), (18, True))]
_OBS_CASES += [(13, 5, s, h) for s, h in ((6, False), (6, True), (18, True))]
_OBS_CASES += [(67, 30, 6, h) for h in (False, True)]     # the valet loop's shape


@pytest.mark.parametrize("d,nz,s_steps,use_heading", _OBS_CASES)
def test_obs_step_kernel_matches_plain(dev, d, nz, s_steps, use_heading):
    args = _obs_args(dev, d, nz, s_steps, use_heading)
    nbp = args[8].shape[0]
    assert fk.obs_route(d, nz, nbp, dev) == "resident"
    cuda.reset_launch_counts()
    got, again = fk.frame_update_obs(*args), fk.frame_update_obs(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    # Two launches a call (the frame kernel, then the P pass), two calls.
    assert counts == {**dict.fromkeys(counts, 0), "obs_step": 2 * fk.OS_LAUNCHES}
    # Against the split schedule's kernels (H7, H1, H8, H4): the same device
    # code up to the order of M G's and the mean's sums (_obs_ulp_bounds).
    split = fk.frame_update_obs(*args, schedule="split")
    for key, tol in _obs_ulp_bounds(args, got).items():
        err = (getattr(got, key) - getattr(split, key)).abs()
        assert bool((err <= tol).all()), (key, float(err.max()), float((err - tol).max()))
    # Against its plain version at the reference's megakernel tolerances.
    ref = fk.frame_update_obs(*args, plain=True)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    # No atomics: two calls bit-identical; the mirrored P pass keeps an
    # exactly symmetric P exactly symmetric.
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got.p, got.p.T)


def _obs_witness(args):
    """The gated frame in float64 through the port's independent oracle
    (dense products and a Cholesky inverse, neither H10 nor the split)."""
    import torch.nn.functional as F

    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = args
    rows = fk.frame_rows(slots, cap)
    f64 = torch.float64
    mp, rp = fk.frame_shapes(zr.shape[0])
    zin, rsc, _ = fk._pack_meas(zr.to(f64), zb.to(f64), mask, r.to(f64), mp // 2)
    pad = rp - rows.shape[0]
    return fk._frame_update_obs_reference(p.to(f64), x.to(f64), F.pad(rows, (0, pad), value=-1),
                                          F.pad(p[rows].to(f64), (0, 0, 0, pad)), zin, rsc,
                                          bmat.to(f64), vtf.to(f64), mp, rp)


def test_obs_step_kernel_at_the_resident_edge(dev):
    # MP 224 with NBP 216 (S 71 with the heading update): the largest NBP
    # that stays resident there, its pht units 8 columns wide.  Against the
    # split kernels within the fp32 bound of the sums they order
    # differently; P and the NIS against the plain version at the
    # reference's megakernel tolerances.  This frame's S is ill-conditioned
    # (NIS ~2.7e6): the fp32 routes' means lie 1.5e-4 (plain) to 4.5e-4
    # (H10 and the split, which share the chain's and the sweep's device
    # code) from a float64 witness, so the mean is held to the witness
    # within twice the farther of the plain version and the split kernels
    # plus the megakernel tolerance, as the known frame's F1-conditioned
    # cases are (test_frame_step_kernel_matches_plain).
    args = _obs_args(dev, 1024, 112, 71, True)
    nbp = args[8].shape[0]
    assert nbp == 216 and fk.obs_route(1024, 112, nbp, dev) == "resident"
    assert fk.obs_route(1024, 112, nbp + 8, dev) == "split"
    assert fk.obs_step_plan(1024, 224, nbp, dev).unit == 8
    cuda.reset_launch_counts()
    got, again = fk.frame_update_obs(*args), fk.frame_update_obs(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "obs_step": 2 * fk.OS_LAUNCHES}
    split = fk.frame_update_obs(*args, schedule="split")
    for key, tol in _obs_ulp_bounds(args, got).items():
        err = (getattr(got, key) - getattr(split, key)).abs()
        assert bool((err <= tol).all()), (key, float(err.max()), float((err - tol).max()))
    ref = fk.frame_update_obs(*args, plain=True)
    wit = _obs_witness(args)
    far = max(float((r.x.double() - wit.x).abs().max()) for r in (ref, split))
    assert float((got.x.double() - wit.x).abs().max()) <= 2.0 * far + 1e-4
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    assert torch.equal(got.p, got.p.T)


def test_obs_step_kernel_all_masked_is_factor_only(dev):
    args = list(_obs_args(dev, 1024, 64))
    args[6] = torch.zeros_like(args[6])
    got = fk.frame_update_obs(*args)
    ref = fk.frame_update_obs(*args, plain=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.x, args[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    assert float(got.nis) == 0.0


def test_obs_step_kernel_takes_strided_inputs(dev):
    # The frame loop hands H10 the columns of the measurement buffer and the
    # association's slots: strided views, read in place.
    args = list(_obs_args(dev, 1024, 64))
    z = torch.stack([args[4], args[5]], dim=1)
    sl = torch.stack([args[2], args[2]], dim=1)
    args[4], args[5], args[2] = z[:, 0], z[:, 1], sl[:, 1]
    got = fk.frame_update_obs(*args)
    ref = fk.frame_update_obs(*(a.contiguous() if torch.is_tensor(a) else a for a in args))
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_obs_step_kernel_replays_in_a_cuda_graph(dev):
    # H10's two launches captured in a CUDA graph and replayed give the
    # eager launches' bits, the P pass's programmatic dependence on the
    # frame kernel captured as a programmatic edge.
    args = _obs_args(dev, 1024, 64)
    eager = fk.frame_update_obs(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        captured = fk.frame_update_obs(*args)
    assert cuda.programmatic_edges(graph.raw_cuda_graph()) == 1
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_obs_step_plan(dev):
    # The frame kernel: one block an SM, units of 8 columns at config 2's
    # D (128 units on the 131 blocks beside the sweep's: one round), up to
    # 32 at the 10k shape; the P pass: H4's 32-tile blocks, one a tile,
    # without spills.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk.obs_step_plan(1024, 128, 24, dev)
    mp, rp = fk.frame_shapes(64)
    assert plan.grid == sms and plan.block == fk.OS_THREADS and plan.tile == 32
    assert plan.unit == fk.obs_step_unit(1024, mp, rp, 24, sms) == 8
    assert plan.units == 128 <= sms - 1
    assert plan.smem == fk._obs_step_smem_bytes(mp, rp, 24, plan.unit)
    assert (plan.bands, plan.tiles) == (64, 32 * 33 // 2)
    # 528 tiles, 4 an SM: each pass block asks for an SM's shared memory
    # over 4 (H4's ring needs 16 KB), so that no SM takes more than 4 and
    # the tiles spread over every SM.
    assert plan.pass_block == 64 and plan.pass_grid == plan.tiles and plan.pass_local == 0
    assert plan.pass_occ == -(-plan.tiles // sms) == 4
    assert 4 * 4 * 2 * 16 * 32 < plan.pass_smem <= 233_472 // 4 - 1024
    # At the 10k shape: H9's streamed 128-tiles, one 352-thread block an
    # SM, without spills.
    big = fk.obs_step_plan(20_224, 128, 24, dev)
    assert big.tile == fk.PASS_BIG and big.tiles == 158 * 159 // 2
    assert big.pass_block == fk.SP_THREADS and big.pass_occ == 1 and big.pass_grid == sms
    assert big.pass_smem == fk.stream_pass_smem_bytes() and big.pass_local == 0
    assert big.unit == fk.obs_step_unit(20_224, mp, rp, 24, sms) == 32
    for rx in range(1, 8):
        m = 32 * rx
        r = fk._round_up(3 + m, 8)
        p = fk.obs_step_plan(1024, m, 24, dev)
        assert p.grid == sms and p.unit == fk.obs_step_unit(1024, m, r, 24, sms)
        assert p.smem == fk._obs_step_smem_bytes(m, r, 24, p.unit)
    # MP 224 at the largest NBP that stays resident: a unit of 8 columns.
    p = fk.obs_step_plan(20_224, 224, 216, dev)
    assert p.unit == 8 and p.smem == fk._obs_step_smem_bytes(224, 232, 216, 8)


def _pass_inputs(dev, d, r, seed=5):
    """An exactly symmetric P (D, D) and strips G, MG (r, D rounded up to 4)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ldg = fk._round_up(d, 4)
    a = torch.randn(d, 8, device=dev, generator=gen)
    p = a @ a.T
    return (0.5 * (p + p.T), torch.randn(r, ldg, device=dev, generator=gen),
            torch.randn(r, ldg, device=dev, generator=gen))


# The streamed 128-tiles against H4's 32-tiles on the same strips: the long
# loop's D 10,240, the 10k-landmark D 20,224 and D 10,100 (79 tiles a side,
# the last 116 wide); r the known frame's MP + 8 = 136, the gated frame's
# NBP + MP = 152 at the 10k shape and 27 (a last k-chunk of 11 rows).
@pytest.mark.parametrize("r", [136, 152, 27])
@pytest.mark.parametrize("d", [10_240, 20_224, 10_100])
def test_stream_pass_equals_the_32_tiles(dev, d, r):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert fk.pass_tile(d, sms) == fk.frame_pass_plan(d, dev).tile == fk.PASS_BIG
    p, g, mg = _pass_inputs(dev, d, r)
    ref = fk.frame_pass(p, g, mg, "tile32")
    got, again, auto = (fk.frame_pass(p, g, mg, "tile128"), fk.frame_pass(p, g, mg, "tile128"),
                        fk.frame_pass(p, g, mg))
    h4 = rank_update_vbt(p, g, mg)
    torch.cuda.synchronize()
    # Bit for bit the 32-tiles and H4's own entry (its Cfg<128> tiles at
    # these D), exactly symmetric, and the same bits on a repeat call and
    # on the frames' own route.
    assert rank_update_plan(d, dev)[0] == 128
    assert torch.equal(got, ref) and torch.equal(h4, ref)
    assert torch.equal(got, got.T)
    assert torch.equal(again, got) and torch.equal(auto, got)
    # Against one matmul (TF32 off), its upper triangle mirrored as the
    # pass mirrors it: fp32 sums of r terms in other orders.
    full = g[:, :d].T @ mg[:, :d]
    ref = p + torch.triu(full) + torch.triu(full, 1).T
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


def test_stream_pass_leaves_unaligned_p_rows_to_the_32_tiles(dev):
    # P rows that take no 16-byte copies (D % 4 != 0, or P 4 bytes past a
    # 16-byte boundary) run the 32-tiles at every D: the frames' rule
    # picks them, and the streamed pass refuses such a P.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p, g, mg = _pass_inputs(dev, 10_238, 136)
    assert fk.pass_tile(10_238, sms, vec=False) == fk.PASS_SMALL
    assert torch.equal(fk.frame_pass(p, g, mg), fk.frame_pass(p, g, mg, "tile32"))
    with pytest.raises(RuntimeError):
        fk.frame_pass(p, g, mg, "tile128")
    p, g, mg = _pass_inputs(dev, 10_240, 136)
    off = torch.empty(10_240 * 10_240 + 1, device=dev)[1:].view(10_240, 10_240)
    off.copy_(p)
    assert off.data_ptr() % 16 == 4
    assert torch.equal(fk.frame_pass(off, g, mg), fk.frame_pass(p, g, mg, "tile32"))
    with pytest.raises(RuntimeError):
        fk.frame_pass(off, g, mg, "tile128")
    torch.cuda.synchronize()


def test_frames_at_the_10k_shape_take_the_stream_pass(dev):
    # H9 (the known frame, 64 returns) and H10 (the gated frame) at D
    # 20,224 through their C entries against their plain versions, the
    # tracer counting each frame's P-pass route.
    args = _frame_args(dev, 20_224, nz=64)
    cuda.reset_launch_counts()
    with profiling.tracing():
        got = fk.frame_step(*args)
        torch.cuda.synchronize()
    taken = profiling.take()
    assert taken.counters.get("pass.tile128") == 1 and "pass.tile32" not in taken.counters
    assert cuda.KERNELS["frame_step"].launches == fk.FS_LAUNCHES
    _assert_frame_close(got, fk.frame_step(*args, plain=True))
    assert torch.equal(fk.frame_step(*args).p, got.p)
    del args, got
    oargs = _obs_args(dev, 20_224, 64)
    with profiling.tracing():
        got = fk.frame_update_obs(*oargs)
        torch.cuda.synchronize()
    taken = profiling.take()
    assert taken.counters.get("pass.tile128") == 1 and "pass.tile32" not in taken.counters
    ref = fk.frame_update_obs(*oargs, plain=True)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    assert torch.equal(got.p, got.p.T)
    # At D 2304 both frames keep the 32-tiles.
    with profiling.tracing():
        fk.frame_step(*_frame_args(dev, 2304, nz=64))
        fk.frame_update_obs(*_obs_args(dev, 1024, 64))
    assert profiling.take().counters == {"pass.tile32": 2}


def test_frame_step_at_the_10k_shape_replays_in_a_cuda_graph(dev):
    # H9's two launches at D 20,224, the streamed pass behind the frame
    # kernel, captured with its one programmatic edge and replayed bit for
    # bit as the eager launches.
    args = _frame_args(dev, 20_224, nz=64)
    eager = fk.frame_step(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        captured = fk.frame_step(*args)
    assert cuda.programmatic_edges(graph.raw_cuda_graph()) == 1
    graph.instantiate()
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mp", [160, 224, 240, 480])
def test_banded_obs_chain_matches_plain(dev, mp):
    # H7 in bands of one measurement, where its one-block form outgrew
    # shared memory (from MP 160); past MP 224 the split runs it beside
    # H1's cooperative sweep.
    args = _obs_args(dev, 1024, mp // 2)
    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = args
    oi = fk.obs_inputs(p, x, fk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    chain = (oi.zin, oi.rsc, oi.xrows, oi.prc, oi.vrows, bmat, oi.mp)
    s_k, rowc_k, hvb_k = fk.obs_chain(*chain)
    s_p, rowc_p, hvb_p = fk._obs_chain_reference(*chain)
    torch.testing.assert_close(s_k, s_p, rtol=1e-4, atol=1e-6 * float(s_p.abs().max()))
    torch.testing.assert_close(rowc_k, rowc_p, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(hvb_k, hvb_p, rtol=1e-4, atol=1e-6)
    again = fk.obs_chain(*chain)
    for a, b in zip((s_k, rowc_k, hvb_k), again):
        assert torch.equal(a, b)
    route = fk.obs_route(1024, mp // 2, bmat.shape[0], dev)
    assert route == ("resident" if mp <= 224 else "split")
    cuda.reset_launch_counts()
    got = fk.frame_update_obs(*args)
    ref = fk.frame_update_obs(*args, plain=True)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    want = ({"obs_step": fk.OS_LAUNCHES} if route == "resident" else
            {"obs_chain": 1, "sweep_inverse": 1, "obs_panels": 1, "rank_update": 1})
    assert counts == {**dict.fromkeys(counts, 0), **want}
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("s_steps", [17, 33, 64])
def test_recursion_past_16_sub_steps_matches_plain(dev, s_steps):
    # H2 and H9 (the known frame) and H5 (the gated frame's factors) past
    # one warp's lanes: the recursion's terms in shared memory.
    args = list(_frame_args(dev, 2304, nz=64, s_steps=s_steps))
    args[0] = 0.5 * (args[0] + args[0].T)
    assert fk.frame_route(2304, 64, dev, s_steps) == "resident"
    cuda.reset_launch_counts()
    got = fk.frame_step(*args)
    split = fk.frame_step(*args, schedule="split")
    ref = fk.frame_step(*args, plain=True)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "frame_step": fk.FS_LAUNCHES, "frame_chain": 1,
                      "sweep_inverse": 1, "frame_panels": 1, "rank_update": 1}
    for out in (got, split):
        # Over 64 sub-steps the pose reaches ~55 m: a few ulps there.
        torch.testing.assert_close(out.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-4)
        torch.testing.assert_close(out.x, ref.x, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(out.p, ref.p, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(out.nis, ref.nis, rtol=1e-3, atol=1e-5)
    assert torch.equal(got.p, got.p.T)
    st, fargs, _ = _gated_frame(dev, 1024, s_steps=s_steps)
    got = frame_factors_fused(st, *fargs)
    ref = _frame_factors_reference(st, *fargs)
    torch.testing.assert_close(got[0].x, ref[0].x, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-5 * float(ref[2].abs().max()))
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=1e-6)


def _pair_args(dev, d, seed=83, nz=10):
    """A frame-start state at D = d and two frames at the sensors' noise
    scale (speed about a standstill, heading at sigma_heading), frame B
    measured from frame A's updated mean, as frame_step_pair takes them."""
    rng = np.random.default_rng(seed)
    cap = (d - 3) // 2
    lm = rng.uniform(-50, 50, size=(cap, 2)).astype(np.float32)
    st = init_state_with_map(torch.as_tensor(lm), sigma0=0.5,
                             pad_multiple=128 if d % 128 == 0 else 0)
    a = torch.as_tensor(rng.normal(size=(d, 8)).astype(np.float32) * 0.05)
    p, x = (st.p + a @ a.T).to(dev), st.x.to(dev)
    tail = (73.0, 0.01, 0.01 * np.pi / 180, True)
    q = torch.diag(torch.tensor([0.3**2, (np.pi / 180) ** 2], device=dev))
    r = torch.diag(torch.tensor([0.1**2, 0.5 * np.pi / 180], device=dev))

    def frame(xs):
        ids = rng.choice(cap, size=nz, replace=False)
        fx, fy = xs[3 + 2 * ids] - xs[0], xs[4 + 2 * ids] - xs[1]
        mask = np.ones(nz, bool)
        mask[rng.integers(nz)] = False
        t = lambda v: torch.as_tensor(np.asarray(v)).to(dev)  # noqa: E731
        f32 = np.float32
        rows = np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)])
        ctrl = (t((rng.normal(size=6) * 0.3).astype(f32)),
                t((rng.normal(size=6) * 0.02).astype(f32)),
                t((xs[2] + rng.normal(size=6) * tail[2]).astype(f32)),
                t(np.array([1, 1, 1, 1, 1, 0], bool)))
        meas = (t((np.hypot(fx, fy) + rng.normal(size=nz) * 0.1).astype(f32)),
                t((np.arctan2(fy, fx) - xs[2] + rng.normal(size=nz) * 0.01).astype(f32)), t(mask))
        return t(rows), ctrl, meas

    rows_a, ctrl_a, meas_a = frame(x.cpu().numpy())
    fa = fk._plain_frame(p, x, rows_a, *ctrl_a, q, *meas_a, r, tail)
    rows_b, ctrl_b, meas_b = frame(fa.x.cpu().numpy())
    return (p, x, rows_a, ctrl_a, meas_a, rows_b, ctrl_b, meas_b, q, r, *tail)


@pytest.mark.parametrize("d", [256, 203])
def test_frame_pair_kernels_match_plain_versions(dev, d):
    args = _pair_args(dev, d)
    cuda.reset_launch_counts()
    got = fk.frame_step_pair(*args)
    ref = fk.frame_step_pair(*args, plain=True)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "sweep_inverse": 2, "frame_chain": 2,
                      "frame_panels": 2, "rank_update": 1}
    # Frame A as the frame test; frame B reads strips rebuilt from frame
    # A's results, so it carries A's fp32 differences (the reference's
    # pair-test tolerances, tests/test_pallas_ops.py:552-569).
    torch.testing.assert_close(got.pose_trace[0], ref.pose_trace[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.pose_trace[1], ref.pose_trace[1], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.pose_mid, ref.pose_mid, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-4, atol=2e-4)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=2e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)


def test_chunked_resume_is_bit_identical_on_the_card(dev, tmp_path, monkeypatch):
    # The 30-landmark world in frame pairs, chunks of 420 steps: a run
    # killed inside its third chunk and resumed from its checkpoints equals
    # an uninterrupted run bit for bit.
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.sim.world import default_world

    world = default_world(device=dev)
    cfg = SlamConfig(max_landmarks=30, max_obs=16, enable_augment=False, frame_pair=True)
    state0 = init_state_with_map(world.landmarks)
    roll = loop.precompute_rollout(world, cfg, 1200)
    ref = loop.run_ekf_slam_precomputed_chunked(world, cfg, 3, 1200, 420, state0, roll)
    driver, runs = loop.run_ekf_slam_precomputed, []

    def killed_in_chunk_2(*args, **kwargs):
        runs.append(args[3])
        if len(runs) == 3:
            raise KeyboardInterrupt
        return driver(*args, **kwargs)

    ckpt = str(tmp_path / "run")
    monkeypatch.setattr(loop, "run_ekf_slam_precomputed", killed_in_chunk_2)
    with pytest.raises(KeyboardInterrupt):
        loop.run_ekf_slam_precomputed_chunked(world, cfg, 3, 1200, 420, state0, roll, ckpt)
    monkeypatch.setattr(loop, "run_ekf_slam_precomputed", driver)
    got = loop.run_ekf_slam_precomputed_chunked(world, cfg, 3, 1200, 420, state0, roll, ckpt)
    for a, b in zip((*got[0], *got[1]), (*ref[0], *ref[1])):
        assert a.is_cuda and torch.equal(a, b)


def test_constructors_default_to_the_card(dev):
    from conan_slam_tpu_torch.sim.world import default_world

    world = default_world()
    assert world.landmarks.is_cuda and init_state_with_map(world.landmarks).p.is_cuda


# ------------------------------------------- the probe kernels (H11-H14)


def _unit_diag_sym(mp):
    """The sweep probe's S made exactly symmetric with an exactly unit
    diagonal: H1's scaling and symmetrizations are then the identity, so
    H1 and H11 sweep the same matrix."""
    from conan_slam_tpu_torch.benchmarks.probe_sweep import probe_matrix

    s = probe_matrix(mp)
    s = 0.5 * (s + s.T)
    np.fill_diagonal(s, 1.0)
    return s


@pytest.mark.parametrize("mp,nblk", [(64, 20), (128, 40), (128, 39), (128, 64)])
def test_sweep_probe_unrolled_is_h1_bit_for_bit(dev, mp, nblk):
    # H1 symmetrizes the swept matrix after the sweep, as the probe's
    # kernels do not: sym(H11) is H1, element by element.
    from conan_slam_tpu_torch.ops.probes import sweep_probe

    s = torch.as_tensor(_unit_diag_sym(mp), device=dev)
    h1 = sweep_si(s, torch.tensor([nblk], dtype=torch.int32, device=dev))
    for variant in ("unroll2", "unroll4"):
        got = sweep_probe(s, nblk, variant)
        torch.cuda.synchronize()
        assert torch.equal(0.5 * (got + got.T), h1), variant


@pytest.mark.parametrize("mp,nblk", [(64, 20), (128, 40), (128, 39), (128, 64)])
def test_sweep_probe_wide4_matches_h1(dev, mp, nblk):
    # Two pivots in one rank-4 update: the same inverse in another order,
    # within 4 MP float32 epsilons of the swept block's largest entry.
    from conan_slam_tpu_torch.ops.probes import sweep_probe, sweep_probe_reference

    s = torch.as_tensor(_unit_diag_sym(mp), device=dev)
    h1 = sweep_si(s, torch.tensor([nblk], dtype=torch.int32, device=dev))
    got = sweep_probe(s, nblk, "wide4")
    k = 2 * nblk
    tol = 4 * mp * torch.finfo(torch.float32).eps * float(h1[:k, :k].abs().max())
    assert float((got[:k, :k] - h1[:k, :k]).abs().max()) <= tol
    plain = sweep_probe_reference(s, nblk, "wide4")
    assert float((got - plain).abs().max()) <= tol


@pytest.mark.parametrize("variant", ["unroll2", "unroll4", "wide4"])
@pytest.mark.parametrize("mp,nblk", [(128, 40), (128, 39), (64, 20), (2, 1), (30, 15), (126, 63)])
def test_sweep_probe_two_calls_are_bit_equal(dev, variant, mp, nblk):
    # The ring's stages and the cluster's exchange change no element's
    # fmaf chain: two calls give the same bits, within the plain version's
    # bound (4 MP eps of the swept block's largest entry).
    from conan_slam_tpu_torch.ops.probes import sweep_probe, sweep_probe_reference

    s = torch.as_tensor(_unit_diag_sym(mp), device=dev)
    a, b = sweep_probe(s, nblk, variant), sweep_probe(s, nblk, variant)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    k = 2 * nblk
    plain = sweep_probe_reference(s, nblk, variant)
    tol = 4 * mp * torch.finfo(torch.float32).eps * float(plain[:k, :k].abs().max())
    assert float((a - plain).abs().max()) <= tol


@pytest.mark.parametrize("variant", ["unroll2", "unroll4", "wide4"])
def test_sweep_probe_replays_in_a_cuda_graph(dev, variant):
    from conan_slam_tpu_torch.ops.probes import sweep_probe

    s = torch.as_tensor(_unit_diag_sym(128), device=dev)
    eager = sweep_probe(s, 40, variant)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        sweep_probe(s, 40, variant)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = sweep_probe(s, 40, variant)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("variant", ["unroll2", "unroll4", "wide4"])
@pytest.mark.parametrize("mp", [2, 64, 66, 128])
def test_sweep_probe_plan_is_the_kernels(dev, variant, mp):
    from conan_slam_tpu_torch.ops.probes import sweep_probe_attributes, sweep_probe_plan

    plan, regs, local = sweep_probe_attributes(mp, variant, dev)
    assert plan == sweep_probe_plan(mp, variant)
    assert 0 < regs <= 255 and local >= 0


# H13 at the dots probe's shape, the ragged D 500 / MP 126 and D 4,096 (RP 136).
H13_SHAPES = [(512, 128, 136), (500, 126, 136), (4096, 128, 136), (37, 2, 9)]


@pytest.mark.parametrize("d,mp,rp", H13_SHAPES)
def test_probe_dots_matches_plain_at_its_shapes(dev, d, mp, rp):
    from conan_slam_tpu_torch.benchmarks.probe_mosaic import dots_inputs
    from conan_slam_tpu_torch.ops.probes import probe_dots, probe_dots_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.as_tensor(a, device=dev) for a in dots_inputs(d, mp, rp)]
    got, again = probe_dots(*args), probe_dots(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, ref in zip(got, probe_dots_reference(*args)):
        # Sums of RP and MP products in another order.
        assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_probe_dots_replays_in_a_cuda_graph(dev):
    from conan_slam_tpu_torch.benchmarks.probe_mosaic import dots_inputs
    from conan_slam_tpu_torch.ops.probes import probe_dots

    args = [torch.as_tensor(a, device=dev) for a in dots_inputs()]
    eager = probe_dots(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        probe_dots(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = probe_dots(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("d,mp,rp", H13_SHAPES)
def test_probe_dots_plan_is_the_kernels(dev, d, mp, rp):
    from conan_slam_tpu_torch.ops.probes import probe_dots_attributes, probe_dots_plan

    plan, regs, local, clusters = probe_dots_attributes(d, mp, rp, dev)
    assert plan == probe_dots_plan(d, mp, rp)
    assert 0 < regs <= 255 and local >= 0 and clusters > 0


@pytest.mark.parametrize("n,offset", [(2304 * 2304, 0), (1003 * 1003, 0), (4099, 1)])
def test_stream_copy_is_bit_equal(dev, n, offset):
    from conan_slam_tpu_torch.ops.probes import stream_copy

    base = torch.randn((n + offset,), device=dev, generator=torch.Generator(dev).manual_seed(n))
    x = base[offset:]       # offset 1: not 16-byte aligned, the 4-byte path
    out = stream_copy(x)
    torch.cuda.synchronize()
    assert torch.equal(out, x)


@pytest.mark.parametrize("n,offset", [(4099, 1), (4099, 2), (4099, 3), (5, 1), (2, 3),
                                      ((1 << 20) + 3, 2)])
def test_stream_copy_when_both_ends_are_misaligned(dev, n, offset):
    # In and out the same distance past a 16-byte boundary: the 4-byte
    # path, bit for bit, and nothing written before out.
    from conan_slam_tpu_torch.ops.probes import STREAM_COPY

    x = torch.randn((n + offset,), device=dev, generator=torch.Generator(dev).manual_seed(n))
    out = torch.zeros_like(x)
    STREAM_COPY(dev, cuda.ptr(x[offset:]), cuda.ptr(out[offset:]), n)
    torch.cuda.synchronize()
    assert torch.equal(out[offset:], x[offset:]) and not out[:offset].any()


def test_stream_copy_replays_under_scan_graph(dev):
    from conan_slam_tpu_torch.ops.probes import stream_copy
    from conan_slam_tpu_torch.utils.profiling import scan_graph

    x = torch.randn((2304, 2304), device=dev, generator=torch.Generator(dev).manual_seed(12))
    res = scan_graph(lambda c: (stream_copy(c[0]),), (x,), 12, 4)
    assert torch.equal(res.carry[0], x) and torch.equal(res.eager_carry[0], x)
    assert res.launches == {"stream_copy": 12}


# H8 at the split route's shapes (label, D, NZ, NBP): config 2, the
# 10k-landmark shape, route_checks' MP 240 and 480; then its other paths:
# rowc and hvb in chunks (MP 2048 at NBP 776, S = 256), D not a multiple of
# 4 (columns one at a time), NBP not a multiple of 4 (hvb zero-filled).
H8_SHAPES = [("config 2", 1024, 64, 24), ("10k", 20224, 64, 24), ("MP 240", 1024, 120, 24),
             ("MP 480", 1024, 240, 24), ("chunked", 512, 1024, 776), ("odd D", 203, 64, 24),
             ("odd NBP", 1024, 64, 22)]


@pytest.mark.parametrize("label,d,nz,nbp", H8_SHAPES)
def test_obs_panels_matches_plain_at_the_split_shapes(dev, label, d, nz, nbp):
    # chip_smoke.py's bounds: pht 5 + NBP-term sums against dense products,
    # the mean fp32 ulps, the NIS the reduction order; two calls bit for bit.
    from conan_slam_tpu_torch.benchmarks.redesign_turns import h8_inputs

    args = h8_inputs(d, nz, nbp, dev)
    got = fk.obs_panels(*args)
    again = fk.obs_panels(*args)
    ref = fk._obs_panels_reference(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-6 * float(ref[0].abs().max()))
    torch.testing.assert_close(got[1], ref[1], rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("label,d,nz,nbp", H8_SHAPES + [("MP 2048 at D 20,224", 20224, 1024, 776)])
def test_obs_panels_plan_is_the_kernels(dev, label, d, nz, nbp):
    mp, rp = fk.frame_shapes(nz)
    plan, regs, local, clusters = fk.obs_panels_attributes(d, mp, rp, nbp, dev)
    assert plan == fk.obs_panels_plan(d, mp, rp, nbp)
    assert 0 < regs <= 255 and local >= 0 and clusters > 0


def test_obs_panels_replays_in_a_cuda_graph(dev):
    from conan_slam_tpu_torch.benchmarks.redesign_turns import h8_inputs

    args = h8_inputs(1024, 64, 24, dev)
    eager = fk.obs_panels(*args)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fk.obs_panels(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = fk.obs_panels(*args)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(captured, eager):
            assert torch.equal(a, b)


def test_probe_dots_kernel_matches_plain(dev):
    from conan_slam_tpu_torch.benchmarks.probe_mosaic import dots_inputs
    from conan_slam_tpu_torch.ops.probes import probe_dots, probe_dots_reference

    torch.backends.cuda.matmul.allow_tf32 = False
    args = [torch.as_tensor(a, device=dev) for a in dots_inputs()]
    for got, ref in zip(probe_dots(*args), probe_dots_reference(*args)):
        # Sums of 136 and 128 products in another order.
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_probe_observe_kernel_matches_plain(dev):
    from conan_slam_tpu_torch.benchmarks.probe_mosaic import observe_inputs
    from conan_slam_tpu_torch.ops.probes import probe_observe, probe_observe_reference

    (xrows, zin, rsc, mp, rp), _ = observe_inputs()
    args = [torch.as_tensor(a, device=dev) for a in (xrows, zin, rsc)]
    ref = probe_observe_reference(*args, mp, rp)
    for path in ("known", "gated"):
        got = probe_observe(*args, mp, rp, path)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
        assert torch.equal(got[1], ref[1])
        # v's range rows are differences of ~60 m ranges: 2 ulps of 64 m.
        torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1.6e-5)


def _observe_case(mp, rp, dev, masked=(5,)):
    """H14's inputs at (MP, RP) from numpy seed mp + rp: features within
    60 m at the measurements' rows (those inside RP), noisy range and
    bearing, the measurements in ``masked`` (or "all") masked."""
    rng = np.random.default_rng(mp + rp)
    nzl = mp // 2
    xrows = rng.uniform(-60, 60, size=rp).astype(np.float32)
    xrows[:3] = [1.0, -2.0, 0.3]
    feats = np.zeros((nzl, 2), np.float32)
    for l in range(nzl):
        for k in range(2):
            if 3 + 2 * l + k < rp:
                feats[l, k] = xrows[3 + 2 * l + k]
    dx, dy = feats[:, 0] - xrows[0], feats[:, 1] - xrows[1]
    mask = np.zeros(nzl, np.float32) if masked == "all" else np.ones(nzl, np.float32)
    if masked != "all":
        mask[[l for l in masked if l < nzl]] = 0.0
    zin = np.stack([(np.hypot(dx, dy) + rng.normal(size=nzl) * 0.1) * mask,
                    (np.arctan2(dy, dx) - xrows[2] + rng.normal(size=nzl) * 0.01) * mask,
                    mask]).astype(np.float32)
    rsc = np.asarray([0.01, 1e-4, 1e-4, 7.6e-5], np.float32)
    return [torch.as_tensor(a, device=dev) for a in (xrows, zin, rsc)]


# H14 at its edges: one measurement, measurements past RP (masked by RP),
# a large probe, every measurement masked.
H14_CASES = [(2, 5, (5,)), (126, 100, (5,)), (512, 1027, (5, 200)), (128, 136, "all")]


@pytest.mark.parametrize("path", ["known", "gated"])
@pytest.mark.parametrize("mp,rp,masked", H14_CASES)
def test_probe_observe_matches_plain_at_its_edges(dev, mp, rp, masked, path):
    from conan_slam_tpu_torch.ops.probes import probe_observe, probe_observe_reference

    args = _observe_case(mp, rp, dev, masked)
    ref = probe_observe_reference(*args, mp, rp)
    got = probe_observe(*args, mp, rp, path)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[1], ref[1])
    # v's range rows are differences of ranges up to ~85 m: 2 ulps of 64 m.
    torch.testing.assert_close(got[2], ref[2], rtol=1e-5, atol=1.6e-5)


@pytest.mark.parametrize("path", ["known", "gated"])
def test_probe_observe_is_deterministic_and_replays_in_a_cuda_graph(dev, path):
    from conan_slam_tpu_torch.benchmarks.probe_mosaic import observe_inputs
    from conan_slam_tpu_torch.ops.probes import probe_observe

    (xrows, zin, rsc, mp, rp), _ = observe_inputs()
    args = [torch.as_tensor(a, device=dev) for a in (xrows, zin, rsc)]
    eager = probe_observe(*args, mp, rp, path)
    again = probe_observe(*args, mp, rp, path)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, again))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        probe_observe(*args, mp, rp, path)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        captured = probe_observe(*args, mp, rp, path)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(captured, eager))


@pytest.mark.parametrize("mp,rp", [(2, 5), (126, 100), (128, 136), (512, 1027)])
def test_probe_observe_plan_is_the_kernels(dev, mp, rp):
    from conan_slam_tpu_torch.ops.probes import probe_observe_attributes, probe_observe_plan

    plan, regs, local = probe_observe_attributes(mp, rp, dev)
    assert plan == probe_observe_plan(mp, rp)
    assert 0 < regs <= 255 and local == 0          # no spill


def test_probe_observe_refuses_the_parents_shapes(dev):
    from conan_slam_tpu_torch.ops.probes import probe_observe, probe_observe_plan

    args = _observe_case(128, 136, dev)
    with pytest.raises(ValueError):
        probe_observe(args[0], args[1][:, :63], args[2], 126 + 1, 136)     # odd MP
    with pytest.raises(ValueError):
        probe_observe(args[0][:2], args[1], args[2], 128, 2)               # RP < 3
    mp = next(m for m in range(2, 4000, 2) if probe_observe_plan(m, 136) is None)
    big = _observe_case(mp, 136, dev)
    with pytest.raises(RuntimeError):                # the C entry refuses past 48 KB
        probe_observe(*big, mp, 136)


@pytest.mark.parametrize("d,r", [(2304, 136), (1024, 72), (20_224, 24)])
def test_rank_update_tile_at_the_plan_is_h4_bit_for_bit(dev, d, r):
    from conan_slam_tpu_torch.ops.probes import rank_update_tile, rank_update_tile_reference
    from conan_slam_tpu_torch.ops.rank_update import rank_update_plan

    gen = torch.Generator(dev).manual_seed(d)
    p = torch.randn((d, d), device=dev, generator=gen)
    vt = torch.randn((r, d), device=dev, generator=gen)
    b = torch.randn((r, r), device=dev, generator=gen)
    vbt = (0.5 * (b + b.T)) @ vt
    tile, grid = rank_update_plan(d, dev)
    default = rank_update_vbt(p, vt, vbt)
    assert torch.equal(rank_update_tile(p, vt, vbt, tile, grid), default)
    if d > 4096:
        return
    for t in (32, 64, 128):
        for g in (0, 7):
            got = rank_update_tile(p, vt, vbt, t, g)
            torch.testing.assert_close(got, default, rtol=1e-5, atol=1e-3)
        prod = rank_update_tile(None, vt, vbt, t)
        torch.testing.assert_close(prod, rank_update_tile_reference(None, vt, vbt),
                                   rtol=1e-4, atol=1e-3)


def test_scan_graph_replays_h1_and_h4_as_the_eager_loop(dev):
    from conan_slam_tpu_torch.utils.profiling import scan_graph

    gen = torch.Generator(dev).manual_seed(5)
    d, r, mp = 512, 40, 128
    p = torch.eye(d, device=dev)
    vt = torch.randn((r, d), device=dev, generator=gen) * 1e-2
    b = torch.eye(r, device=dev) * 1e-3
    s = torch.as_tensor(_unit_diag_sym(mp), device=dev)
    nb = torch.tensor([mp // 2], dtype=torch.int32, device=dev)

    def step(c):
        p, s = c
        si = sweep_si(s, nb)
        return rank_update_t(p, vt, b + 1e-9 * si[0, 0]), s + 1e-9 * si
    res = scan_graph(step, (p, s), 12, 4)
    c = (p, s)
    for _ in range(12):
        c = step(c)
    for got, eager, want in zip(res.carry, res.eager_carry, c):
        assert torch.equal(got, want) and torch.equal(eager, want)
    assert res.launches == {"sweep_inverse": 12, "rank_update": 12}


@pytest.mark.parametrize("mode", ["sweeponly", "sweep", "chol", "noop", "ppass", "stepkernel",
                                  "stepkernel_big", "fullkernel", "factkernel"])
def test_bench_framestep_graph_replays_the_eager_frames(mode, dev, monkeypatch):
    # bench_framestep raises unless each mode's carry after the graph's
    # replays is bit for bit its carry after the same frames run eagerly.
    from conan_slam_tpu_torch.benchmarks import bench_framestep

    monkeypatch.setenv("FS_STEPS", "240")
    res = bench_framestep.main([mode], device=str(dev))
    got = res["modes"][mode]
    assert got["frames"] == 40 and got["us"] > 0
    assert got["launches"] or mode in ("chol", "noop")


# ----------------------------------------------- the on-device simulation loop

_ROUTES = {"fused": {}, "fused_obs=False": dict(fused_obs=False),
           "fast_frame=False": dict(fast_frame=False),
           "switch_batch_update=False": dict(switch_batch_update=False)}


def _valet_frame(dev, known: bool, use_heading: bool = True, n_steps: int = 1200):
    """A frame of the valet loop at its own shape (D 67, K 32, NZ 30): the
    carry after ``n_steps`` steps of run_ekf_slam with the plain versions
    on the card, then the next frame's controls and measurement buffer as
    ekf_frame_step forms them.  The plain versions leave P asymmetric by
    fp32 rounding (~4e-4 at this frame, on entries up to ~20)."""
    from conan_slam_tpu_torch.runner import loop

    world = default_world(device=dev)
    cfg = SlamConfig(switch_association_known=known, switch_heading_known=use_heading)
    gen = torch.Generator(device=dev).manual_seed(11)
    carry, _ = loop.run_ekf_slam(world, cfg, gen, n_steps, plain=True)
    st, x_true = carry.steer, carry.x_true
    subs = []
    for k in range(cfg.observe_interval):
        was_done = st.done
        st, x_true, vn, swan = loop._advance_truth(st, x_true, world, cfg,
                                                   torch.randn(2, generator=gen, device=dev))
        subs.append((vn, swan, x_true[2], ~was_done))
    obs = loop._sense(x_true, world, cfg, torch.randn((30, 2), generator=gen, device=dev))
    noise = loop.make_noise(cfg, device=dev)
    ctrl = tuple(torch.stack(a) for a in zip(*subs))
    return carry.state, ctrl, obs, noise, cfg


def _double(a):
    """``a`` (a tensor, a NamedTuple of tensors or a number) with its
    floating-point tensors in float64."""
    if isinstance(a, tuple):
        return type(a)(*(_double(t) for t in a))
    return a.double() if torch.is_tensor(a) and a.is_floating_point() else a


@pytest.mark.parametrize("use_heading", [True, False])
def test_valet_frame_kernels_match_plain(dev, use_heading):
    # H9, and H15 then H10, on a frame of the valet run at its shape,
    # against their plain versions at the reference's frame-test
    # tolerances; the gated frame's association equal to the plain one's.
    from conan_slam_tpu_torch.filters.ekf import associate_known

    state, ctrl, obs, noise, cfg = _valet_frame(dev, True, use_heading)
    assert state.x.shape[0] == 67 and obs.z.shape[0] == 30 and int(obs.mask.sum()) > 0
    assoc = associate_known(state, obs)
    fargs = (state.p, state.x, assoc.slots, state.capacity, *ctrl, noise.qe, obs.z[:, 0],
             obs.z[:, 1], assoc.known_mask, noise.re, cfg.wheel_base, cfg.dt_controls,
             cfg.sigma_heading, use_heading)
    assert fk.frame_route(67, 30, dev, 6) == "resident"
    cuda.reset_launch_counts()
    got = fk.frame_step(*fargs)
    torch.cuda.synchronize()
    assert cuda.KERNELS["frame_step"].launches == fk.FS_LAUNCHES
    _assert_frame_close(got, fk.frame_step(*fargs, plain=True))

    state, ctrl, obs, noise, cfg = _valet_frame(dev, False, use_heading)
    # H15 reads P's row 2 (contiguous) where the plain version reads its
    # column 2: on this P they differ by its asymmetry, and the strip
    # follows (the heading gains scale P's heading column by ~1/P[2, 2]).
    # So the kernel on P is the plain version on P with row 2 as its
    # column 2, and on the symmetrized P, which the kernels' own runs keep
    # exactly, the plain version itself.
    tail = (noise.qe, cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, use_heading, obs.z,
            obs.mask, noise.re, cfg.gate_reject, cfg.gate_augment)
    p_row = state.p.clone()
    p_row[:, 2] = state.p[2]
    got = factor_gate(state, *ctrl, *tail)
    ref = _factor_gate_reference(state._replace(p=p_row), *ctrl, *tail)
    torch.testing.assert_close(got.vtf, ref.vtf, rtol=1e-4, atol=1e-5)
    state = state._replace(p=0.5 * (state.p + state.p.T))
    gargs = (state, *ctrl, *tail)
    cuda.reset_launch_counts()
    got = factor_gate(*gargs)
    ref = _factor_gate_reference(*gargs)
    torch.cuda.synchronize()
    assert cuda.KERNELS["factor_gate"].launches == 1
    torch.testing.assert_close(got.x, ref.x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.vtf, ref.vtf, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.bmat, ref.bmat, rtol=1e-5, atol=1e-6)
    # Both strips within that tolerance of the plain version in float64.
    w64 = _frame_factors_reference(*(_double(a) for a in gargs[:6]), *gargs[6:10])[2]
    for f in (got, ref):
        torch.testing.assert_close(f.vtf.double(), w64, rtol=1e-4, atol=1e-5)
    # The scores within the NIS tolerance of test_factor_gate_kernel_matches_plain;
    # found and the best slot equal except near a gate or a tie.
    found, rfound = got.best_nd < 1e38, ref.best_nd < 1e38
    both = found & rfound
    torch.testing.assert_close(got.best_nd[both], ref.best_nd[both], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got.min_nis, ref.min_nis, rtol=1e-4, atol=1e-3)
    near_reject, tie = _margins(state._replace(x=ref.x), obs.z, noise.re, ref.vtf, ref.bmat,
                                cfg.gate_reject)()
    assert bool(((found == rfound) | near_reject).all())
    exact = both & ~tie
    assert torch.equal(got.best_j[exact], ref.best_j[exact])
    assert bool((got.known_mask & exact).any())
    uargs = (state.p, got.x, got.slots, state.capacity, obs.z[:, 0], obs.z[:, 1], got.known_mask,
             noise.re, got.bmat, got.vtf)
    assert fk.obs_route(67, 30, got.bmat.shape[0], dev) == "resident"
    cuda.reset_launch_counts()
    fu = fk.frame_update_obs(*uargs)
    torch.cuda.synchronize()
    assert cuda.KERNELS["obs_step"].launches == fk.OS_LAUNCHES
    ref = fk.frame_update_obs(*uargs, plain=True)
    torch.testing.assert_close(fu.x, ref.x, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(fu.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(fu.nis, ref.nis, rtol=1e-3, atol=1e-5)


def test_compact_on_the_card_matches_the_cpu(dev):
    # Ids, masks and the buffer bit for bit, with and without overflow.
    from conan_slam_tpu_torch.filters.common import compact
    from conan_slam_tpu_torch.sim.sensor_sim import Observation

    rng = np.random.default_rng(4)
    for n, size in ((30, 30), (500, 64), (40, 8), (10_000, 64)):
        vis = rng.random(n) < (0.3 if n < 1000 else 0.005)
        obs = Observation(z=torch.as_tensor(rng.normal(size=(n, 2)).astype(np.float32)),
                          visible=torch.as_tensor(vis))
        cpu = compact(obs, size)
        card = compact(Observation(*(t.to(dev) for t in obs)), size)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
        assert int(cpu.mask.sum()) == min(int(vis.sum()), size)


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("route", list(_ROUTES))
def test_run_ekf_slam_matches_plain(dev, known, route):
    # 600 steps of run_ekf_slam on the card against its plain versions on
    # the card, same draws: the same map and course; the trajectories
    # within the slice's 2e-3 m (float32 rounding of ~5 km positions); the
    # route's kernels once a frame: H9 (known) or H15 + H10 (gated) on the
    # fused frame, H6's entry on the gated non-fused routes, none on the
    # known non-fused routes.
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam

    world = default_world(device=dev)
    cfg = SlamConfig(switch_association_known=known, **_ROUTES[route])
    out = {}
    for plain in (False, True):
        gen = torch.Generator(device=dev).manual_seed(7)
        cuda.reset_launch_counts()
        out[plain] = run_ekf_slam(world, cfg, gen, 600, plain=plain)
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in cuda.KERNELS.values()}
        if plain or (known and route != "fused"):
            want = {}
        elif route == "fused":
            want = ({"frame_step": 100 * fk.FS_LAUNCHES} if known
                    else {"factor_gate": 100, "obs_step": 100 * fk.OS_LAUNCHES})
        else:
            want = {"gating_scores": 100}
        assert counts == {**dict.fromkeys(counts, 0), **want}
    (ck, ok), (cp, op) = out[False], out[True]
    assert bool(torch.isfinite(ck.state.p).all()) and int(ck.state.n_active) > 0
    assert torch.equal(ok.n_active, op.n_active) and torch.equal(ok.done, op.done)
    assert torch.equal(ok.x_true, op.x_true)
    torch.testing.assert_close(ok.x_est, op.x_est, rtol=0, atol=2e-3)
    torch.testing.assert_close(ok.consistency, op.consistency, rtol=2e-2, atol=1e-3)


def test_run_ekf_slam_never_waits_for_the_card(dev):
    # Frames of the valet loop (known and gated) and of BASELINE config 2
    # through run_ekf_slam under the sync debug mode, which raises at any
    # operation that makes the host wait for the card.
    from conan_slam_tpu_torch.runner.loop import run_ekf_slam
    from conan_slam_tpu_torch.sim.world import default_world as valet

    cases = ((valet(device=dev), SlamConfig()),
             (valet(device=dev), SlamConfig(switch_association_known=False)),
             (config2_world(device=dev),
              SlamConfig(max_landmarks=500, max_obs=64, switch_association_known=False)))
    for world, cfg in cases:
        gen = torch.Generator(device=dev).manual_seed(0)
        run_ekf_slam(world, cfg, gen, 12)            # first launches: scratch, bindings
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            carry, outs = run_ekf_slam(world, cfg, gen, 60)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert bool(torch.isfinite(outs.x_est).all()) and int(carry.state.n_active) > 0


def _longloop_frame(dev, n_frames: int = 50):
    """The long loop (5,000 committed landmarks, the star tour, D 10,240)
    after ``n_frames`` kernel frames, and frame ``n_frames``'s inputs as
    frame_step takes them."""
    from conan_slam_tpu_torch.filters.ekf import associate_known
    from conan_slam_tpu_torch.runner import loop
    from conan_slam_tpu_torch.runner.loop import precompute_rollout
    from conan_slam_tpu_torch.sim import sensor_sim
    from conan_slam_tpu_torch.sim.world import longloop_world

    cfg = SlamConfig(max_landmarks=5000, max_obs=64)
    world = longloop_world(5000, dev)
    s = cfg.observe_interval
    roll = precompute_rollout(world, cfg, (n_frames + 1) * s)
    gen = torch.Generator(device=dev).manual_seed(3)
    ctrl = torch.randn((n_frames + 1, s, 2), generator=gen, device=dev)
    obsn = torch.randn((n_frames + 1, roll[1][0].shape[1], 2), generator=gen, device=dev)
    part = (tuple(a[:n_frames * s] for a in roll[0]), tuple(a[:n_frames] for a in roll[1]))
    state, _ = run_ekf_slam_precomputed(world, cfg, None, n_frames * s, None, part,
                                        ctrl_noise=ctrl[:n_frames], obs_noise=obsn[:n_frames])
    f = n_frames
    sub = slice(f * s, (f + 1) * s)
    vns, swans = sensor_sim.add_control_noise(ctrl[f], cfg.velocity, roll[0][1][sub],
                                             cfg.sigma_v, cfg.sigma_swa, cfg.switch_control_noise)
    obs = loop._noisy_obs(cfg, roll[1][0][f], roll[1][1][f], roll[1][2][f], obsn[f])
    noise = loop.make_noise(cfg, "ekf", dev)
    assoc = associate_known(state, obs)
    return (state.p, state.x, assoc.slots, state.capacity, vns, swans, roll[0][0][sub, 2],
            roll[0][2][sub], noise.qe, obs.z[:, 0], obs.z[:, 1], assoc.known_mask, noise.re,
            cfg.wheel_base, cfg.dt_controls, cfg.sigma_heading, cfg.switch_heading_known)


def test_frame_step_kernel_at_the_long_loop_width(dev):
    # H9 at D 10,240 (BASELINE config 4, mapping from scratch), a frame
    # from the kernels' own carry: the resident route, two launches, two
    # calls bit-equal, and against its plain version at chip_smoke's
    # h9_checks tolerances (~5 km means: pose 1e-3, x 2e-3 m; P the
    # reference test's rtol 1e-3 / atol 1e-4; NIS rtol 1e-3).  The carry's
    # P is not symmetric (augmentation rounds its new blocks' two triangles
    # apart, as the JAX package's does: test_torch_longloop's stage-1
    # test), and H9 reads it as it is; from a symmetric P its output is
    # exactly symmetric (its P pass mirrors the upper triangle).
    args = _longloop_frame(dev)
    d, nz = args[1].shape[0], args[9].shape[0]
    assert d == 10_240 and fk.frame_route(d, nz, dev, 6) == "resident"
    cuda.reset_launch_counts()
    got, again = fk.frame_step(*args), fk.frame_step(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "frame_step": 2 * fk.FS_LAUNCHES}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = fk.frame_step(*args, plain=True)
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(got.x, ref.x, rtol=1e-6, atol=2e-3)
    torch.testing.assert_close(got.p, ref.p, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    p = args[0]
    sym = fk.frame_step(0.5 * (p + p.T), *args[1:])
    assert torch.equal(sym.p, sym.p.T)


def _bench_graph(dev):
    """The long loop's stage-2 graph on the committed JAX draws, on ``dev``."""
    import os

    from conan_slam_tpu_torch.graph.frontend import ClosureConfig, GraphDraws
    from conan_slam_tpu_torch.graph.frontend import simulate_odometry_graph
    from conan_slam_tpu_torch.sim.precompute import rollout_truth
    from conan_slam_tpu_torch.sim.world import star_waypoints

    data = np.load(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "conan_slam_tpu_torch", "sim", "data", "longloop_key2.npz"))
    roll = rollout_truth(star_waypoints(), SlamConfig(max_landmarks=5000, max_obs=64), 56_004)
    ccfg = ClosureConfig(odo_sigma_xy=0.5, odo_sigma_th=0.01, max_closures=256, min_index_gap=60)
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)  # noqa: E731
    return simulate_odometry_graph(t(roll.x_true), t(~roll.done), ccfg,
                                   GraphDraws(t(data["odo"]), t(data["closure"])))


def test_pose_graph_on_the_card_is_bit_identical(dev):
    # The fixed-order node sums (ScatterPlan) make a solve on the card
    # reproducible bit for bit, where index_add_'s float atomics are not.
    from conan_slam_tpu_torch.graph import pose_graph as pg

    g = _bench_graph(dev)
    t = g.nodes.shape[0]
    a, b = (pg.optimize(g, iterations=2, cg_iterations=4 * t, chordal_init=True).nodes
            for _ in range(2))
    assert torch.equal(a, b)


def test_optimize_on_the_card_against_the_cpu_and_a_witness(dev):
    # The bench graph at 3 Gauss-Newton iterations of T CG steps on the
    # card, the port's CPU run and a float64 witness (the port's functions
    # in float64 on the CPU): the card no further from the witness than
    # twice the CPU run in the largest and median node distance (x/y,
    # heading), chi^2 within the larger of twice the CPU run's distance and
    # the CPU's own float32 spread (its solve with the edges permuted).
    from conan_slam_tpu_torch.graph import pose_graph as pg

    g = _bench_graph(dev)
    t = g.nodes.shape[0]
    budget = dict(iterations=3, cg_iterations=t, chordal_init=True)
    cpu = pg.PoseGraph(*(a.cpu() for a in g))
    perm = torch.as_tensor(np.random.default_rng(0).permutation(g.edges.shape[0]))
    cpu_perm = cpu._replace(edges=cpu.edges[perm], meas=cpu.meas[perm], info=cpu.info[perm],
                            edge_mask=cpu.edge_mask[perm])
    wit_g = pg.PoseGraph(*(a.double() if a.is_floating_point() else a for a in cpu))
    card = pg.optimize(g, **budget).nodes.cpu().double()
    host, host_perm = (pg.optimize(x, **budget).nodes.double() for x in (cpu, cpu_perm))
    wit = pg.optimize(wit_g, **budget).nodes

    def dist(a):
        dxy = (a[:, :2] - wit[:, :2]).norm(dim=1)
        dth = torch.remainder(a[:, 2] - wit[:, 2] + np.pi, 2 * np.pi) - np.pi
        return [float(dxy.max()), float(dxy.median()), float(dth.abs().max()),
                float(dth.abs().median())]

    for got, lim in zip(dist(card), dist(host)):
        assert got <= 2.0 * lim, (dist(card), dist(host))

    def chi2(nodes):
        return float(pg.graph_error(wit_g._replace(nodes=nodes)))

    w = chi2(wit)
    bound = max(2.0 * abs(chi2(host) - w), abs(chi2(host_perm) - chi2(host)))
    assert abs(chi2(card) - w) <= bound, (chi2(card), chi2(host), w)


def test_sharded_frame_on_the_card_matches_the_cpu(dev):
    # The sharded frame (parallel.dist_fastframe) on two gloo ranks that
    # share the card, against the same two ranks on the CPU (the plain
    # Cholesky route for S^-1): H1 inverts S once a frame in each rank, and
    # the two runs differ by fp32 rounding alone (the frame test's
    # tolerances: x 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol 1e-4, pose trace
    # 1e-5); the replicated outputs are the same bits on both ranks.
    from conan_slam_tpu_torch.parallel import dist_fastframe, launch, tasks

    x, p_rows, frame = tasks.big_inputs(403, 16, 6, 3, "cpu")
    d = x.shape[0]
    args = tuple(a.numpy() if torch.is_tensor(a) else a for a in frame)
    steps = [(dist_fastframe.sharded_frame_update, args, {})]
    got, ref = (launch.run(tasks.state_steps, 2, {"state": 2}, x.numpy(),
                           p_rows(slice(0, d)).numpy(), steps, device=kind, timeout=300.0)
                for kind in ("cuda", "cpu"))
    assert [r["launches"]["sweep_inverse"] for r in got] == [1, 1]
    assert [r["launches"]["sweep_inverse"] for r in ref] == [0, 0]
    for key, rtol, atol in (("x", 1e-4, 1e-4), ("p", 1e-3, 1e-4)):
        np.testing.assert_allclose(np.concatenate([r[key] for r in got]),
                                   np.concatenate([r[key] for r in ref]), rtol=rtol, atol=atol)
    (nis, pt), (nis_ref, pt_ref) = got[0]["extras"][0], ref[0]["extras"][0]
    np.testing.assert_allclose(nis, nis_ref, rtol=1e-4)
    np.testing.assert_allclose(pt, pt_ref, rtol=1e-5, atol=1e-5)
    for r in got[1:]:
        assert all(a.tobytes() == b.tobytes() for a, b in zip(r["extras"][0], got[0]["extras"][0]))


# ------------------------------------- the PF resample's CDF (F6) and the bench tail


def _dist_pf_weights(dev, n=100_000):
    """The normalised weights of chip_smoke.py's sharded PF step (numpy seed
    11: its features, their particles' noise, then the log weights)."""
    from conan_slam_tpu_torch.filters import pf

    rng = np.random.default_rng(11)
    rng.uniform(-200, 200, size=(4, 2))
    rng.normal(size=(n, 4, 2))
    log_w = torch.as_tensor(rng.normal(size=(n,)).astype(np.float32), device=dev)
    return pf.normalized_weights(pf.ParticleEnsemble(log_w, *([None] * 6)))


def test_pf_cdf_gives_the_same_bits_on_every_call(dev):
    # The resample's CDF (filters.pf.cumulative_weights: blocked doubling
    # scans in float64) is the same bits on every call on the card, and the
    # same bits as on the CPU: elementwise adds in one order, on both.
    from conan_slam_tpu_torch.filters import pf

    w = _dist_pf_weights(dev)
    first = pf.cumulative_weights(w)
    for _ in range(20):
        assert torch.equal(pf.cumulative_weights(w), first)
    assert torch.equal(first.cpu(), pf.cumulative_weights(w.cpu()))
    # torch.cumsum's float32 scan, the CDF before the fix, for the record
    # (chip_smoke.py's phase 4h (c2) counts its differing calls).
    cums = [torch.cumsum(w, 0) for _ in range(20)]
    print(f"torch.cumsum: {sum(not torch.equal(c, cums[0]) for c in cums)} of 19 more calls "
          "differ from the first")


def test_pf_resample_gives_the_same_ancestors_twice(dev):
    # The single-device resample of 100,000 particles twice on one
    # ensemble: every field the same bits; its ancestors those the CPU
    # draws on the card's weights (the normalisation's reductions sum in
    # another order on the CPU; the strata, the CDF and its inverse do
    # not).
    from conan_slam_tpu_torch.filters import pf

    n = 100_000
    rng = np.random.default_rng(12)
    ens = pf.init_ensemble(n, 8, 30, device=dev)
    ens = ens._replace(log_w=_dist_pf_weights(dev, n).log(),
                       pose=torch.as_tensor(rng.normal(size=(n, 3)).astype(np.float32),
                                            device=dev))
    u = torch.as_tensor(rng.uniform(size=(n,)).astype(np.float32), device=dev)
    runs = [pf.resample(ens, u, None, 0.75 * n, True) for _ in range(2)]
    assert not torch.equal(runs[0].pose, ens.pose)        # it resampled
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    w = pf.normalized_weights(ens)
    idx = pf.stratified_indices(u, w, n)
    assert torch.equal(idx.cpu(), pf.stratified_indices(u.cpu(), w.cpu(), n))
    assert torch.equal(runs[0].pose, ens.pose[idx])


def test_run_pf_slam_gives_the_same_bits_twice(dev):
    # run_pf_slam at N = 1,000 for 600 steps, twice on the same draws (the
    # committed pf_key1.npz's: odometry and returns as stored, the N = 100
    # particles' draws tiled ten times): the same x_est and ensemble bits.
    import os

    from conan_slam_tpu_torch.filters.pf import ObservationDraws
    from conan_slam_tpu_torch.runner.loop import PFDraws, run_pf_slam

    data = np.load(os.path.join(os.path.dirname(__file__), "..", "conan_slam_tpu_torch", "sim",
                                "data", "pf_key1.npz"))
    t = {k: torch.as_tensor(data[k], device=dev) for k in ("ctrl", "obs")}
    for k in ("prop", "res_u", "samp"):
        reps = (1, 10) + (1,) * (data[f"{k}_100"].ndim - 2)
        t[k] = torch.as_tensor(np.tile(data[f"{k}_100"], reps), device=dev)

    def draws(i):
        return PFDraws(ctrl=t["ctrl"][i], obs=t["obs"][i], step=ObservationDraws(
            prop=t["prop"][i], res_u=t["res_u"][i], samp=t["samp"][i], rough=None))

    world = default_world(dev)
    runs = [run_pf_slam(world, SlamConfig(num_particles=1000), None, 600, draws=draws)
            for _ in range(2)]
    (c1, o1), (c2, o2) = runs
    assert torch.equal(o1.x_est, o2.x_est) and torch.equal(o1.consistency, o2.consistency)
    for a, b in zip(c1.ens, c2.ens):
        assert torch.equal(a, b)


_BENCH_TAIL_MODES = {
    "factors": {"rank_update"}, "smallchain": {"frame_chain", "sweep_inverse", "frame_panels"},
    "gather": set(), "chainkernel": {"frame_chain"}, "chainonly": {"frame_chain"},
    "gmrank": {"rank_update"}, "glue": set(), "body_noaug": {"frame_step"},
    "body_uncond": {"frame_step"}, "gbody_aug": {"factor_gate", "obs_step"},
    "gbody_noaug": {"factor_gate", "obs_step"}, "gating": {"factor_gate"}, "assoc": set(),
    "megaprep": set(), "prep_prc": set(), "prep_pads": set(), "prep_zin": set()}


@pytest.mark.parametrize("mode", sorted(_BENCH_TAIL_MODES))
def test_bench_framestep_bench_tail_mode_replays_the_eager_frames(mode, dev, monkeypatch):
    # Each mode ported with the bench tail captures into a CUDA graph whose
    # carry equals the eager loop's bit for bit (bench_framestep raises
    # otherwise), replaying the kernels of the work it isolates and no other.
    from conan_slam_tpu_torch.benchmarks import bench_framestep

    monkeypatch.setenv("FS_STEPS", "240")
    got = bench_framestep.main([mode], device=str(dev))["modes"][mode]
    assert got["frames"] == 40 and got["us"] > 0 and got["eager_us"] > 0
    assert set(got["launches"]) == _BENCH_TAIL_MODES[mode], got["launches"]


def test_bench_kernels_h4_matches_plain_at_2051(dev):
    # bench_kernels at D 2,051 (not a multiple of 4: H4's unaligned
    # strips): H4 with the folded downdate within its bound of the plain
    # version, torch.addmm too, each chain replayed from a CUDA graph.
    from conan_slam_tpu_torch.benchmarks import bench_kernels

    row = bench_kernels.main(["2051"], device=str(dev))[2051]
    for name in ("h4", "plain", "addmm"):
        assert row[name]["max_abs_err"] <= row["bound"] and row[name]["us"] > 0
    assert row["h4"]["launches"] == {"rank_update": bench_kernels.ITERS}
    assert row["plain"]["launches"] == {} and row["addmm"]["launches"] == {}
