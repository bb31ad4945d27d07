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
from conan_slam_tpu_torch.ops.factor_kernel import _frame_factors_reference, frame_factors_fused
from conan_slam_tpu_torch.ops.gating_kernel import _gating_scores_reference, gating_scores
from conan_slam_tpu_torch.ops.rank_update import (
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
from conan_slam_tpu_torch.sim.world import config2_world

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
    # The default route (H9, one launch) and the split schedule (H2, H1, H3,
    # H4 once each), each against its plain version.
    args = _frame_args(dev, d)
    for schedule, want in (("auto", {"frame_step": 1}),
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


@pytest.mark.parametrize("d,nz,s_steps,use_heading", _RESIDENT_CASES)
def test_frame_step_kernel_matches_plain(dev, d, nz, s_steps, use_heading):
    args = list(_frame_args(dev, d, nz=nz, s_steps=s_steps, use_heading=use_heading))
    args[0] = 0.5 * (args[0] + args[0].T)          # exactly symmetric P
    cuda.reset_launch_counts()
    got, again = fk.frame_step(*args), fk.frame_step(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "frame_step": 2}
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
    ref = fk.frame_step(*args, plain=True)
    torch.testing.assert_close(got.pose_trace, ref.pose_trace, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.nis, ref.nis, rtol=1e-3, atol=1e-5)
    if not use_heading and s_steps == 16:
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
    # One H9 launch captured in a CUDA graph and replayed gives the eager
    # launch's bits: the C entry allocates nothing and launches on the
    # capturing stream.
    args = _frame_args(dev, 2304, nz=64)
    eager = fk.frame_step(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fk.frame_step(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_frame_step_plan(dev):
    plan = fk.frame_step_plan(2304, 128, dev)
    mp, rp = fk.frame_shapes(64)
    assert plan.grid == torch.cuda.get_device_properties(dev).multi_processor_count
    assert plan.block == fk.FS_THREADS
    assert plan.smem == fk._frame_step_smem_bytes(mp, rp, fk.frame_chain_plan(mp).band)
    assert (plan.bands, plan.panels, plan.tiles) == (64, 144, 72 * 73 // 2)


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
    for schedule, want in (("auto", {"obs_step": 1}),
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
    # 600 steps of BASELINE config 2 from an empty map: every gated-path
    # kernel launches once a frame, H2/H3 never, and the run maps
    # landmarks as the plain versions do.
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
            want = dict.fromkeys(("factor_strip", "gating_scores", "obs_step"), 100)
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


@pytest.mark.parametrize("d,nz,s_steps,use_heading", _OBS_CASES)
def test_obs_step_kernel_matches_plain(dev, d, nz, s_steps, use_heading):
    args = _obs_args(dev, d, nz, s_steps, use_heading)
    nbp = args[8].shape[0]
    assert fk.obs_route(d, nz, nbp, dev) == "resident"
    cuda.reset_launch_counts()
    got, again = fk.frame_update_obs(*args), fk.frame_update_obs(*args)
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in cuda.KERNELS.values()}
    assert counts == {**dict.fromkeys(counts, 0), "obs_step": 2}
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
    args = _obs_args(dev, 1024, 64)
    eager = fk.frame_update_obs(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fk.frame_update_obs(*args)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, eager):
        assert torch.equal(a, b)


def test_obs_step_plan(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fk.obs_step_plan(1024, 128, 24, dev)
    mp, rp = fk.frame_shapes(64)
    assert plan.grid == sms and plan.block == fk.OS_THREADS and plan.tile == 32
    assert plan.smem == fk._obs_step_smem_bytes(mp, rp, 24, plan.tile)
    assert (plan.bands, plan.panels, plan.tiles) == (64, 64, 32 * 33 // 2)
    big = fk.obs_step_plan(20_224, 128, 24, dev)
    assert big.tile == 128 and big.tiles == 158 * 159 // 2


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
    want = ({"obs_step": 1} if route == "resident" else
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
    assert counts == {**dict.fromkeys(counts, 0), "frame_step": 1, "frame_chain": 1,
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


@pytest.mark.parametrize("n,offset", [(2304 * 2304, 0), (1003 * 1003, 0), (4099, 1)])
def test_stream_copy_is_bit_equal(dev, n, offset):
    from conan_slam_tpu_torch.ops.probes import stream_copy

    base = torch.randn((n + offset,), device=dev, generator=torch.Generator(dev).manual_seed(n))
    x = base[offset:]       # offset 1: not 16-byte aligned, the 4-byte path
    out = stream_copy(x)
    torch.cuda.synchronize()
    assert torch.equal(out, x)


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
