"""Port parity for the one-dispatch gated frame (H10, ops.frame_kernel
``frame_update_obs``'s default route), the route a gated frame takes
(``obs_route``), and the recursion past 16 sub-steps (H2, H5, H9).

On the CPU the resident route runs H10's plain version,
``_frame_update_obs_resident_reference``.  It is held to the reference's
one-dispatch gated frame (its ``_fullframe_kernel`` in interpret mode, as
tests/test_pallas_ops.py runs it) and to the reference's jnp route, at the
reference's megakernel-test tolerances (tests/test_torch_gated.py:
x rtol/atol 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol 1e-3 / atol 1e-5),
and to the split schedule's plain version.  Past 16 sub-steps (the lanes of
one warp, the recursion's bound until its per-sub-step terms moved to
shared memory) the known frame and the factors are held to the
reference's kernels in interpret mode at the reference's frame tolerances.
tests/test_torch_cuda.py holds H10 and the recursion's kernels to these
plain versions on a card.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu.ops.factor_kernel import frame_factors_fused as j_frame_factors_fused
from conan_slam_tpu_torch.filters.ekf.state import EKFState
from conan_slam_tpu_torch.ops import cuda, frame_kernel as tfk
from conan_slam_tpu_torch.ops.factor_kernel import frame_factors_fused

torch.set_num_threads(2)

TAIL = (73.0, 0.01, 0.01 * np.pi / 180)
KEYS = ("p", "x", "rows", "vns", "swans", "phis", "act", "q", "zr", "zb", "mask", "r")


def _problem(seed, nz, s, capacity=126, pad_multiple=128):
    """A frame at D = 256 (``capacity`` landmarks padded to a multiple of
    128): ``nz`` distinct landmarks measured (one masked), ``s`` sub-steps
    (the last inactive when S > 1), a dense symmetric P."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-50, 50, size=(capacity, 2)).astype(np.float32)
    state = jekf.init_state_with_map(lm, sigma0=0.5, pad_multiple=pad_multiple)
    d = state.x.shape[0]
    a = rng.normal(size=(d, 8)).astype(np.float32) * 0.05
    ids = rng.choice(capacity, size=nz, replace=False)
    z = np.stack([np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
                  np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01], -1)
    mask = np.ones(nz, bool)
    mask[-2] = False
    p = np.asarray(state.p) + a @ a.T
    return dict(
        p=0.5 * (p + p.T), x=np.array(state.x), slots=ids.astype(np.int64), capacity=capacity,
        rows=np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)]),
        vns=(83.33 + rng.normal(size=s) * 0.3).astype(np.float32),
        swans=(rng.normal(size=s) * 0.2).astype(np.float32),
        phis=(rng.normal(size=s) * 0.5).astype(np.float32),
        act=np.arange(s) < max(1, s - 1),
        q=np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32),
        zr=z[:, 0].astype(np.float32), zb=z[:, 1].astype(np.float32), mask=mask,
        r=np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32),
    )


def _jax_args(prob):
    return tuple(jnp.asarray(prob[k].astype(np.int32) if k == "rows" else prob[k]) for k in KEYS)


def _gated(prob, use_heading):
    """The frame's factors from the reference's H5 counterpart in interpret
    mode, then ``frame_update_obs``'s arguments in both packages:
    ``(reference args (rows), port args (slots, capacity))``."""
    j = dict(zip(KEYS, _jax_args(prob)))
    state = jekf.init_state_with_map(np.zeros((prob["capacity"], 2), np.float32),
                                     pad_multiple=128)
    state = state._replace(p=j["p"], x=j["x"])
    st1, _, vtf, bmat = j_frame_factors_fused(state, j["vns"], j["swans"], j["phis"], j["act"],
                                              j["q"], *TAIL, use_heading, interpret=True)
    ref_args = (st1.p, st1.x, j["rows"], j["zr"], j["zb"], j["mask"], j["r"], bmat, vtf)
    t = lambda a: torch.as_tensor(np.array(a))   # noqa: E731
    port_args = (t(st1.p), t(st1.x), t(prob["slots"]), prob["capacity"], t(prob["zr"]),
                 t(prob["zb"]), t(prob["mask"]), t(prob["r"]), t(bmat), t(vtf))
    return ref_args, port_args


def _assert_update_close(got, ref):
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)


CASES = [(10, True), (64, True), (10, False), (64, False)]


@pytest.mark.parametrize("reference", ["fullframe kernel", "jnp route"])
@pytest.mark.parametrize("nz,use_heading", CASES)
def test_resident_matches_reference(nz, use_heading, reference):
    prob = _problem(61 + nz, nz, 6)
    ref_args, port_args = _gated(prob, use_heading)
    d, nbp = prob["p"].shape[0], port_args[8].shape[0]
    assert jfk.can_fuse_frame(d, nz, nbp) and tfk.obs_route(d, nz, nbp, "cpu") == "resident"
    ref_fn = (functools.partial(jfk.frame_update_obs, interpret=True)
              if reference == "fullframe kernel" else jax.jit(jfk.frame_update_obs))
    ref = ref_fn(*ref_args)
    cuda.reset_launch_counts()
    got = tfk.frame_update_obs(*port_args)
    assert not any(k.launches for k in cuda.KERNELS.values())
    _assert_update_close(got, ref)
    # frame_update_obs's default route on the CPU is H10's plain version.
    p, x, slots, cap, zr, zb, mask, r, bmat, vtf = port_args
    oi = tfk.obs_inputs(p, x, tfk.frame_rows(slots, cap), zr, zb, mask, r, vtf)
    direct = tfk._frame_update_obs_resident_reference(p, x, oi, bmat, vtf)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)


@pytest.mark.parametrize("reference", ["fullframe kernel", "jnp route"])
def test_resident_all_masked_is_factor_only(reference):
    # No associated measurement: the factored correction alone, the mean
    # unchanged, NIS 0 (tests/test_torch_gated.py's all-masked case).
    prob = _problem(71, 10, 6)
    prob["mask"][:] = False
    ref_args, port_args = _gated(prob, True)
    ref_fn = (functools.partial(jfk.frame_update_obs, interpret=True)
              if reference == "fullframe kernel" else jax.jit(jfk.frame_update_obs))
    ref = ref_fn(*ref_args)
    got = tfk.frame_update_obs(*port_args)
    _assert_update_close(got, ref)
    p, x, *_, bmat, vtf = port_args
    np.testing.assert_allclose(got.x.numpy(), x.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.p.numpy(), (p + vtf.T @ bmat @ vtf).numpy(), rtol=1e-3,
                               atol=1e-4)
    assert float(got.nis) == 0.0


@pytest.mark.parametrize("nz,use_heading", CASES)
def test_resident_and_split_plain_versions_agree(nz, use_heading):
    # The same frame through both schedules' plain versions: the same
    # chain, sweep and panels, then G^T MG with MG formed in two ways.
    prob = _problem(89 + nz, nz, 6)
    _, port_args = _gated(prob, use_heading)
    resident = tfk.frame_update_obs(*port_args)
    split = tfk.frame_update_obs(*port_args, schedule="split")
    np.testing.assert_allclose(resident.x.numpy(), split.x.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(resident.p.numpy(), split.p.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(resident.nis), float(split.nis), rtol=1e-5, atol=1e-6)


def test_frame_update_obs_past_mp_224_takes_the_split_schedule():
    # MP 240 at D = 256 (NZ 120), where the reference runs its one-dispatch
    # gated frame: the port's split schedule (H7 in bands, H1's cooperative
    # sweep on the card; its plain versions here) against the reference.
    prob = _problem(107, 120, 6)
    ref_args, port_args = _gated(prob, True)
    d, nbp = prob["p"].shape[0], port_args[8].shape[0]
    assert jfk.can_fuse_frame(d, 120, nbp) and tfk.obs_route(d, 120, nbp, "cpu") == "split"
    _assert_update_close(tfk.frame_update_obs(*port_args), jax.jit(jfk.frame_update_obs)(*ref_args))


# (D, NBP): the BASELINE shapes, unpadded D, and the factor rows of 6, 64
# and 256 sub-steps with the heading update.
@pytest.mark.parametrize("d", [128, 256, 1003, 1024, 2304, 20224])
def test_obs_route_follows_the_reference(d):
    # Over every NZ to 1100 (MP 2208): the port's copy of can_fuse_frame is
    # the reference's; a frame the reference runs on its TPU kernel never
    # reads "unported" (H10 to MP 224, then the split to MP 2048); past the
    # port's kernels the route is the reference's own: "plain" where it has
    # no TPU schedule.
    for nbp in (24, 200, 776):
        for nz in range(1, 1101, 7):
            has = jfk.can_fuse_frame(d, nz, nbp)
            assert tfk._ref_frame_update_has_kernel(d, nz, nbp) == has
            route = tfk.obs_route(d, nz, nbp, "cpu")
            mp, rp = tfk.frame_shapes(nz)
            want = ("resident" if mp <= 224 and tfk._obs_step_smem_bytes(mp, rp, nbp)
                    + tfk.OS_STATIC_BYTES <= cuda.MAX_SMEM_BYTES
                    else "split" if mp <= 2048 else "plain")
            assert route == want, (d, nz, nbp, route, want)
            assert route != "unported" or not has


def _obs_step_consts():
    src = (cuda.CSRC / "obs_step.cuh").read_text()
    return src, {k: int(v) for k, v in re.findall(r"#define (OS_\w+) +(\d+)", src)}


def test_obs_step_constants_match_the_kernel_source():
    src, consts = _obs_step_consts()
    assert consts["OS_THREADS"] == tfk.OS_THREADS
    assert consts["OS_COLS"] == tfk.OS_COLS
    assert consts["OS_MAX_UNIT"] == tfk.OS_MAX_UNIT
    assert consts["OS_XG"] == tfk.OS_XG
    assert consts["OS_MG_WARPS"] == tfk.OS_MG_WARPS
    assert consts["OS_STAMPS"] == tfk.OS_STAMPS
    assert consts["OS_PLAN"] == tfk.OS_PLAN
    assert consts["OS_BAND"] == tfk.OBS_BAND
    assert consts["OS_MAX_RP"] == tfk.OS_MAX_RP == tfk.frame_shapes(112)[1]
    assert consts["OS_MAX_MP"] == tfk.MAX_MP
    assert ("constexpr int OS_STATIC_BYTES = 4 * (OS_MAX_RP + OS_THREADS / 32);" in src
            and tfk.OS_STATIC_BYTES == 4 * (tfk.OS_MAX_RP + tfk.OS_THREADS // 32))
    # Two launches a call: the frame kernel, then the P pass on H9's route
    # (resident.cuh's pass_route: H4's 32-tiles, or the streamed 128-tiles
    # of obs_step_big.cu), behind a programmatic launch (resident.cuh,
    # shared with H9).
    assert tfk.OS_LAUNCHES == 2 == tfk.OBS_STEP.launches_per_call
    shared = (cuda.CSRC / "resident.cuh").read_text()
    entry = (cuda.CSRC / "obs_step.cu").read_text()
    big = (cuda.CSRC / "obs_step_big.cu").read_text()
    assert "obs_pass_kernel" in src and "csl_res::pass_tiles<R, VECP>" in src
    assert "csl_res::launch_pass<PASS_32>(obs_pass_kernel<PASS_32, true>" in entry
    assert "csl_res::pass_route(f.d, info->sms, csl_res::pass_vec(f.p, f.p_out, f.d))" in entry
    assert "csl_res::launch_pass<csl_res::PASS_128>(obs_pass_kernel<csl_res::PASS_128, true>" in big
    assert "inline int pass_route(" in shared and "pass_tile(" not in src
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in shared
    assert "griddepcontrol.wait" in shared and "griddepcontrol.launch_dependents" in src
    # The largest frame H10 holds at config 2's NBP fits a block with its
    # static shared memory, and H7's band of one measurement at MP 2048.
    mp, rp = tfk.frame_shapes(112)
    assert tfk._obs_step_smem_bytes(mp, rp, 24) + tfk.OS_STATIC_BYTES <= cuda.MAX_SMEM_BYTES
    assert tfk._obs_smem_bytes(2048, tfk.frame_shapes(1024)[1], 776) <= cuda.MAX_SMEM_BYTES
    plan = tfk.obs_chain_plan(128)
    assert [i for b in range(plan.grid) for i in plan.rows(b)] == list(range(128))


@pytest.mark.parametrize("rx", range(1, 8))
def test_obs_step_smem_mirrors_the_kernel_source(rx):
    # H10's frame kernel at every RX: the Python mirror of its shared memory
    # reads the source's phases (the chain; the sweep with v and siv; the
    # pht units: the unit's pht, rowc, hvb, the gathered panel and vtf's;
    # the gains: the unit's pht, S^-1, the mean's partials, v, siv and the
    # mbarriers of its bulk copies), and the unit as the source chooses it:
    # 8 columns at config 2's D (128 units on the 131 blocks beside the
    # sweep's, one round), 32 at the 10k shape, narrower where 32 does not
    # fit (MP 224), within the card's shared memory beside the static.
    src, consts = _obs_step_consts()
    assert ("fl = std::max(fl, (size_t)(mp * pl + 8 * mp + mp * nbp + rp * pl + nbp * unit));"
            in src)
    assert ("fl = std::max(fl, (size_t)(mp * pl + mp * mp + OS_XG * unit + 2 * mp + 16));"
            in src)
    assert ("fl = std::max(fl, csl_sweep::smem_bytes(mp, 32 * ((mp + 31) / 32)) / sizeof(float)"
            " + 2 * mp);" in src)
    assert "size_t fl = (size_t)csl_obs_smem_floats(mp, rp, nbp, OS_BAND);" in src
    assert "const int pl = unit + 4;" in src
    mp = 32 * rx
    rp = tfk.frame_shapes(mp // 2)[1]
    for nbp in (16, 24, 56, 200):
        for unit in (8, 16, 24, 32):
            pl = unit + 4
            phases = (tfk._obs_smem_bytes(mp, rp, nbp), tfk._sweep_smem_bytes(mp) + 8 * mp,
                      4 * (mp * pl + 8 * mp + mp * nbp + rp * pl + nbp * unit),
                      4 * (mp * pl + mp * mp + consts["OS_XG"] * unit + 2 * mp + 16))
            assert tfk._obs_step_smem_bytes(mp, rp, nbp, unit) == max(phases)
    for d, sms, want in ((1024, 132, 8), (1003, 132, 8), (2304, 132, 24), (20_224, 132, 32),
                         (13, 132, 8), (1024, 64, 24)):
        unit = tfk.obs_step_unit(d, mp, rp, 24, sms)
        fits = tfk._obs_step_smem_bytes(mp, rp, 24, unit) + tfk.OS_STATIC_BYTES
        assert fits <= cuda.MAX_SMEM_BYTES and unit % tfk.OS_COLS == 0
        assert unit == want or (mp == 224 and want == 32 and unit == 24), (d, sms, mp, unit)
        if unit == want:
            assert -(-tfk._round_up(d, 4) // unit) <= sms - 1 or unit == tfk.OS_MAX_UNIT


def test_recursion_bound_matches_the_kernel_source():
    # CSL_MAX_STEPS and the recursion's shared memory (coeff.cuh) as the
    # wrappers and routes read them.
    src = (cuda.CSRC / "coeff.cuh").read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (CSL_\w+) +(\d+)", src)}
    assert consts["CSL_MAX_STEPS"] == tfk.MAX_STEPS == 256
    for s in (1, 16, 17, 256):
        cols = 4 * (2 + 3 * s)
        assert tfk._coeff_smem_floats(s) == cols + (consts["CSL_COEFF_IN"]
                                                    + consts["CSL_COEFF_TERMS"]) * s
    # H2 and H9 hold 256 sub-steps at every MP they take.
    for mp in range(32, 225, 32):
        rp = tfk.frame_shapes(mp // 2)[1]
        band = tfk.frame_chain_plan(mp).band
        assert tfk._chain_smem_bytes(mp, rp, band, 256) <= cuda.MAX_SMEM_BYTES
        assert (tfk._frame_step_smem_bytes(mp, rp, band, 256) + tfk.FS_STATIC_BYTES
                <= cuda.MAX_SMEM_BYTES)


# ------------------------------------- F3b: frames past 16 sub-steps


def _frame_step_args(prob):
    t = [torch.as_tensor(prob[k]) for k in KEYS]
    return (t[0], t[1], torch.as_tensor(prob["slots"]), prob["capacity"], *t[3:])


@pytest.mark.parametrize("nz,use_heading,s", [(10, True, 17), (64, True, 33), (10, True, 64)])
def test_frame_step_past_16_sub_steps_matches_reference_kernel(nz, use_heading, s):
    # The known frame through frame_step's route (H9's plain version on the
    # CPU) against the reference's resident kernel in interpret mode, at
    # the reference's frame tolerances (tests/test_torch_framestep.py).
    prob = _problem(73 + s, nz, s)
    d = prob["p"].shape[0]
    assert tfk.frame_route(d, nz, "cpu", s) == "resident" and jfk.can_fuse_frame_step(d, nz)
    ref = jfk.frame_step(*_jax_args(prob), *TAIL, use_heading, interpret=True)
    got = tfk.frame_step(*_frame_step_args(prob), *TAIL, use_heading)
    # Over up to 64 sub-steps the pose reaches ~55 m: a few fp32 ulps there.
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(ref.pose_trace), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)
    split = tfk.frame_step(*_frame_step_args(prob), *TAIL, use_heading, schedule="split")
    np.testing.assert_allclose(got.x.numpy(), split.x.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), split.p.numpy(), rtol=1e-3, atol=1e-4)


def _witness_distances(routes, wit) -> dict:
    """Each route's largest distance from the float64 witness in x and P."""
    return {name: (np.abs(np.asarray(r.x, np.float64) - wit.x.numpy()).max(),
                   np.abs(np.asarray(r.p, np.float64) - wit.p.numpy()).max())
            for name, r in routes.items()}


@pytest.mark.parametrize("nz,s", [(64, 33), (10, 64)])
def test_frame_step_without_heading_past_16_sub_steps_against_witness(nz, s):
    # F4b: the known frame with the heading update off past 16 sub-steps,
    # on the heading-on cases' frames above.  Without the heading update S
    # is ill-conditioned, and the fp32 routes of the sweep inverse scatter
    # around a float64 witness (the port's oracle: fastframe factors, dense
    # products, a Cholesky inverse).  Two bounds, each with its reason:
    #  * x: every fp32 route (the port's plain version, H9's on the CPU; the
    #    reference's resident kernel in interpret mode and its jnp route)
    #    within 8 kappa u |dx| of the witness, kappa the condition number
    #    of the Jacobi-scaled S the sweep inverts, u = 2^-24 and |dx| the
    #    frame's largest mean correction: the first-order forward error of
    #    an fp32 solve, with a small constant.  A route that missed or
    #    doubled a term of the correction would lie orders of magnitude
    #    outside it.
    #  * x, the port against the reference: on the S 64 frame the port's
    #    plain version lies nearer the witness than either reference route
    #    (1.9e-4 against 5.4e-4 and 9.0e-4), and must stay no further than
    #    the nearer of them, so that a drift of ~3x fails.  The S 33 frame
    #    is F5 (ROADMAP): there the reference's kernel lies ~4x nearer in x
    #    (the port's plain version ~2.7 kappa u |dx| from the witness, the
    #    reference's kernel ~0.65) and the port ~30x nearer in P, so only
    #    the conditioning bound holds x.  F5 closes when a bound over
    #    several frames of that conditioning holds every route, the port
    #    no further from the witness than the reference's kernel.
    #  * P: the port no further than twice the farther of the reference's
    #    two routes, plus 1e-4, the card tests' rule for H9 on these frames.
    # The pose trace is the reference kernel's to a few fp32 ulps of ~55 m.
    prob = _problem(73 + s, nz, s)
    d = prob["p"].shape[0]
    assert tfk.frame_route(d, nz, "cpu", s) == "resident" and jfk.can_fuse_frame_step(d, nz)
    jargs = _jax_args(prob)
    routes = {
        "reference kernel": jfk.frame_step(*jargs, *TAIL, False, interpret=True),
        "reference jnp route": jax.jit(jfk.frame_step, static_argnums=(12, 13, 14, 15))(
            *jargs, *TAIL, False),
        "port": tfk.frame_step(*_frame_step_args(prob), *TAIL, False),
    }
    t = {k: torch.as_tensor(prob[k]) for k in KEYS}
    t = {k: v.double() if v.dtype == torch.float32 else v for k, v in t.items()}
    mp, rp = tfk.frame_shapes(nz)
    zin, rsc, _ = tfk._pack_meas(t["zr"], t["zb"], t["mask"], t["r"], mp // 2)
    wit = tfk._frame_step_reference(*(t[k] for k in KEYS[:8]), zin, rsc, mp, rp, *TAIL, False)
    fi = tfk.frame_inputs(*(t[k] for k in KEYS))
    sm = tfk._frame_chain_reference(fi.subs, fi.qc, fi.zin, fi.rsc, fi.x0rows, fi.prc, fi.mp,
                                    *TAIL, False).s[:2 * int(fi.nblk), :2 * int(fi.nblk)]
    scale = torch.rsqrt(torch.diagonal(sm))
    kappa = float(torch.linalg.cond(sm * scale[:, None] * scale[None, :]))
    dx = float((wit.x - t["x"]).abs().max())
    e = _witness_distances(routes, wit)
    bound = 8.0 * kappa * 2.0**-24 * dx
    assert all(ex <= bound for ex, _ in e.values()), (bound, e)
    if s != 33:        # S 33 is F5's frame (above)
        assert e["port"][0] <= min(e["reference kernel"][0], e["reference jnp route"][0]), e
    far = max(e["reference kernel"][1], e["reference jnp route"][1])
    assert e["port"][1] <= 2.0 * far + 1e-4, e
    np.testing.assert_allclose(routes["port"].pose_trace.numpy(),
                               np.asarray(routes["reference kernel"].pose_trace), rtol=1e-5,
                               atol=1e-4)


def test_gated_frame_at_the_resident_edge_against_witness():
    # F4a: the gated frame at MP 224 with NBP 216 (S 71 with the heading
    # update), tests/test_torch_cuda.py's resident-edge frame, at D 256
    # where the reference's one-dispatch gated frame holds it.  The same
    # factors (H5's plain version) go to both packages.  S is
    # ill-conditioned (NIS ~9e6): the port's plain version (H10's) is held
    # to a float64 witness (the port's Cholesky-route oracle) no further
    # than twice the reference's _fullframe_kernel in interpret mode, plus
    # 1e-5 in x (fp32 ulps of |x| < 64 m) and 1e-6 in P, as F1 holds the
    # known frame; and the reference's jnp route is no nearer than a tenth
    # of the port's distance (a route that far nearer would point at a
    # fault of the port's sweep or chain).
    import torch.nn.functional as F

    from conan_slam_tpu_torch.ops.factor_kernel import _frame_factors_reference

    prob = _problem(224, 112, 71)
    state = EKFState(x=torch.as_tensor(prob["x"]), p=torch.as_tensor(prob["p"]),
                     n_active=torch.tensor(126), table=torch.zeros(1, dtype=torch.int64))
    t = {k: torch.as_tensor(prob[k]) for k in KEYS}
    st1, _, vtf, bmat = _frame_factors_reference(state, t["vns"], t["swans"], t["phis"],
                                                 t["act"], t["q"], *TAIL, True)
    d, nbp = prob["p"].shape[0], bmat.shape[0]
    assert nbp == 216 and tfk.frame_shapes(112)[0] == 224
    assert jfk.can_fuse_frame(d, 112, nbp) and tfk.obs_route(d, 112, nbp, "cpu") == "resident"
    port_args = (state.p, st1.x, torch.as_tensor(prob["slots"]), prob["capacity"], t["zr"],
                 t["zb"], t["mask"], t["r"], bmat, vtf)
    ref_args = (*(jnp.asarray(a.numpy()) for a in (state.p, st1.x)), _jax_args(prob)[2],
                *(jnp.asarray(a.numpy()) for a in (t["zr"], t["zb"], t["mask"], t["r"], bmat,
                                                   vtf)))
    routes = {"reference kernel": jfk.frame_update_obs(*ref_args, interpret=True),
              "reference jnp route": jax.jit(jfk.frame_update_obs)(*ref_args),
              "port": tfk.frame_update_obs(*port_args)}
    f64 = torch.float64
    rows = tfk.frame_rows(port_args[2], prob["capacity"])
    mp, rp = tfk.frame_shapes(112)
    zin, rsc, _ = tfk._pack_meas(t["zr"].to(f64), t["zb"].to(f64), t["mask"], t["r"].to(f64),
                                 mp // 2)
    pad = rp - rows.shape[0]
    wit = tfk._frame_update_obs_reference(state.p.to(f64), st1.x.to(f64),
                                          F.pad(rows, (0, pad), value=-1),
                                          F.pad(state.p[rows].to(f64), (0, 0, 0, pad)), zin, rsc,
                                          bmat.to(f64), vtf.to(f64), mp, rp)
    assert float(wit.nis) > 1e6
    e = _witness_distances(routes, wit)
    assert e["port"][0] <= 2.0 * e["reference kernel"][0] + 1e-5, e
    assert e["port"][1] <= 2.0 * e["reference kernel"][1] + 1e-6, e
    assert e["reference jnp route"][0] >= 0.1 * e["port"][0], e
    np.testing.assert_allclose(float(routes["port"].nis), float(wit.nis), rtol=1e-3)


@pytest.mark.parametrize("use_heading", [True, False])
def test_factors_past_16_sub_steps_match_reference_kernel(use_heading):
    # H5's plain version at S = 33 against the reference's factor kernel in
    # interpret mode, at its own tolerances (tests/test_torch_gated.py).
    prob = _problem(33, 10, 33)
    j = dict(zip(KEYS, _jax_args(prob)))
    jstate = jekf.init_state_with_map(np.zeros((126, 2), np.float32), pad_multiple=128)
    jstate = jstate._replace(p=j["p"], x=j["x"])
    r_state, r_pt, r_vtf, r_b = j_frame_factors_fused(
        jstate, j["vns"], j["swans"], j["phis"], j["act"], j["q"], *TAIL, use_heading,
        interpret=True)
    t = lambda k: torch.as_tensor(prob[k])   # noqa: E731
    state = EKFState(x=t("x"), p=t("p"), n_active=torch.tensor(126),
                     table=torch.zeros(1, dtype=torch.int64))
    g_state, g_pt, g_vtf, g_b = frame_factors_fused(state, t("vns"), t("swans"), t("phis"),
                                                    t("act"), t("q"), *TAIL, use_heading)
    np.testing.assert_allclose(g_state.x.numpy(), np.asarray(r_state.x), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_pt.numpy(), np.asarray(r_pt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_vtf.numpy(), np.asarray(r_vtf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g_b.numpy(), np.asarray(r_b), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d,s,route", [(2304, 17, "resident"), (2304, 33, "resident"),
                                       (2051, 64, "resident"), (2304, 256, "resident"),
                                       (2304, 257, "unported"), (2051, 257, "plain")])
def test_frame_route_past_16_sub_steps(d, s, route):
    assert tfk.frame_route(d, 64, "cpu", s) == route
    assert tfk.frame_route(d, 64, "cpu", s, "split") == ("split" if s <= 256 else route)
    assert tfk.frame_route(d, 120, "cpu", s) == ("split" if s <= 256 else route)


def test_factors_past_the_kernel_bound_follow_the_reference():
    # 257 sub-steps: past H5's bound.  On the CPU the plain version runs;
    # the route on the card is the F2 rule: the plain version where the
    # reference, too, has no TPU kernel (D not a multiple of 128), else a
    # raise.  Here: the CPU's plain version, no launch.
    prob = _problem(35, 10, 257, capacity=100, pad_multiple=0)
    t = lambda k: torch.as_tensor(prob[k])   # noqa: E731
    state = EKFState(x=t("x"), p=t("p"), n_active=torch.tensor(100),
                     table=torch.zeros(1, dtype=torch.int64))
    cuda.reset_launch_counts()
    st1, pt, vtf, bmat = frame_factors_fused(state, t("vns"), t("swans"), t("phis"), t("act"),
                                             t("q"), *TAIL, True)
    assert not any(k.launches for k in cuda.KERNELS.values())
    assert pt.shape == (257, 3) and vtf.shape == (776, 203) and bool(
        torch.isfinite(st1.x).all())
