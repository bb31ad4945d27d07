"""Port parity for the resident frame (H9, ops.frame_kernel ``frame_step``'s
default route) and the route a frame takes (``frame_route``,
``obs_route``).

On the CPU the resident route runs H9's plain version,
``_frame_step_resident_reference``.  It is held to the reference's resident
schedule (its ``_framestep_kernel`` in interpret mode, as
tests/test_pallas_ops.py runs it) and to the reference's jnp route, at the
reference's own frame-test tolerances (tests/test_pallas_ops.py:321-333:
pose trace rtol/atol 1e-5, x 1e-4, P rtol 1e-3 / atol 1e-4, NIS rtol
1e-3), which cover its bf16 split3 panel tier.  Past MP 224 (H1's
register limit) a frame takes the split schedule, whose H1 is then one
cooperative launch.  Past the port's kernels (16 sub-steps, MP 2048) it
takes the plain route, the reference's jnp route, where the reference has
no TPU schedule either; where it has one the frame is "unported": it raises
on the card and runs the plain route on the CPU.  tests/test_torch_cuda.py
holds H9 to this plain version on a card.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.filters.ekf.fastframe import frame_predict_heading
from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu_torch.ops import cuda, frame_kernel as tfk

torch.set_num_threads(2)

TAIL = (73.0, 0.01, 0.01 * np.pi / 180)
KEYS = ("p", "x", "rows", "vns", "swans", "phis", "act", "q", "zr", "zb", "mask", "r")


def _problem(seed, nz, s, capacity=100, pad_multiple=128):
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
    return dict(
        p=np.asarray(state.p) + a @ a.T, x=np.array(state.x), slots=ids.astype(np.int64), lm=lm,
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


def _args(prob):
    """``frame_step``'s arguments: the raw slots and the capacity in place
    of the reference's gathered rows."""
    t = [torch.as_tensor(prob[k]) for k in KEYS]
    return (t[0], t[1], torch.as_tensor(prob["slots"]), len(prob["lm"]), *t[3:])


def _resident(prob, use_heading):
    """The frame as fused_frame_step runs it: H9's plain version on the CPU."""
    return tfk.frame_step(*_args(prob), *TAIL, use_heading)


def _witness_x(prob, use_heading):
    """The frame's mean in float64 through the port's independent oracle
    (fastframe factors, dense products, a Cholesky inverse)."""
    t = {k: torch.as_tensor(prob[k]) for k in KEYS}
    t = {k: v.double() if v.dtype == torch.float32 else v for k, v in t.items()}
    mp, rp = tfk.frame_shapes(t["zr"].shape[0])
    zin, rsc, _ = tfk._pack_meas(t["zr"], t["zb"], t["mask"], t["r"], mp // 2)
    return tfk._frame_step_reference(*(t[k] for k in KEYS[:8]), zin, rsc, mp, rp, *TAIL,
                                     use_heading).x.numpy()


def _assert_frame_close(got, ref, witness=None, pose_atol=1e-5):
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(ref.pose_trace),
                               rtol=1e-5, atol=pose_atol)
    if witness is None:
        np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    else:
        e_got = np.abs(got.x.numpy() - witness).max()
        e_ref = np.abs(np.asarray(ref.x, np.float64) - witness).max()
        assert e_got <= 2.0 * e_ref + 1e-5, (e_got, e_ref)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)


CASES = [(10, True, 6), (64, True, 6), (64, False, 16), (10, True, 1)]
# The F1 frame (NZ 64, heading off, S 16; tests/test_torch_ops.py
# test_chain_and_panels_match_reference_chain_dispatch): S is conditioned so
# that the sweep inverse's fp32 rounding moves the mean by ~1e-4 in both
# packages (a float64 witness: the port 1.45e-4 from it, the reference's
# interpreted sweep kernel 1.10e-4, 2.6e-4 apart).  Against that kernel the
# mean is held to the witness instead: no further from it than twice the
# reference, plus 1e-5 (a few fp32 ulps of |x| < 64 m).
WITNESS_CASES = {((64, False, 16), "resident kernel")}


@pytest.mark.parametrize("reference", ["resident kernel", "jnp route"])
@pytest.mark.parametrize("nz,use_heading,s", CASES)
def test_resident_matches_reference(nz, use_heading, s, reference):
    prob = _problem(73, nz, s)
    d = prob["p"].shape[0]
    assert d == 256 and jfk._pick_framestep_tile(d, -(-2 * nz // 128) * 128,
                                                 -(-(3 + 2 * nz) // 8) * 8) > 0
    ref_step = (functools.partial(jfk.frame_step, interpret=True) if reference == "resident kernel"
                else jax.jit(jfk.frame_step, static_argnums=(12, 13, 14, 15)))
    ref = ref_step(*_jax_args(prob), *TAIL, use_heading)
    got = _resident(prob, use_heading)
    witness = (_witness_x(prob, use_heading) if ((nz, use_heading, s), reference) in WITNESS_CASES
               else None)
    _assert_frame_close(got, ref, witness)
    # frame_step's default route on the CPU is H9's plain version.
    assert tfk.frame_route(d, nz, "cpu", s) == "resident"
    fi = tfk.frame_inputs(*(torch.as_tensor(prob[k]) for k in KEYS))
    direct = tfk._frame_step_resident_reference(torch.as_tensor(prob["p"]),
                                                torch.as_tensor(prob["x"]), fi, *TAIL, use_heading)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)


def test_resident_all_masked_is_factor_only():
    # No associated measurement: the frame is the factored predict + heading
    # correction alone, with a NIS of 0 (tests/test_pallas_ops.py:366-395).
    prob = _problem(43, 10, 6)
    prob["mask"][:] = False
    state = jekf.init_state_with_map(np.zeros((100, 2), np.float32), pad_multiple=128)
    state = state._replace(p=jnp.asarray(prob["p"]), x=jnp.asarray(prob["x"]))
    ref = frame_predict_heading(state, *(jnp.asarray(prob[k]) for k in ("vns", "swans", "phis",
                                                                          "act", "q")),
                                *TAIL, True)
    got = _resident(prob, True)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    assert float(got.nis) == 0.0


@pytest.mark.parametrize("nz,use_heading,s", CASES)
def test_resident_and_split_plain_versions_agree(nz, use_heading, s):
    # The same frame through both schedules' plain versions: the closed form
    # against the p2 row vs G^T M G, fp32 rounding only.
    prob = _problem(97 + nz, nz, s)
    split = tfk.frame_step(*_args(prob), *TAIL, use_heading, schedule="split")
    _assert_frame_close(_resident(prob, use_heading), split)


def test_frame_rows_match_reference_rows():
    # The gathered rows H9 forms on the card, as fused_frame_step formed them
    # (slots clamped to the capacity).
    slots = torch.tensor([4, -1, 99, 100, 7])
    got = tfk.frame_rows(slots, 100)
    safe = np.clip(slots.numpy(), 0, 99)
    want = np.concatenate([np.arange(3), (3 + 2 * safe[:, None] + np.arange(2)).reshape(-1)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,nz,s,schedule,route", [
    (2304, 64, 6, "auto", "resident"),      # the bench shape
    (2051, 64, 6, "auto", "resident"),
    (2304, 64, 6, "split", "split"),
    (2304, 112, 6, "auto", "resident"),     # MP 224: the largest H1 holds in registers
    # MP 240 and on: the split schedule, H1 one cooperative launch.
    (2304, 120, 6, "auto", "split"),
    (2304, 120, 6, "split", "split"),
    (403, 120, 6, "auto", "split"),
    (1003, 500, 6, "auto", "split"),        # SlamConfig()'s NZ = every landmark
    # Past 16 sub-steps (one warp's lanes until F3b): H9.
    (2304, 64, 17, "auto", "resident"),
    (2051, 64, 33, "auto", "resident"),
    (2304, 64, 256, "auto", "resident"),
    (2304, 120, 64, "auto", "split"),
    # Past the port's 256 sub-steps: the reference's streaming chain kernel
    # has a tile at D = 2304, none at a D that is no multiple of 128.
    (2304, 64, 257, "auto", "unported"),
    (2051, 64, 257, "auto", "plain"),
    (2304, 1100, 6, "auto", "plain"),       # past MP 2048, and past the reference's VMEM
    (13, 5, 1, "auto", "resident"),
])
def test_frame_route(d, nz, s, schedule, route):
    assert tfk.frame_route(d, nz, "cpu", s, schedule) == route
    if route in ("plain", "unported"):      # "unported": the reference has a TPU schedule
        assert (route == "unported") == jfk.can_fuse_frame_step(d, nz)
    with pytest.raises(ValueError):
        tfk.frame_route(d, nz, "cpu", s, "resident")


@pytest.mark.parametrize("d,nz,nbp,schedule,route", [
    (1024, 64, 24, "auto", "resident"), (1024, 10, 56, "auto", "resident"),
    (1024, 64, 24, "split", "split"),
    # MP 160 to 224: H10 (until H7 ran in bands these raised or took the
    # plain route: H7's one block outgrew shared memory from MP 160).
    (1024, 112, 24, "auto", "resident"), (2304, 112, 24, "auto", "resident"),
    (1024, 80, 24, "auto", "resident"),
    # Past MP 224: the split, H7 in bands and H1's cooperative sweep.
    (1024, 120, 24, "auto", "split"), (2304, 120, 24, "auto", "split"),
    (403, 120, 24, "auto", "split"), (1003, 500, 24, "auto", "split"),
    (128, 320, 776, "auto", "split"),   # the reference's largest NZ at D = 128, S = 256
    # Past MP 2048: the reference's gated frame has no row panel there.
    (2304, 1100, 24, "auto", "plain"), (2304, 1100, 24, "split", "plain"),
])
def test_obs_route(d, nz, nbp, schedule, route):
    assert tfk.obs_route(d, nz, nbp, "cpu", schedule) == route
    if route in ("plain", "unported"):
        assert (route == "unported") == jfk.can_fuse_frame(d, nz, nbp)
    with pytest.raises(ValueError):
        tfk.obs_route(d, nz, nbp, "cpu", "resident")


def _big_problem(seed=101, nz=1030):
    """A gated frame past the kernels' limits: NZ 1030 (MP 2080, past H1's
    2048) of 1030 landmarks, D = 2063 (unpadded)."""
    return _problem(seed, nz, 6, capacity=nz, pad_multiple=0)


@pytest.mark.parametrize("capacity,pad,route", [(200, 0, "plain"), (126, 128, "unported")])
def test_frame_step_past_the_kernels_takes_the_plain_route(capacity, pad, route):
    # 257 sub-steps, past the port's 256, at D = 403 (plain) and D = 256
    # (unported: the reference has a TPU schedule, so the card raises; the
    # CPU runs the plain route).
    prob = _problem(101, 10, 257, capacity=capacity, pad_multiple=pad)
    assert tfk.frame_route(prob["p"].shape[0], 10, "cpu", 257) == route
    # Eager: jit would trace and compile all 257 sub-steps unrolled (minutes).
    ref = jfk.frame_step(*_jax_args(prob), *TAIL, True)
    cuda.reset_launch_counts()
    got = tfk.frame_step(*_args(prob), *TAIL, True)
    assert not any(k.launches for k in cuda.KERNELS.values())
    # Both plain routes carry the pose over 17 sub-steps to ~100 m, where
    # the fp32 spacing is 7.6e-6 m: a few ulps there (observed 2.8e-5 over
    # seeds 101-105) reach the heading's small entries, so the pose trace
    # takes 1e-4 absolute.
    _assert_frame_close(got, ref, pose_atol=1e-4)


def test_frame_step_past_mp_224_takes_the_split_schedule():
    # MP 240 at D = 256, where the reference runs its streaming chain kernel:
    # the port's split schedule (its plain versions on the CPU; on the card
    # H1 is one cooperative launch) against the reference's jnp route.
    prob = _problem(103, 120, 6, capacity=126)
    assert tfk.frame_route(prob["p"].shape[0], 120, "cpu", 6) == "split"
    assert jfk.can_fuse_frame_step(prob["p"].shape[0], 120)
    ref = jax.jit(jfk.frame_step, static_argnums=(12, 13, 14, 15))(*_jax_args(prob), *TAIL, True)
    _assert_frame_close(tfk.frame_step(*_args(prob), *TAIL, True), ref)


def test_frame_step_pair_past_the_kernels_is_two_plain_frames():
    # Frame B sees the same landmarks with other controls; 257 sub-steps.
    prob = _problem(101, 10, 257, capacity=200, pad_multiple=0)
    t = {k: torch.as_tensor(prob[k]) for k in KEYS}
    slots = torch.as_tensor(prob["slots"])
    ctrl_a = (t["vns"], t["swans"], t["phis"], t["act"])
    ctrl_b = (t["vns"] + 0.1, t["swans"] * 0.5, t["phis"], t["act"])
    meas = (t["zr"], t["zb"], t["mask"])
    pair = tfk.frame_step_pair(t["p"], t["x"], t["rows"], ctrl_a, meas, t["rows"], ctrl_b, meas,
                               t["q"], t["r"], *TAIL, True)
    assert tfk.frame_route(prob["p"].shape[0], 10, "cpu", 257, "split") == "plain"
    fa = tfk.frame_step(t["p"], t["x"], slots, 200, *ctrl_a, t["q"], *meas, t["r"], *TAIL, True)
    fb = tfk.frame_step(fa.p, fa.x, slots, 200, *ctrl_b, t["q"], *meas, t["r"], *TAIL, True)
    for got, want in ((pair.p, fb.p), (pair.x, fb.x), (pair.pose_mid, fa.x[:3]),
                      (pair.nis, torch.stack([fa.nis, fb.nis])),
                      (pair.pose_trace, torch.stack([fa.pose_trace, fb.pose_trace]))):
        assert torch.equal(got, want)


def test_frame_update_obs_past_the_kernels_takes_the_plain_route():
    from conan_slam_tpu.ops.factor_kernel import frame_factors_fused as j_frame_factors_fused

    prob = _big_problem()
    j = dict(zip(KEYS, _jax_args(prob)))
    state = jekf.init_state_with_map(np.zeros((1030, 2), np.float32), pad_multiple=0)
    state = state._replace(p=j["p"], x=j["x"])
    st1, _, vtf, bmat = j_frame_factors_fused(state, j["vns"], j["swans"], j["phis"], j["act"],
                                              j["q"], *TAIL, True)
    ref = jax.jit(jfk.frame_update_obs)(st1.p, st1.x, j["rows"], j["zr"], j["zb"], j["mask"],
                                        j["r"], bmat, vtf)
    assert tfk.obs_route(2063, 1030, vtf.shape[0], "cpu") == "plain"
    t = lambda a: torch.as_tensor(np.array(a))   # noqa: E731
    cuda.reset_launch_counts()
    got = tfk.frame_update_obs(t(st1.p), t(st1.x), t(prob["slots"]), 1030, t(prob["zr"]),
                               t(prob["zb"]), t(prob["mask"]), t(prob["r"]), t(bmat), t(vtf))
    assert not any(k.launches for k in cuda.KERNELS.values())
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)


def _frame_step_consts():
    src = (cuda.CSRC / "frame_step.cu").read_text()
    return src, {k: int(v) for k, v in re.findall(r"#define (FS_\w+) +(\d+)", src)}


def test_frame_step_constants_match_the_kernel_source():
    src, consts = _frame_step_consts()
    assert consts["FS_THREADS"] == tfk.FS_THREADS
    assert consts["FS_W"] == tfk.FS_W
    assert consts["FS_LD"] == tfk.FS_LD
    assert consts["FS_UNIT"] == tfk.FS_UNIT
    assert consts["FS_STAMPS"] == tfk.FS_STAMPS
    assert consts["FS_XG"] == tfk.FS_XG
    assert consts["FS_PLAN"] == tfk.FS_PLAN
    assert consts["FS_MAX_RP"] == tfk.FS_MAX_RP == tfk.frame_shapes(112)[1]
    assert consts["FS_MAX_MP"] == tfk.MAX_MP
    # Two launches a call: the frame kernel, then the P pass on the route
    # resident.cuh's pass_route picks from D and the SM count (H4's
    # 32-tiles, or the streamed 128-tiles), with the programmatic launch
    # (the pass's body, rule, plan and launch shared with H10 in
    # resident.cuh).
    shared = (cuda.CSRC / "resident.cuh").read_text()
    assert tfk.FS_LAUNCHES == 2 == tfk.FRAME_STEP.launches_per_call
    assert "frame_pass_kernel<R, VECP>" in src and "csl_res::pass_tiles<R, VECP>" in src
    assert "route = csl_res::pass_route(d, info->sms, vec);" in src
    assert "launch_pass<PASS_128, true>" in src and "launch_pass<PASS_32, true>" in src
    assert "inline int pass_route(int d, int sms, bool vec)" in shared
    assert "csl_sp::stream_tiles(" in shared
    assert "cudaLaunchAttributeProgrammaticStreamSerialization" in shared
    assert "griddepcontrol.wait" in shared
    # The largest frame H9 holds fits a block with its static shared memory.
    mp, rp = tfk.frame_shapes(112)
    assert (tfk._frame_step_smem_bytes(mp, rp, tfk.frame_chain_plan(mp).band)
            + tfk.FS_STATIC_BYTES <= cuda.MAX_SMEM_BYTES)


@pytest.mark.parametrize("rx", range(1, 8))
def test_frame_step_smem_mirrors_the_kernel_source(rx):
    # H9's frame kernel at every RX: the Python mirror of its shared memory
    # reads the source's phases (the sweep with v and siv, the pht units,
    # the gains: the unit's pht, S^-1, the mean's partials, v, siv, ms and
    # the mbarriers of its bulk copies), all within the card's beside the
    # static shared memory at 256 sub-steps; and at the bench D every block
    # but the sweep's takes one unit of FS_UNIT columns, so the gains run
    # in one round on the pht the block kept.
    src, consts = _frame_step_consts()
    assert "return mp * (mp + 1) + mp + 8 * 32 * ((mp + 31) / 32) + 2 * mp;" in src
    assert "return mp * FS_UNIT + mp * mp + FS_XG * FS_UNIT + 2 * mp + 32 + 16;" in src
    assert "fl = std::max(fl, (size_t)(mp * FS_UNIT + 8 * mp + 32 + rp * FS_LD));" in src
    mp = 32 * rx
    rp = tfk.frame_shapes(mp // 2)[1]
    band = tfk.frame_chain_plan(mp).band
    u = consts["FS_UNIT"]
    phases = (tfk._sweep_smem_bytes(mp) + 4 * 2 * mp,
              4 * (mp * u + 8 * mp + tfk.MS_LEN + tfk.FS_LD * rp),
              4 * (mp * u + mp * mp + tfk.FS_XG * u + 2 * mp + tfk.MS_LEN + 16))
    for s in (1, 6, 256):
        chain = tfk._chain_smem_bytes(mp, rp, band, s) + 16 * s
        assert tfk._frame_step_smem_bytes(mp, rp, band, s) == max(chain, *phases)
    assert max(phases) + tfk.FS_STATIC_BYTES <= cuda.MAX_SMEM_BYTES
    assert (tfk._frame_step_smem_bytes(mp, rp, band, 256) + tfk.FS_STATIC_BYTES
            <= cuda.MAX_SMEM_BYTES)
    assert -(-2304 // u) <= tfk.N_SM - 1


def test_sweep_constants_match_the_kernel_source():
    # H1's limits as its wrapper and the routes read them, and the
    # cooperative sweep's plan at every size it takes past MP 224: even
    # bands within a block's shared memory, no more blocks than the H100's
    # SMs (a cooperative launch needs every block resident).
    from conan_slam_tpu_torch.ops import spd_inverse as spd

    src = (cuda.CSRC / "sweep_inverse.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert consts["REG_MAX_MP"] == spd.MAX_MP
    assert consts["COOP_MAX_MP"] == spd.MAX_MP_COOP
    assert consts["COOP_BLOCKS"] == spd.COOP_BLOCKS
    for mp in range(spd.MAX_MP + 2, spd.MAX_MP_COOP + 1, 2):
        band = spd.coop_band(mp)
        assert band >= 2 and band % 2 == 0
        assert spd.sweep_fits(mp) and spd._sweep_smem_bytes(mp) <= cuda.MAX_SMEM_BYTES
        assert -(-mp // band) <= tfk.N_SM
    assert not spd.sweep_fits(spd.MAX_MP_COOP + 2) and not spd.sweep_fits(241)
