"""Port parity: the kernel modules (ops.spd_inverse, ops.rank_update,
ops.frame_kernel) against the JAX reference.

On the CPU every port wrapper runs its kernel's plain PyTorch version; the
reference runs its Pallas kernels in interpret mode (or its jnp route), as
its own tests do.  Tolerances start from the reference's own
(tests/test_pallas_ops.py): pose 1e-5, x 1e-4, P rtol 1e-3 / atol 1e-4,
NIS rtol 1e-3.  tests/test_torch_cuda.py holds the CUDA kernels to the
same plain versions on a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_slam_tpu.filters import ekf as jekf
from conan_slam_tpu.ops import frame_kernel as jfk
from conan_slam_tpu.ops.pallas_update import rank_update_t as j_rank_update_t
from conan_slam_tpu.ops.spd_inverse import spd_inverse as j_spd_inverse
from conan_slam_tpu_torch.ops import cuda, frame_kernel as tfk
from conan_slam_tpu_torch.ops.rank_update import rank_update_t
from conan_slam_tpu_torch.ops.spd_inverse import (
    spd_inverse,
    sweep_si,
    sweep_si_reference,
)

torch.set_num_threads(2)


def _spd(m, seed, mixed=True):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(m, m))
    s = h @ h.T + 0.1 * m * np.eye(m)
    if mixed:   # range^2 vs bearing^2 scales of an innovation covariance
        scale = np.where(rng.random(m) < 0.5, 1e-2, 1e1)
        s = s * np.outer(scale, scale)
    return s


@pytest.mark.parametrize("m", [60, 128])
def test_spd_inverse_matches_reference_sweep(m):
    s = _spd(m, 7)
    s32 = s.astype(np.float32)
    si_true = np.linalg.inv(s)
    ref = np.asarray(j_spd_inverse(jnp.asarray(s32), interpret=True), np.float64)
    chol = spd_inverse(torch.as_tensor(s32)).numpy().astype(np.float64)
    sweep = sweep_si_reference(torch.as_tensor(s32)).numpy().astype(np.float64)
    err_ref = np.abs(ref - si_true).max()
    # Both plain routes (Cholesky, sweep) are in the reference's accuracy
    # class (its own test: sweep within 5x the float32 Cholesky error).
    assert np.abs(chol - si_true).max() <= 5.0 * err_ref + 1e-12
    assert np.abs(sweep - si_true).max() <= 5.0 * err_ref + 1e-12
    np.testing.assert_allclose(sweep, ref, rtol=0, atol=2.0 * err_ref + 1e-12)
    np.testing.assert_array_equal(sweep, sweep.T)


@pytest.mark.parametrize("nblk", [7, 20, 32])
def test_sweep_si_nblk_matches_reference_kernel(nblk):
    # The reference's in-kernel _sweep_si with the serial-sweep bound, run
    # through a one-block pallas_call in interpret mode.
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    m = 64
    rng = np.random.default_rng(nblk)
    a = rng.normal(size=(m, m)).astype(np.float32)
    s = (a @ a.T / m + np.eye(m, dtype=np.float32)).astype(np.float32)

    def kernel(nb_ref, s_ref, out_ref, scr):
        out_ref[:, :] = jfk._sweep_si(s_ref[:, :], scr, nblk=nb_ref[0])

    ref = np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((m, m), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((m, m), jnp.float32)],
        interpret=True,
    )(jnp.asarray([nblk], jnp.int32), jnp.asarray(s)))
    got = sweep_si(torch.as_tensor(s), torch.tensor([nblk], dtype=torch.int32)).numpy()
    # Same algebra in the same order: a few float32 ulps of |S^-1| ~ 1.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if nblk == m // 2:
        np.testing.assert_allclose(got, np.linalg.inv(s.astype(np.float64)), atol=1e-4)


def test_sweep_si_symmetrizes_asymmetric_input():
    # The reference's divergence regression: an asymmetric S must give an
    # exactly symmetric S^-1 of sym(S).
    rng = np.random.default_rng(5)
    m = 128
    a = rng.normal(size=(m, m)).astype(np.float32)
    s = a @ a.T / m + np.eye(m, dtype=np.float32)
    e = rng.normal(size=(m, m)).astype(np.float32) * 1e-3
    s_asym = (s + (e - e.T)).astype(np.float32)
    si = sweep_si(torch.as_tensor(s_asym), torch.tensor([m // 2], dtype=torch.int32)).numpy()
    assert np.abs(si - si.T).max() < 1e-6
    ref = np.linalg.inv(0.5 * (s_asym + s_asym.T).astype(np.float64))
    np.testing.assert_allclose(si, ref, rtol=5e-3, atol=1e-4)


def test_inverse_guard_degrades_to_zero():
    s = torch.full((8, 8), float("nan"))
    assert torch.equal(spd_inverse(s), torch.zeros(8, 8))
    assert torch.equal(sweep_si(s, torch.tensor([4], dtype=torch.int32)), torch.zeros(8, 8))


@pytest.mark.parametrize("d", [256, 200])
def test_rank_update_t_matches_reference_kernel(d):
    rng = np.random.default_rng(d)
    r = 30
    p = rng.normal(size=(d, d)).astype(np.float32)
    p = p @ p.T
    vt = rng.normal(size=(r, d)).astype(np.float32)
    b = rng.normal(size=(r, r)).astype(np.float32)
    b = 0.5 * (b + b.T)
    ref = np.asarray(j_rank_update_t(jnp.asarray(p), jnp.asarray(vt), jnp.asarray(b),
                                     interpret=True))
    got = rank_update_t(torch.as_tensor(p), torch.as_tensor(vt), torch.as_tensor(b)).numpy()
    # |P| ~ d: float32 sums of ~r + d terms, the reference test's bound.
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)


def _frame_problem(seed, capacity=100, nz=10, s=6):
    """A whole-frame problem like the reference's _frame_step_problem
    (D = 256 after the pad to a multiple of 128), with S = ``s`` sub-steps,
    the last inactive when S > 1."""
    rng = np.random.default_rng(seed)
    lm = rng.uniform(-50, 50, size=(capacity, 2)).astype(np.float32)
    state = jekf.init_state_with_map(lm, sigma0=0.5, pad_multiple=128)
    d = state.x.shape[0]
    a = rng.normal(size=(d, 8)).astype(np.float32) * 0.05
    p = np.asarray(state.p) + a @ a.T
    ids = rng.choice(capacity, size=nz, replace=False).astype(np.int32)
    z = np.stack([
        np.hypot(lm[ids, 0], lm[ids, 1]) + rng.normal(size=nz) * 0.1,
        np.arctan2(lm[ids, 1], lm[ids, 0]) + rng.normal(size=nz) * 0.01,
    ], axis=-1).astype(np.float32)
    mask = np.ones(nz, bool)
    mask[-2] = False
    return dict(
        p=p, x=np.array(state.x), slots=ids.astype(np.int64), capacity=capacity,
        rows=np.concatenate([np.arange(3), (3 + 2 * ids[:, None] + np.arange(2)).reshape(-1)]),
        vns=(83.33 + rng.normal(size=s) * 0.3).astype(np.float32),
        swans=(rng.normal(size=s) * 0.2).astype(np.float32),
        phis=(rng.normal(size=s) * 0.5).astype(np.float32),
        act=np.arange(s) < max(1, s - 1),
        q=np.diag([0.3**2, (np.pi / 180) ** 2]).astype(np.float32),
        zr=z[:, 0], zb=z[:, 1], mask=mask,
        r=np.diag([0.1**2, 0.5 * np.pi / 180]).astype(np.float32),
    )


_KEYS = ("p", "x", "rows", "vns", "swans", "phis", "act", "q", "zr", "zb", "mask", "r")


def _port_args(prob):
    """The port's ``frame_step`` arguments: the raw slots and the capacity
    in place of the reference's gathered rows."""
    t = [torch.as_tensor(prob[k]) for k in _KEYS]
    return (t[0], t[1], torch.as_tensor(prob["slots"]), prob["capacity"], *t[3:])


def _run_both(prob, use_heading, **jax_kw):
    tail = (73.0, 0.01, 0.01 * np.pi / 180, use_heading)
    # The jnp route compiles faster whole than op by op; the interpreted
    # Pallas schedule runs faster eagerly.
    ref_step = (functools.partial(jfk.frame_step, **jax_kw) if jax_kw
                else jax.jit(jfk.frame_step, static_argnums=(12, 13, 14, 15)))
    ref = ref_step(*(jnp.asarray(prob[k].astype(np.int32) if k == "rows" else prob[k])
                     for k in _KEYS), *tail)
    got = tfk.frame_step(*_port_args(prob), *tail)
    return ref, got


def _assert_frame_close(got, ref):
    np.testing.assert_allclose(got.pose_trace.numpy(), np.asarray(ref.pose_trace),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(ref.p), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(got.nis), float(ref.nis), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("use_heading,seed", [(True, 61), (False, 67)])
def test_frame_step_matches_reference_cpu_route(use_heading, seed):
    ref, got = _run_both(_frame_problem(seed), use_heading)
    _assert_frame_close(got, ref)


def test_frame_step_matches_reference_big_schedule():
    # The schedule the port takes as its template: chain kernel + rank pass
    # (interpreted; use_heading=False is held to the jnp route above).
    ref, got = _run_both(_frame_problem(61), True, interpret=True, _force_schedule="big")
    _assert_frame_close(got, ref)


def test_frame_step_matches_port_oracle():
    # The split schedule vs the port's own fastframe + measurement-chain
    # oracle (the route `plain` steps/s are not taken from).
    prob = _frame_problem(71)
    t = {k: torch.as_tensor(prob[k]) for k in _KEYS}
    tail = (73.0, 0.01, 0.01 * np.pi / 180, True)
    got = tfk.frame_step(*_port_args(prob), *tail, schedule="split")
    mp, rp = tfk.frame_shapes(t["zr"].shape[0])
    zin, rsc, _ = tfk._pack_meas(t["zr"], t["zb"], t["mask"], t["r"], mp // 2)
    ref = tfk._frame_step_reference(t["p"], t["x"], t["rows"], t["vns"], t["swans"],
                                    t["phis"], t["act"], t["q"], zin, rsc, mp, rp, *tail)
    _assert_frame_close(got, ref)


@pytest.mark.parametrize("nz,use_heading,s", [
    (10, True, 6), (64, True, 6), (10, False, 6), (64, False, 1), (10, True, 16),
    (64, False, 16),
])
def test_chain_and_panels_match_reference_chain_dispatch(nz, use_heading, s):
    # H2 + H1 + H3's plain versions against the reference's T2 outputs
    # (its interpret-mode _chain_dispatch): pose trace, K4, S^-1, pht, xn,
    # NIS, over NZ (MP 32 and 128 in the port), the heading update and the
    # sub-step count.  The reference pads MP to 128 and the port to 32:
    # compare the live rows.
    #
    # (64, False, 16): both fp32 routes sit ~1e-4 from a float64 witness of
    # the frame's mean (the port's oracle in float64: the port 1.45e-4, the
    # reference 1.10e-4, 2.4e-4 apart), so the port's route does not drift:
    # the sweep inverse's fp32 rounding on this S moves xn in either
    # package.  There xn is held to the witness: no further from it than
    # twice the reference, plus 1e-5 (a few fp32 ulps of |x| < 64 m).
    prob = _frame_problem(73, nz=nz, s=s)
    tail = (73.0, 0.01, 0.01 * np.pi / 180, use_heading)
    j = {k: jnp.asarray(prob[k].astype(np.int32) if k == "rows" else prob[k]) for k in _KEYS}
    jmp, jrp = -(-2 * nz // 128) * 128, -(-(3 + 2 * nz) // 8) * 8
    zin, rsc, nblk = jfk._pack_meas(j["zr"], j["zb"], j["mask"], j["r"], jmp // 2, jnp.float32)
    subs, qc = jfk._pack_ctrl(j["vns"], j["swans"], j["phis"], j["act"], j["q"], jnp.float32)
    rows_full = jnp.concatenate([j["rows"], jnp.zeros((jrp - 2 * nz - 3,), jnp.int32)])
    prows = j["p"][rows_full]
    d = prows.shape[1]
    pht, xn, pt, nis, si, k4 = jfk._chain_dispatch(
        j["x"].reshape(1, d), subs, qc, zin, rsc, nblk, j["x"][rows_full].reshape(1, jrp),
        prows, prows[:, rows_full], 256, jmp, jrp, s, *tail, True)

    t = {k: torch.as_tensor(prob[k]) for k in _KEYS}
    mp, rp = tfk.frame_shapes(nz)
    tzin, trsc, tnblk = tfk._pack_meas(t["zr"], t["zb"], t["mask"], t["r"], mp // 2)
    tsubs, tqc = tfk._pack_ctrl(t["vns"], t["swans"], t["phis"], t["act"], t["q"])
    trows = torch.nn.functional.pad(t["rows"], (0, rp - t["rows"].shape[0]))
    tprows = t["p"][trows]
    ch = tfk.frame_chain(tsubs, tqc, tzin, trsc, t["x"][trows], tprows[:, trows], mp, *tail)
    tsi = sweep_si(ch.s, tnblk)
    tpht, txn, tnis = tfk.frame_panels(ch.rowc, ch.ms, tsi, tprows, t["x"])
    m2 = 2 * nz
    np.testing.assert_allclose(ch.pt.numpy(), np.asarray(pt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ch.k4.numpy()[:4, :4], np.asarray(k4)[:4, :4],
                               rtol=1e-4, atol=1e-9)
    si_ref = np.asarray(si)[:m2, :m2]
    np.testing.assert_allclose(tsi.numpy()[:m2, :m2], si_ref, rtol=1e-3,
                               atol=1e-4 * np.abs(si_ref).max())
    np.testing.assert_allclose(tpht.numpy()[:m2], np.asarray(pht)[:m2], rtol=1e-3, atol=1e-5)
    if (nz, use_heading, s) == (64, False, 16):
        t64 = {k: v.double() if v.dtype == torch.float32 else v for k, v in t.items()}
        zin64, rsc64, _ = tfk._pack_meas(t64["zr"], t64["zb"], t64["mask"], t64["r"], mp // 2)
        wit = tfk._frame_step_reference(*(t64[k] for k in _KEYS[:8]), zin64, rsc64, mp, rp,
                                        *tail).x.numpy()
        e_port = np.abs(txn.numpy() - wit).max()
        e_ref = np.abs(np.asarray(xn, np.float64)[0] - wit).max()
        assert e_port <= 2.0 * e_ref + 1e-5, (e_port, e_ref)
    else:
        np.testing.assert_allclose(txn.numpy(), np.asarray(xn)[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(tnis[0]), float(nis[0, 0]), rtol=1e-3, atol=1e-5)


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    cuda.reset_launch_counts()
    s = torch.eye(4)
    nblk = torch.tensor([2], dtype=torch.int32)
    assert torch.equal(sweep_si(s, nblk), torch.eye(4))
    assert all(k.launches == 0 for k in cuda.KERNELS.values())
    # A tensor that is neither on the CPU nor on CUDA is refused, as is a
    # mix of devices: no silent fallback.
    with pytest.raises(ValueError):
        sweep_si(s.to("meta"), nblk.to("meta"))
    with pytest.raises(ValueError):
        rank_update_t(torch.eye(3).to("meta"), torch.ones(1, 3), torch.ones(1, 1))
    # Every kernel of the port registers its launch count, once imported.
    from conan_slam_tpu_torch.ops import factor_kernel, gating_kernel, probes  # noqa: F401

    with pytest.raises(ValueError):
        tfk.obs_panels(*(torch.ones(2, 2).to("meta") for _ in range(6)))
    assert set(cuda.KERNELS) == {"sweep_inverse", "frame_chain", "frame_panels", "rank_update",
                                 "factor_strip", "gating_scores", "obs_chain", "obs_panels",
                                 "frame_step", "obs_step", "sweep_probe", "stream_copy",
                                 "probe_dots", "probe_observe", "rank_update_tile"}
