"""Port parity of the probe kernels' plain versions (ops.probes) and the
port-side benches (conan_slam_tpu_torch.benchmarks) against the reference's
probes.

The reference probes' kernel bodies are nested inside their scripts'
functions (benchmarks/probe_sweep.py, probe_mosaic.py); they are taken out
with ``ast``, read only, and run here in one-block ``pallas_call``s in
interpret mode, as the JAX package's own tests run its kernels on the CPU.
tests/test_torch_cuda.py holds the CUDA kernels to the same plain versions
on a card.
"""

import ast
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from conan_slam_tpu.ops.frame_kernel import _observe_core
from conan_slam_tpu.ops.pallas_update import rank_update_t as j_rank_update_t
from conan_slam_tpu.ops.spd_inverse import sweep_ref_inverse
from conan_slam_tpu_torch.benchmarks import bench_framestep, probe_mosaic, probe_rankpass
from conan_slam_tpu_torch.benchmarks import probe_sweep
from conan_slam_tpu_torch.ops import probes
from conan_slam_tpu_torch.ops.frame_kernel import _dense_hc, _observe_reference
from conan_slam_tpu_torch.ops.rank_update import rank_update_vbt
from conan_slam_tpu_torch.utils.profiling import scan_graph

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VSPEC = pl.BlockSpec(memory_space=pltpu.VMEM)


def _nested(script: str, outer: str, names: tuple[str, ...], namespace: dict) -> dict:
    """The functions ``names`` defined inside ``outer`` of the reference's
    ``benchmarks/<script>``, defined in ``namespace``."""
    path = os.path.join(REPO, "benchmarks", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    body = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == outer).body
    found = [n for n in body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert sorted(n.name for n in found) == sorted(names)
    ns = dict(namespace)
    exec(compile(ast.Module(body=found, type_ignores=[]), path, "exec"), ns)
    return {n: ns[n] for n in names}


def _probe_sweeps() -> dict:
    return _nested("probe_sweep.py", "main", ("unrolled_sweep", "paired_sweep"),
                   {"jax": jax, "jnp": jnp, "pl": pl})


def _reference_sweep(s: np.ndarray, nblk: int, variant: str) -> np.ndarray:
    """The reference probe's kernel ``variant`` in one interpret-mode
    pallas_call, as its ``make`` builds it."""
    fns = _probe_sweeps()

    def kernel(s_ref, o_ref):
        o_ref[:, :] = s_ref[:, :]
        if variant == "v0":
            sweep_ref_inverse(o_ref, nblk=nblk)
        elif variant == "wide4":
            fns["paired_sweep"](o_ref, nblk)
        else:
            fns["unrolled_sweep"](o_ref, nblk, int(variant[-1]))

    mp = s.shape[0]
    return np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((mp, mp), jnp.float32),
        in_specs=[VSPEC], out_specs=VSPEC, interpret=True,
    )(jnp.asarray(s)))


@pytest.mark.parametrize("variant", probes.SWEEP_VARIANTS)
@pytest.mark.parametrize("mp,nblk", [(64, 20), (128, 20), (128, 40)])
def test_sweep_probe_matches_reference_probe(mp, nblk, variant):
    s = probe_sweep.probe_matrix(mp)
    ref = _reference_sweep(s, nblk, variant)
    got = probes.sweep_probe(torch.as_tensor(s), nblk, variant).numpy()
    # The same algebra in the same order: float32 rounding only.
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # The probe's own gate: the swept block against numpy's inverse.
    inv = np.linalg.inv(s[: 2 * nblk, : 2 * nblk])
    assert np.abs(got[: 2 * nblk, : 2 * nblk] - inv).max() < 1e-4


@pytest.mark.parametrize("mp,nblk", [(64, 20), (128, 40)])
def test_sweep_v0_matches_reference_probe(mp, nblk):
    # v0 is H1 (sweep_si), which also symmetrizes and scales; the probe's S
    # has a unit diagonal, so the swept block is the probe's v0.
    from conan_slam_tpu_torch.ops.spd_inverse import sweep_si

    s = probe_sweep.probe_matrix(mp)
    ref = _reference_sweep(s, nblk, "v0")
    got = sweep_si(torch.as_tensor(s), torch.tensor([nblk], dtype=torch.int32)).numpy()
    k = 2 * nblk
    np.testing.assert_allclose(got[:k, :k], ref[:k, :k], rtol=0, atol=1e-5)
    assert np.abs(got[:k, :k] - np.linalg.inv(s[:k, :k])).max() < 1e-4


@pytest.mark.parametrize("variant", probes.SWEEP_VARIANTS)
def test_sweep_probe_sweeps_every_pivot_at_odd_nblk(variant):
    # ROADMAP R6: at NBLK 39 the reference probe's unrolled and paired
    # sweeps leave their last pivots unswept (loop bounds nblk // unroll,
    # nblk // 2, and a `pass` for the ragged tail); the port sweeps all 39.
    mp, nblk = 128, 39
    s = probe_sweep.probe_matrix(mp)
    inv = np.linalg.inv(s[: 2 * nblk, : 2 * nblk])
    got = probes.sweep_probe(torch.as_tensor(s), nblk, variant).numpy()
    assert np.abs(got[: 2 * nblk, : 2 * nblk] - inv).max() < 1e-4
    ref = _reference_sweep(s, nblk, variant)
    assert np.abs(ref[: 2 * nblk, : 2 * nblk] - inv).max() > 1e-1


def _rank_inputs(d, r, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(d, d)).astype(np.float32)
    p = p @ p.T
    vt = rng.normal(size=(r, d)).astype(np.float32)
    b = rng.normal(size=(r, r)).astype(np.float32)
    return p, vt, 0.5 * (b + b.T)


def _j_rank(p, vt, b):
    return np.asarray(j_rank_update_t(jnp.asarray(p), jnp.asarray(vt), jnp.asarray(b),
                                      interpret=True))


@pytest.mark.parametrize("d,r", [(256, 24), (384, 72)])
def test_rank_update_tile_matches_reference_kernel(d, r):
    p, vt, b = _rank_inputs(d, r, d + r)
    ref = _j_rank(p, vt, b)
    tp, tvt, tb = (torch.as_tensor(a) for a in (p, vt, b))
    vbt = tb @ tvt
    # |P| ~ d: float32 sums of ~r + d terms, the reference test's bound.
    for tile in probes.RANK_TILES:
        got = probes.rank_update_tile(tp, tvt, vbt, tile).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)
    # mmonly: the product alone, with no P, against the reference's pass on
    # a zero P.
    prod = _j_rank(np.zeros_like(p), vt, b)
    got = probes.rank_update_tile(None, tvt, vbt, 64).numpy()
    np.testing.assert_allclose(got, prod, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("d,r", [(256, 24), (384, 72)])
def test_stacked_rank_pass_matches_sequential_reference(d, r, k):
    # stack4 / stack3: one pass at rank k r against k passes at rank r.
    p, vt, b = _rank_inputs(d, r, 7 * k + d)
    ref = p
    for _ in range(k):
        ref = _j_rank(ref, vt, b)
    tvt = torch.as_tensor(vt)
    vbt = torch.as_tensor(b) @ tvt
    got = rank_update_vbt(torch.as_tensor(p), torch.cat([tvt] * k), torch.cat([vbt] * k))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=3e-2)


def test_stream_copy_is_bit_equal():
    p = torch.as_tensor(np.random.default_rng(3).normal(size=(384, 384)).astype(np.float32))
    out = probes.stream_copy(p)
    assert out.data_ptr() != p.data_ptr()
    assert torch.equal(out, p)


def test_probe_observe_matches_reference_observe_core():
    # probe_observe's exact inputs (zin padded to the probe's 8 rows) through
    # the reference's _observe_core in one interpret-mode pallas_call.
    (xrows, zin, rsc, mp, rp), numpy_refs = probe_mosaic.observe_inputs()
    zin8 = np.zeros((8, mp // 2), np.float32)
    zin8[:3] = zin

    def kernel(xr_ref, zin_ref, rsc_ref, hc_o, rm_o, v_o):
        hc, rmat, v2 = _observe_core(xr_ref[:, :], zin_ref[:, :], rsc_ref, mp, rp)
        hc_o[:, :] = hc
        rm_o[:, :] = rmat
        v_o[:, :] = v2

    ref = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((mp, rp), jnp.float32),
                   jax.ShapeDtypeStruct((mp, mp), jnp.float32),
                   jax.ShapeDtypeStruct((1, mp), jnp.float32)),
        in_specs=[VSPEC, VSPEC, pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=(VSPEC, VSPEC, VSPEC), interpret=True,
    )(jnp.asarray(xrows[None]), jnp.asarray(zin8), jnp.asarray(rsc))
    ref = [np.asarray(a).reshape(g.shape) for a, g in zip(ref, numpy_refs)]
    args = [torch.as_tensor(a) for a in (xrows, zin, rsc)]
    hcc, rmat, v = _observe_reference(*args, mp, rp)
    plain = probes.probe_observe_reference(*args, mp, rp)
    for path in probes.OBSERVE_PATHS:
        got = probes.probe_observe(*args, mp, rp, path)
        for g, p in zip(got, plain):
            assert torch.equal(g, p)
    for (name, tol), g, r, n in zip(probe_mosaic.OBSERVE_TOL,
                                    (_dense_hc(hcc, rp), rmat, v), ref, numpy_refs):
        assert np.abs(g.numpy() - r).max() < tol, name
        assert np.abs(g.numpy() - n).max() < tol, name


def test_probe_dots_matches_reference_probe():
    fns = _nested("probe_mosaic.py", "probe_dots", ("kernel",),
                  {"jax": jax, "jnp": jnp, "hi": jax.lax.Precision.HIGHEST})
    prows, hc, si, siv = probe_mosaic.dots_inputs()
    d, mp = prows.shape[1], hc.shape[0]
    ref = pl.pallas_call(
        fns["kernel"],
        out_shape=(jax.ShapeDtypeStruct((d, mp), jnp.float32),
                   jax.ShapeDtypeStruct((mp, d), jnp.float32),
                   jax.ShapeDtypeStruct((1, d), jnp.float32)),
        in_specs=[VSPEC] * 4, out_specs=(VSPEC, VSPEC, VSPEC), interpret=True,
    )(*(jnp.asarray(a) for a in (prows, hc, si, siv)))
    got = probes.probe_dots(*(torch.as_tensor(a) for a in (prows, hc, si, siv)))
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() / np.abs(r).max() < 1e-4


def test_scan_graph_on_cpu_is_the_python_loop():
    rng = np.random.default_rng(11)
    a0 = torch.as_tensor(rng.normal(size=(6, 6)).astype(np.float32))
    b0 = torch.as_tensor(rng.normal(size=(6,)).astype(np.float32))

    def step(c):
        a, b = c
        return 0.5 * a + torch.outer(b, b) * 1e-3, torch.tanh(a @ b)

    res = scan_graph(step, (a0, b0), 10, 3)
    assert (res.frames, res.replays, res.launches) == (9, 3, {})
    c = (a0, b0)
    for _ in range(9):
        c = step(c)
    for got, want in zip(res.carry, c):
        assert torch.equal(got, want)
    for got, want in zip(res.eager_carry, c):
        assert torch.equal(got, want)


TINY = {"PS_MP": "32", "PS_NBLK": "8", "PS_FRAMES": "3", "RP_D": "256", "RP_RANK": "16",
        "RP_FRAMES": "3", "FS_LANDMARKS": "32", "FS_STEPS": "12"}


@pytest.mark.parametrize("module,argv,lines", [
    (probe_sweep, None, [f"{v:8s}:" for v in probe_sweep.VARIANTS]),
    (probe_rankpass, list(probe_rankpass.ALL), [f"{v:8s}:" for v in probe_rankpass.ALL]),
    (probe_mosaic, ["all"], ["dots    :", "observe/known:", "observe/gated:"]),
    (bench_framestep, list(bench_framestep.SCAN_MODES + bench_framestep.DRIVER_MODES),
     [f"{m:14s}:" for m in bench_framestep.SCAN_MODES + bench_framestep.DRIVER_MODES]),
])
def test_bench_runs_on_cpu_at_a_tiny_size(module, argv, lines, monkeypatch, capsys):
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(probe_mosaic, "FRAMES", 3)
    res = module.main(argv, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    unit = {probe_sweep: "us/sweep", probe_rankpass: "us/pass", probe_mosaic: "us/call",
            bench_framestep: "us/frame"}[module]
    for prefix in lines:
        line = next(ln for ln in out if ln.startswith(prefix))
        assert unit in line and np.isfinite(float(line.split(":")[1].split()[0]))
    assert res


def _keep_p(p, *args, **kw):
    return p.clone()


@pytest.mark.parametrize("variant,name,broken", [
    ("v0", "rank_update_t", _keep_p),
    ("tr128", "rank_update_tile", _keep_p),
    ("arb", "rank_update_tile", _keep_p),
    ("accum", "rank_update_vbt", _keep_p),
    ("stack3", "rank_update_vbt", lambda p, g, mg: p + 1e-9),
    ("mmonly", "rank_update_tile", lambda p, g, mg, tile: torch.zeros(g.shape[1], g.shape[1])),
    ("copy", "stream_copy", lambda p: p + 1e-30),
])
def test_rankpass_gate_fails_a_kernel_that_drops_the_update(variant, name, broken, monkeypatch):
    # The probe's update (~1e-12) rounds away on P = I's diagonal, so the
    # gate must hold the update itself: a kernel that leaves P as it was,
    # or returns no product, fails it.
    for k, v in TINY.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(probe_rankpass, name, broken)
    with pytest.raises(AssertionError, match="off its plain version"):
        probe_rankpass.main([variant], device="cpu")


def test_require_replay_holds_the_graph_carry_to_the_eager_one():
    from conan_slam_tpu_torch.benchmarks import require_replay
    from conan_slam_tpu_torch.utils.profiling import Scan

    a = torch.arange(6, dtype=torch.float32)
    same = Scan((a,), (a.clone(),), 1.0, 2.0, 4, 2, {})
    require_replay("same", same)
    off = Scan((a,), (a + torch.tensor([0, 0, 0, 0, 0, 2.0 ** -20]),), 1.0, 2.0, 4, 2, {})
    with pytest.raises(AssertionError, match="off the eager loop's by 9.537e-07"):
        require_replay("off", off)


def test_probe_modules_import_no_jax():
    code = textwrap.dedent("""
        import sys
        import conan_slam_tpu_torch.ops.probes
        import conan_slam_tpu_torch.utils.profiling
        from conan_slam_tpu_torch.benchmarks import (
            bench_framestep, probe_mosaic, probe_rankpass, probe_sweep)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "conan_slam_tpu"))
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
