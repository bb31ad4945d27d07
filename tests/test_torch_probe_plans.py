"""The geometry of H11 (sweep_probe), H13 (probe_dots) and H14
(probe_observe) on the CPU: the plans in ops/probes.py against the
constants of their CUDA sources, and the work each plan hands out, replayed
in Python the way the kernels index it.

The kernels themselves run only on a card (tests/test_torch_cuda.py holds
them to their plain versions and to these plans' C mirrors).
"""

import re
from pathlib import Path

import numpy as np
import pytest

from conan_slam_tpu_torch.ops import cuda, probes

CSRC = Path(probes.__file__).resolve().parent.parent / "csrc"


def _defines(name: str) -> dict:
    """The integer #defines of a source (the first of each name)."""
    out = {}
    for m in re.finditer(r"^#define (\w+) (\d+)\b", (CSRC / name).read_text(), re.M):
        out.setdefault(m.group(1), int(m.group(2)))
    return out


def test_probe_dots_constants_are_the_sources():
    got = _defines("probe_mosaic.cu")
    assert (got["PD_W"], got["PD_G"], got["PD_THREADS"], got["PD_MAX_MP"], got["PD_PLAN"]) == (
        probes.PD_W, probes.PD_G, probes.PD_THREADS, probes.PROBE_DOTS_MAX_MP, probes.PD_PLAN)


def test_sweep_probe_constants_are_the_sources():
    got = _defines("sweep_probe.cu")
    assert (got["SP_RING"], got["SP_WARPS"], got["SP_WIDE4_CLUSTER"], got["SP_PLAN"]) == (
        probes.SWEEP_PROBE_RING, probes.SWEEP_PROBE_WARPS, probes.SWEEP_PROBE_WIDE4_CLUSTER,
        probes.SP_PLAN)


@pytest.mark.parametrize("d", [512, 500, 4096])
@pytest.mark.parametrize("mp", [128, 126, 2])
def test_probe_dots_plan_covers_every_column_and_row(d, mp):
    # Replay the kernel's indexing: CTA b is rank b % cluster of panel
    # b / cluster; thread t forms rows m0 + 2 (t / 8) + {0, 1} of columns
    # n0 + 2 (t % 8) + {0, 1}, for rows inside MP and columns inside D.
    plan = probes.probe_dots_plan(d, mp, 136)
    assert plan.grid == plan.panels * plan.cluster and plan.grid % plan.cluster == 0
    assert (plan.panels - 1) * plan.width < d <= plan.panels * plan.width
    assert plan.rows == 2 * -(-(-(-mp // plan.cluster)) // 2) and plan.rows <= 32
    assert plan.block == (plan.width // 2) * 16          # 16 row pairs: rows <= 32
    assert plan.smem <= cuda.MAX_SMEM_BYTES
    count = np.zeros((mp, d), np.int64)
    for b in range(plan.grid):
        panel, rank = divmod(b, plan.cluster)
        m0, n0 = rank * plan.rows, panel * plan.width
        for t in range(plan.block):
            npair, mq = t % (plan.width // 2), t // (plan.width // 2)
            if 2 * mq >= plan.rows:
                continue
            for i in range(2):
                for j in range(2):
                    m, n = m0 + 2 * mq + i, n0 + 2 * npair + j
                    if m < mp and n < d:
                        count[m, n] += 1
    assert (count == 1).all()


def test_probe_dots_plan_fills_the_card_at_the_probe_shape():
    plan = probes.probe_dots_plan(512, 128, 136)
    assert plan.grid >= 128 and plan.cluster in (2, 4, 8)
    assert probes.probe_dots_plan(512, 129, 136) is None
    assert probes.probe_dots_plan(512, 128, 10_000) is None     # a CTA's operands past 227 KB


@pytest.mark.parametrize("variant", probes.SWEEP_VARIANTS)
def test_sweep_probe_plan_covers_every_even_mp(variant):
    for mp in range(2, 129, 2):
        plan = probes.sweep_probe_plan(mp, variant)
        w = 32 * plan.q
        assert (plan.q == 2) == (mp <= 64)
        assert plan.cta_rows * plan.cluster == w >= mp
        assert plan.rows * (plan.block // 32) == plan.cta_rows          # whole rows a warp
        assert plan.rows % (4 if variant == "wide4" else 2) == 0          # whole steps a warp
        assert plan.block <= 1024 and plan.smem <= 48 * 1024           # static shared memory
        if variant != "wide4":     # a run holds its P stages and the one before
            assert plan.ring >= plan.rows // 2 + 2


def test_sweep_probe_plan_is_the_measured_choice():
    # unroll2 / unroll4 one block; wide4 a cluster of 8 past MP 64 and one
    # block at MP <= 64 (the times are in PERF.md).
    for variant in ("unroll2", "unroll4"):
        assert probes.sweep_probe_plan(128, variant).cluster == 1
        assert probes.sweep_probe_plan(128, variant).block == 512
    assert probes.sweep_probe_plan(128, "wide4").cluster == 8
    assert probes.sweep_probe_plan(64, "wide4").cluster == 1
    with pytest.raises(ValueError):
        probes.sweep_probe_plan(130, "unroll2")
    with pytest.raises(ValueError):
        probes.sweep_probe_plan(64, "wide8")


def _classic_schedule(nb: int, w: int, rows: int):
    """The order in which sweep_unroll_kernel's warps apply the pivots to
    their rows, as (row, pivot, own) events a row, and for each pivot the
    pivots its two rows had taken when it was formed: the consumer steps,
    then the warp's run (each row pair takes the previous warp's last pivot
    and the run's earlier pivots, then forms its own), then the run's
    deferred updates, then the consumer steps after it."""
    taken = {r: [] for r in range(w)}
    formed = {}
    p = rows // 2
    for row0 in range(0, w, rows):
        base = row0 // 2

        def consume(k0, k1):
            for k in range(k0, k1):
                for r in range(row0, row0 + rows):
                    taken[r].append((k, False))
        if base >= nb:
            consume(0, nb)
            continue
        end = min(base + p, nb)
        consume(0, max(base - 1, 0))
        for j in range(p):
            pair = (row0 + 2 * j, row0 + 2 * j + 1)
            for k in ([base - 1] if base > 0 else []) + [base + i for i in range(j) if base + i < end]:
                for r in pair:
                    taken[r].append((k, False))
            if base + j < end:
                formed[base + j] = [list(taken[r]) for r in pair]
        for j in range(p):
            for i in range(j, p):
                if base + i < end:
                    for r in (row0 + 2 * j, row0 + 2 * j + 1):
                        taken[r].append((base + i, i == j))
        consume(end, nb)
    return taken, formed


@pytest.mark.parametrize("mp,nb", [(128, 40), (128, 39), (128, 64), (64, 20), (2, 1), (30, 15)])
def test_classic_run_schedule_is_h1s_order(mp, nb):
    # Every row takes pivots 0 .. nb - 1 once each, in order, the diagonal
    # at its own pivot; a pivot is formed from rows that took every pivot
    # before it: H1's order, so H1's bits.
    for variant in ("unroll2", "unroll4"):
        plan = probes.sweep_probe_plan(mp, variant)
        w = 32 * plan.q
        taken, formed = _classic_schedule(nb, w, plan.rows)
        for r in range(w):
            assert [k for k, _ in taken[r]] == list(range(nb))
            assert [k for k, own in taken[r] if own] == ([r // 2] if r // 2 < nb else [])
        assert sorted(formed) == list(range(nb))
        for k, rows in formed.items():
            for before in rows:
                assert [i for i, _ in before] == list(range(k))


def test_probe_observe_constants_are_the_sources():
    got = _defines("probe_mosaic.cu")
    assert (got["PO_ROWS"], got["PO_THREADS"], got["PO_PLAN"]) == (
        probes.PO_ROWS, probes.PO_THREADS, probes.PO_PLAN)


def _parent_smem_floats(mp: int, rp: int) -> int:
    """The parent's one-block shared memory (floats), from the source's own
    observe_smem_floats (C integer division: the operands are positive)."""
    src = (CSRC / "probe_mosaic.cu").read_text()
    expr = re.search(r"int observe_smem_floats\(int mp, int rp\) \{\s*return (.*?);", src,
                     re.S).group(1)
    return eval(expr.replace("/", "//"), {"mp": mp, "rp": rp})     # noqa: S307


def test_probe_observe_plan_refuses_exactly_the_parents_shapes():
    for mp, rp in [(3, 136), (127, 136), (0, 136), (-2, 136), (128, 2), (128, 0), (1, 5)]:
        assert probes.probe_observe_plan(mp, rp) is None
    for rp in (3, 5, 100, 136, 1027, 5000):
        took = [mp for mp in range(2, 1600, 2) if 4 * _parent_smem_floats(mp, rp) <= 48 * 1024]
        for mp in range(2, 1600, 2):
            assert (probes.probe_observe_plan(mp, rp) is not None) == (mp in took), (mp, rp)
    top = max(mp for mp in range(2, 1600, 2) if 4 * _parent_smem_floats(mp, 136) <= 48 * 1024)
    assert top >= 512 and probes.probe_observe_plan(top + 2, 136) is None


@pytest.mark.parametrize("mp", [2, 126, 128, 512])
def test_probe_observe_plan_covers_every_row_once(mp):
    # Replay the kernel's ownership: CTA b holds rows b rows .. (those
    # inside MP), whole measurements; warp w writes R rows nw - 1 - w, ...
    # and Hc rows w, ... of them; the last threads write v.
    plan = probes.probe_observe_plan(mp, 136)
    assert plan.rows % 2 == 0 and plan.block % 32 == 0
    assert (plan.grid - 1) * plan.rows < mp <= plan.grid * plan.rows
    nw = plan.block // 32
    count = {k: np.zeros(mp, np.int64) for k in ("hc", "r", "v")}
    for b in range(plan.grid):
        i0 = b * plan.rows
        rows = min(plan.rows, mp - i0)
        assert rows > 0 and rows % 2 == 0
        for w in range(nw):
            for r in range(nw - 1 - w, rows, nw):
                count["r"][i0 + r] += 1
            for r in range(w, rows, nw):
                count["hc"][i0 + r] += 1
        for t in range(plan.block):
            if t - (plan.block - rows) >= 0:
                count["v"][i0 + t - (plan.block - rows)] += 1
    assert all((c == 1).all() for c in count.values())
    if mp >= 64:
        assert plan.grid >= 32          # the rows spread over the card


@pytest.mark.parametrize("n", [1, 3, 5, 128, 136, 1027])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_probe_observe_row_writes_cover_every_column_once(n, offset):
    # write_row on a row that starts `offset` floats past a 16-byte line:
    # scalars to the first aligned column, 16-byte stores, then the tail.
    head = min((16 - 4 * offset) % 16 // 4, n)
    n4 = (n - head) >> 2
    count = np.zeros(n, np.int64)
    for lane in range(32):
        if lane < head:
            count[lane] += 1
        for q in range(lane, n4, 32):
            assert (offset + head + 4 * q) % 4 == 0          # a 16-byte store is aligned
            count[head + 4 * q: head + 4 * q + 4] += 1
        t = head + 4 * n4 + lane
        if lane < 4 and t < n:
            count[t] += 1
    assert (count == 1).all()


def _observe_operands(xr, zs, mp: int, rp: int) -> list:
    """What csl_obs_observe and csl_chain_observe read for each measurement
    l of (xr, zs) at (mp, rp): its feature (zero past RP), the pose, its
    range, bearing and mask, and the two masks cx < rp, cy < rp."""
    nzl = mp // 2
    ops = []
    for l in range(nzl):
        cx, cy = 3 + 2 * l, 4 + 2 * l
        ops.append((xr[cx] if cx < rp else 0.0, xr[cy] if cy < rp else 0.0, xr[0], xr[1], xr[2],
                    zs[l], zs[nzl + l], zs[2 * nzl + l], cx < rp, cy < rp))
    return ops


@pytest.mark.parametrize("mp,rp", [(128, 136), (126, 100), (2, 5), (512, 1027), (10, 3), (12, 8)])
def test_probe_observe_cta_sees_the_probes_operands(mp, rp):
    # Replay a CTA's staging: its gathered mean and zin, read by the frozen
    # observe functions at (rows, RP - 2 l0), give each of its measurements
    # exactly the operands the whole probe's do, and R's mask of each row.
    plan = probes.probe_observe_plan(mp, rp)
    rng = np.random.default_rng(mp + rp)
    xrows = rng.normal(size=rp).astype(np.float32)
    zin = rng.normal(size=(3, mp // 2)).astype(np.float32)
    whole = _observe_operands(xrows, zin.reshape(-1), mp, rp)
    nb, nx = plan.rows, 3 + plan.rows
    for b in range(plan.grid):
        i0 = b * nb
        l0, rows = i0 // 2, min(nb, mp - i0)
        nl = rows // 2
        xr = np.zeros(nx, np.float32)
        for t in range(nx):
            c = t if t < 3 else 3 + 2 * l0 + (t - 3)
            xr[t] = xrows[c] if t < 3 or (t - 3 < rows and c < rp) else 0.0
        zs = np.zeros(3 * nl, np.float32)
        for t in range(nx, nx + 3 * (nb // 2)):
            q, l = divmod(t - nx, nb // 2)
            if l < nl:
                zs[q * nl + l] = zin[q, l0 + l]
        assert _observe_operands(xr, zs, rows, rp - 2 * l0) == whole[l0:l0 + nl]
        for r in range(rows):
            assert zs[2 * nl + (r >> 1)] == zin[2, (i0 + r) // 2]
