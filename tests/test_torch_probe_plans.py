"""The geometry of H11 (sweep_probe) and H13 (probe_dots) on the CPU: the
plans in ops/probes.py against the constants of their CUDA sources, and the
work each plan hands out, replayed in Python the way the kernels index it.

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
