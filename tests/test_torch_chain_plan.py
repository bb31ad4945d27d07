"""The plans the wrappers hand H2 and H3 (ops.frame_kernel
``frame_chain_plan``, ``frame_panels_plan``): every measurement row, every
column of D and every siv entry is covered by exactly one block.

The kernels (csrc/frame_chain.cu, csrc/frame_panels.cu) map a block to its
rows, columns and siv entries as the plans' ``rows``, ``columns`` and
``siv_entries`` do; tests/test_torch_cuda.py holds their outputs to the
plain versions on a card.
"""

import re

import pytest

from conan_slam_tpu_torch.ops import cuda, frame_kernel as fk

MPS = range(32, 225, 32)      # NZ 16-112, every MP the frame takes


def _rp(mp):
    return fk.frame_shapes(mp // 2)[1]


@pytest.mark.parametrize("mp", MPS)
def test_chain_plan_covers_every_row_once(mp):
    plan = fk.frame_chain_plan(mp)
    assert plan.band % 2 == 0 and 0 < plan.grid <= fk.N_SM
    bands = [plan.rows(b) for b in range(plan.grid)]
    # Each band is whole measurements (starts on an even row), none empty.
    assert all(len(r) > 0 and r.start % 2 == 0 for r in bands)
    assert [i for r in bands for i in r] == list(range(mp))
    assert fk._chain_smem_bytes(mp, _rp(mp), plan.band) <= cuda.MAX_SMEM_BYTES


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("d", [2304, 2051, 1024, 35])
def test_panel_plan_covers_every_column_and_siv_entry_once(d, mp):
    plan = fk.frame_panels_plan(mp, d)
    assert plan.grid % plan.cluster == 0 and 0 <= plan.grid - plan.panels < plan.cluster
    assert [n for b in range(plan.grid) for n in plan.columns(b)] == list(range(d))
    # Blocks past the last panel hold no column (they form siv entries only).
    assert all(len(plan.columns(b)) > 0 for b in range(plan.panels))
    assert not any(len(plan.columns(b)) for b in range(plan.panels, plan.grid))
    assert [j for r in range(plan.cluster) for j in plan.siv_entries(r)] == list(range(mp))
    assert fk._panels_smem_bytes(mp, _rp(mp)) <= cuda.MAX_SMEM_BYTES
    if d == 2304:
        assert plan.panels >= fk.N_SM      # the bench shape fills the card


def test_plans_match_the_kernel_sources():
    src = (cuda.CSRC / "frame_panels.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (PANEL_\w+) +(\d+)", src)}
    assert consts["PANEL_W"] == fk.PANEL_W
    assert consts["PANEL_CLUSTER"] == fk.PANEL_CLUSTER
    assert consts["PANEL_W"] * consts["PANEL_H"] == fk.PANEL_THREADS
    assert consts["PANEL_LD"] == fk.PANEL_LD
