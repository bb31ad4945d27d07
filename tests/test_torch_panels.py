"""H8's plan (ops.frame_kernel ``obs_panels_plan``) and the gated frame's
route past MP 224.

csrc/obs_panels.cu makes the same plan in its C entry
(tests/test_torch_cuda.py holds the two equal on a card, and the kernel's
outputs to its plain version).  Here: the panels cover D in whole
clusters, a chunk is whole measurements and fits a block, the grid has at
least as many blocks as the first design's one 32-column panel a block at
every D, and ``obs_route`` takes the same route as it did with that
design's shared memory (rowc, a (NBP, 32) panel of vtf, partial sums and
siv: 4 (9 MP + 32 NBP + 256) bytes), over every NBP the factors give.
"""

import re

import pytest
import torch

from conan_slam_tpu_torch.ops import cuda, frame_kernel as fk
from conan_slam_tpu_torch.ops.factor_kernel import factor_shapes
from conan_slam_tpu_torch.ops.spd_inverse import sweep_fits

# (D, NZ, NBP): config 2, the 10k-landmark shape, route_checks' MP 240 and
# 480, MP 2048 at the factors' largest NBP (S = 256 with the heading) at
# D 1,024 and 20,224, and a D past the widest panels' reach.
SHAPES = [(1024, 64, 24), (20224, 64, 24), (1024, 120, 24), (1024, 240, 24), (1024, 1024, 776),
          (20224, 1024, 776), (4099, 64, 24), (8449, 112, 200), (203, 64, 22), (35, 16, 14)]
# Every NBP the factors give up to 256 sub-steps, with and without the
# heading update, and the largest at which the first design held MP 2048.
NBPS = sorted({factor_shapes(s, h)[1] for s in range(1, 257) for h in (True, False)} | {1232})


def _old_panels_fit(mp, nbp):
    return 4 * (9 * mp + 32 * nbp + 256) <= cuda.MAX_SMEM_BYTES


@pytest.mark.parametrize("d,nz,nbp", SHAPES)
def test_panels_cover_d_in_whole_clusters(d, nz, nbp):
    mp, rp = fk.frame_shapes(nz)
    plan = fk.obs_panels_plan(d, mp, rp, nbp)
    assert plan.width in (8, 16) and plan.cluster == 8 and plan.block == fk.OP_THREADS == 128
    assert (plan.panels - 1) * plan.width < d <= plan.panels * plan.width
    assert plan.grid % plan.cluster == 0 and plan.grid >= -(-d // 32)  # the first design's blocks
    # Block b walks panels b, b + grid, ...: k of them at most, no more
    # than 32 columns, and only the last cluster holds blocks past them.
    walks = -(-plan.panels // plan.grid)
    assert walks * plan.width <= fk.OP_WALK
    assert plan.grid - plan.cluster < -(-plan.panels // walks) <= plan.grid
    assert plan.rows == mp or (plan.width == 8 and plan.rows % 8 == 0 and plan.rows >= 8)
    assert plan.smem <= cuda.MAX_SMEM_BYTES
    assert plan.smem == 4 * fk._obs_panels_smem_floats(mp, rp, nbp, plan.width, plan.rows)
    # A chunk of 8 rows more would not fit.
    if plan.rows < mp:
        assert 4 * fk._obs_panels_smem_floats(mp, rp, nbp, 8, plan.rows + 8) > \
            cuda.MAX_SMEM_BYTES


def test_panels_fill_the_card_at_config_2():
    plan = fk.obs_panels_plan(1024, 128, 136, 24)
    assert (plan.width, plan.grid, plan.rows) == (8, 128, 128) and plan.grid >= 2 * 32


def test_panels_at_the_10k_shape():
    # 1,264 panels of 16 on 632 blocks (the first design's count), two a
    # block: six 128-thread blocks an SM by threads, seven by shared memory.
    plan = fk.obs_panels_plan(20224, 128, 136, 24)
    assert (plan.width, plan.panels, plan.grid, plan.rows) == (16, 1264, 632, 128)
    assert fk.OP_SM_SMEM // (plan.smem + 1024) == 7


@pytest.mark.parametrize("d", [1024, 2304, 6336, 6337, 8448, 20224])
def test_panels_widen_past_the_sms_threads(d):
    plan = fk.obs_panels_plan(d, 128, 136, 24)
    one_round = fk.OP_SM_THREADS // fk.OP_THREADS * fk.N_SM
    assert plan.width == (8 if -(-d // 8) <= one_round else 16)


def test_panels_take_no_shape_h8_cannot():
    assert fk.obs_panels_plan(1024, 2050, 2064, 24) is None      # past H1's largest S
    assert fk.obs_panels_plan(1024, 127, 136, 24) is None        # odd MP
    assert fk.obs_panels_plan(1024, 2048, 2056, 20000) is None   # no chunk fits


def test_plan_constants_match_the_kernel_source():
    src = (cuda.CSRC / "obs_panels.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"#define (OP_\w+) +(\d+)", src)}
    assert consts == {"OP_TX": fk.OP_TX, "OP_TY": fk.OP_TY, "OP_CLUSTER": fk.OP_CLUSTER,
                      "OP_MAX_MP": fk.OP_MAX_MP, "OP_SM_THREADS": fk.OP_SM_THREADS,
                      "OP_SM_SMEM": fk.OP_SM_SMEM, "OP_WALK": fk.OP_WALK, "OP_PLAN": fk.OP_PLAN,
                      "OP_NSTAMP": 10, "OP_STAMP_BLOCKS": 4096}
    assert "#define OP_THREADS (OP_TX * OP_TY)" in src
    assert fk.OP_THREADS == fk.OP_TX * fk.OP_TY


@pytest.mark.parametrize("d", [128, 1003, 1024, 2304, 20224])
def test_obs_route_is_unchanged(d):
    # The route as the first H8 design's shared memory decided it.
    for nbp in NBPS:
        for nz in range(1, 1101, 9):
            mp, rp = fk.frame_shapes(nz)
            past = "unported" if fk._ref_frame_update_has_kernel(d, nz, nbp) else "plain"
            split = ("split" if sweep_fits(mp) and _old_panels_fit(mp, nbp)
                     and fk._obs_smem_bytes(mp, rp, nbp) <= cuda.MAX_SMEM_BYTES else past)
            resident = (mp <= fk.MAX_MP and rp <= fk.OS_MAX_RP and fk._obs_step_smem_bytes(
                mp, rp, nbp) + fk.OS_STATIC_BYTES <= cuda.MAX_SMEM_BYTES)
            assert fk.obs_route(d, nz, nbp, "cpu") == ("resident" if resident else split), \
                (d, nz, nbp)
            assert fk.obs_route(d, nz, nbp, "cpu", "split") == split, (d, nz, nbp)


@pytest.mark.parametrize("d,nz,nbp", [(64, 16, 24), (203, 40, 22), (128, 120, 56)])
def test_obs_panels_on_the_cpu_is_its_plain_version(d, nz, nbp):
    from conan_slam_tpu_torch.benchmarks.redesign_turns import h8_inputs

    args = h8_inputs(d, nz, nbp, torch.device("cpu"))
    for got, want in zip(fk.obs_panels(*args), fk._obs_panels_reference(*args)):
        assert torch.equal(got, want)
