"""The P pass's route and the streamed pass's geometry on the CPU: the rule
that picks H4's 32-tiles or the streamed 128-tiles (csrc/resident.cuh
pass_route), the persistent blocks' walk over the tile list, the shared
memory, all against the source's constants, and ``frame_pass``'s plain
version.

The kernels run only on a card (tests/test_torch_cuda.py holds the
streamed pass bit for bit to the 32-tiles and checks these plans' C
mirrors).
"""

import re
from pathlib import Path

import pytest
import torch

from conan_slam_tpu_torch.ops import cuda, frame_kernel as fk

CSRC = Path(fk.__file__).resolve().parent.parent / "csrc"


def _defines(name: str) -> dict:
    """The integer #defines of a source (the first of each name)."""
    out = {}
    for m in re.finditer(r"^#define (\w+) +(\d+)\b", (CSRC / name).read_text(), re.M):
        out.setdefault(m.group(1), int(m.group(2)))
    return out


def test_pass_constants_are_the_sources():
    got = _defines("resident.cuh")
    assert (got["PASS_SMALL"], got["PASS_BIG"], got["PASS_TILES_AN_SM"], got["SP_THREADS"],
            got["SP_BK"], got["SP_STAGES"], got["SP_SLOTS"]) == (
        fk.PASS_SMALL, fk.PASS_BIG, fk.PASS_TILES_AN_SM, fk.SP_THREADS, fk.SP_BK, fk.SP_STAGES,
        fk.SP_SLOTS)
    assert _defines("frame_step.cu")["FP_PLAN"] == fk.FP_PLAN
    src = (CSRC / "resident.cuh").read_text()
    # The rule as the source writes it, and the routes' numbers.
    assert "n * (n + 1) / 2 >= (long long)PASS_TILES_AN_SM * sms ? PASS_128 : PASS_32" in src
    assert "constexpr int PASS_32 = PASS_SMALL, PASS_128 = PASS_BIG;" in src
    assert fk.PASS_ROUTES == {"auto": 0, "tile32": fk.PASS_SMALL, "tile128": fk.PASS_BIG}
    # pass_vec's three conditions, as fk.pass_vec mirrors them.
    assert ("return d % 4 == 0 && !(reinterpret_cast<size_t>(p) & 15u) && "
            "!(reinterpret_cast<size_t>(out) & 15u);") in src
    # Eight consumer warps of 8 x 8 outputs cover a tile, beside the strips'
    # warp, P's and out's.
    assert 8 * 32 * 64 == fk.PASS_BIG ** 2 and fk.SP_THREADS == 8 * 32 + 3 * 32


@pytest.mark.parametrize("d,tile", [(1024, 32), (2304, 32), (10_240, 128), (20_224, 128)])
def test_pass_route_by_d_on_132_sms(d, tile):
    # The known bench's D 2304 and config 2's D 1024 keep the 32-tiles (18
    # and 8 tiles of 128 a side: 171 and 36 tiles on 132 SMs); the long
    # loop's D 10,240 and the 10k-landmark D 20,224 take the streamed
    # pass (3,240 and 12,561 tiles).
    assert fk.pass_tile(d, 132) == tile
    n = -(-d // 128)
    assert (n * (n + 1) // 2 >= 8 * 132) == (tile == 128)


def test_pass_route_threshold_and_rows():
    # From 46 tiles of 128 a side (1,081 >= 1,056) on 132 SMs; P rows that
    # take no 16-byte copies (D % 4 != 0, or P misaligned) stay on the
    # 32-tiles at every D.
    assert fk.pass_tile(45 * 128, 132) == 32 and fk.pass_tile(45 * 128 + 4, 132) == 128
    assert fk.pass_tile(20_223, 132, vec=False) == 32
    assert fk.pass_tile(20_224, 132, vec=False) == 32
    # Fewer SMs move the threshold down.
    assert fk.pass_tile(2304, 16) == 128 and fk.pass_tile(2304, 22) == 32


def _body(src: str, head: str) -> str:
    """The braced body that follows ``head`` in ``src``, comments dropped
    and whitespace collapsed."""
    start = src.index(head)
    i, depth = src.index("{", start), 0
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            break
    text = re.sub(r"//[^\n]*", "", src[start:j + 1])
    return " ".join(text.split())


def test_stream_pass_walk_is_the_sources():
    # fk.pass_walk and fk._tile_ij are these two sources line for line, so
    # the walk test below holds the kernel's own walk.
    walk = _body((CSRC / "resident.cuh").read_text(), "struct Walk {")
    assert walk == (
        "struct Walk { int tile, ti, tj; __device__ __forceinline__ Walk(int nt, int ntiles) : "
        "tile(blockIdx.x), ti(0), tj(0) { if (tile < ntiles) csl_rank::tile_ij(tile, nt, &ti, "
        "&tj); } __device__ __forceinline__ void next(int nt) { tile += gridDim.x; tj += "
        "gridDim.x; while (ti < nt && tj >= nt) { tj -= nt; ++ti; tj += ti; } } }")
    ij = _body((CSRC / "rank_tile.cuh").read_text(), "void tile_ij(")
    assert ij == (
        "void tile_ij(int tile, int nt, int* ti, int* tj) { int i = 0, rem = tile; while (rem >= "
        "nt - i) { rem -= nt - i; ++i; } *ti = i; *tj = i + rem; }")
    # Every consumer of the walk steps it the same way.
    src = (CSRC / "resident.cuh").read_text()
    assert src.count("w.tile < ntiles; w.next(nt)") == 4


@pytest.mark.parametrize("d,p_off,out_off,vec", [
    (20_224, 0, 0, True), (20_224, 1, 0, False), (20_224, 0, 1, False), (20_222, 0, 0, False)])
def test_pass_vec_needs_both_rows_aligned(d, p_off, out_off, vec):
    # The route counter's test of 16-byte rows is the C rule's: D % 4 == 0
    # and both P and out 16-byte aligned (a P 4 bytes off, or an out 4
    # bytes off, keeps the 32-tiles).
    def at(off):
        return torch.empty(d * 4 + 8)[off:off + d * 4].view(4, d).T
    p, out = at(p_off), at(out_off)
    assert (p.data_ptr() % 16 == 0, out.data_ptr() % 16 == 0) == (p_off == 0, out_off == 0)
    assert fk.pass_vec(p, out) == vec
    assert fk.pass_tile(d, 132, fk.pass_vec(p, out)) == (fk.PASS_BIG if vec else fk.PASS_SMALL)


@pytest.mark.parametrize("nt,grid", [(158, 132), (80, 132), (79, 132), (5, 3), (3, 6), (46, 7)])
def test_stream_pass_walk_visits_every_tile_once(nt, grid):
    # Every upper-triangle tile exactly once over the blocks (grid past
    # the tiles: the extra blocks take none), each block's in list order.
    want = [(i, j) for i in range(nt) for j in range(i, nt)]
    order = {t: k for k, t in enumerate(want)}
    walks = [fk.pass_walk(nt, grid, b) for b in range(grid)]
    seen = [t for w in walks for t in w]
    assert sorted(seen) == want
    for b, w in enumerate(walks):
        assert [order[t] for t in w] == list(range(b, len(want), grid))


def test_stream_pass_shared_memory_fits_one_block():
    # 1 KB to align, the strips' ring of SP_STAGES x 2 x SP_BK rows of 128,
    # SP_SLOTS half-blocks of 64 x 128 (four boxes of 64 x 32 in the
    # 128-byte swizzle), two mbarriers a stage and three a slot; one block
    # an SM on an H100.
    assert fk.stream_pass_smem_bytes() == 1024 + 4 * (4 * 2 * 16 * 128 + 5 * 64 * 128) + 8 * 23
    assert fk.stream_pass_smem_bytes() == 230_584 <= cuda.MAX_SMEM_BYTES
    # The swizzle spreads a phase of 8 threads over 8 bank groups: along a
    # row of P[I, J]'s half (16-byte chunks tx), and down P[J, I]'s rows
    # 4 tx + b, b rotated by tx / 2.
    def group(v, c):     # resident.cuh sw(): the 16-byte chunk's bank group
        return ((c >> 2) & 7) ^ (v & 7)
    for ty in range(16):
        for u in (4 * ty + a for a in range(4)):
            for hh in (0, 1):
                assert len({group(u, 64 * hh + 4 * tx) for tx in range(8)}) == 8
    for k in range(4):
        for ty in range(16):
            assert len({group(4 * tx + ((k + (tx >> 1)) & 3), 4 * ty) for tx in range(8)}) == 8


@pytest.mark.parametrize("route", sorted(fk.PASS_ROUTES))
def test_frame_pass_plain_version(route):
    # On the CPU every route is the plain P + G^T MG over the strips'
    # first D columns.
    gen = torch.Generator().manual_seed(3)
    d, r, ldg = 37, 11, 40
    a = torch.randn(d, 4, generator=gen)
    p = a @ a.T
    g, mg = torch.randn(r, ldg, generator=gen), torch.randn(r, ldg, generator=gen)
    got = fk.frame_pass(p, g, mg, route)
    torch.testing.assert_close(got, p + g[:, :d].T @ mg[:, :d], rtol=0, atol=0)
    with pytest.raises(ValueError):
        fk.frame_pass(p, g, mg, "tile64")
