"""The tile routine's launch geometry (``copy_engine.tile_plan``), which the
wrappers of v19, v13, ``quad`` and the quad probes pass to the card's
``tiled_kernel``: clusters of 1, 2 or 4 CTAs a tile (the kernel takes up
to 8) that divide its rows, more than one only where the grid leaves most
SMs idle; every item of a tile's walk added by exactly one warp of one
rank, and every row of the tile summed and stored by exactly one rank.
CPU only; exact."""
import pytest

from zxc_tpu_torch.ops import copy_engine as CE

WARPS = CE.TILE_THREADS // 32
H100_SMS = 132


def rank_items(n: int, C: int, r: int) -> list[int]:
    """The items rank r of a cluster of C adds, as the kernel's warps walk
    them: warp w from w * C + r in steps of 32 * C."""
    return [it for w in range(WARPS) for it in range(w * C + r, n,
                                                     WARPS * C)]


@pytest.mark.parametrize("sms", [H100_SMS, 114, 1])
@pytest.mark.parametrize("rows", [32, 128])
@pytest.mark.parametrize("B", [0, 1, 3, 16, 64, 200])
@pytest.mark.parametrize("NT", [0, 1, 4, 32])
def test_tile_plan_geometry(NT, B, rows, sms):
    plan = CE.tile_plan(B, NT, rows, sms)
    assert (plan.B, plan.NT, plan.rows) == (B, NT, rows)
    assert plan.C in (1, 2, 4) and plan.C <= CE.TILE_MAX_CLUSTER
    assert rows % plan.C == 0 and plan.slice * plan.C == rows
    if plan.C > 1:            # a split only while the card has room for it
        assert B * NT * plan.C <= sms
    if 2 * B * NT > sms:      # the grid fills half the card: no split
        assert plan.C == 1
    # the largest such split
    if plan.C < CE.TILE_MAX_CLUSTER:
        assert B * NT * 2 * plan.C > sms


@pytest.mark.parametrize("C", [1, 2, 4, 8])
@pytest.mark.parametrize("n", [0, 1, 5, 31, 32, 128, 1000])
def test_rank_items_partition_a_tile(n, C):
    """4 items a quad, quads of the tile's walk: each in one rank."""
    seen = [it for r in range(C) for it in rank_items(n, C, r)]
    assert sorted(seen) == list(range(n))
    for r in range(C):
        assert all(it % C == r for it in rank_items(n, C, r))


@pytest.mark.parametrize("rows", [32, 128])
@pytest.mark.parametrize("C", [1, 2, 4, 8])
def test_rank_row_slices_cover_the_tile_once(C, rows):
    plan = CE.TilePlan(1, 1, rows, C, rows // C)
    slices = [range(r * plan.slice, (r + 1) * plan.slice) for r in range(C)]
    assert [row for s in slices for row in s] == list(range(rows))
    # each rank reads its rows as 16-byte words: 32 a row, whole rows
    part = rows * 128 // 4 // C
    assert part == plan.slice * 32
    assert all(part * r == plan.slice * r * 32 for r in range(C))


def test_first_groups_of_the_tile_paths():
    """The first dispatch groups the smoke run and the A/B time, at the
    cluster sizes the sweep found fastest on an H100: v13 at 4 KiB blocks
    (16 tiles of 32 rows) C=4, v19 and the 128-row attic modes at 64 KiB
    blocks (64 supertiles) C=2; 512 KiB blocks fill the card."""
    assert CE.tile_plan(16, 1, 32).C == 4
    assert CE.tile_plan(16, 4, 128).C == 2
    assert CE.tile_plan(16, 32, 128).C == 1
