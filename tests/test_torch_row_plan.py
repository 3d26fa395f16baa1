"""The row gather's launch geometry (``probes.row_plan``), which the
wrappers of ``dma_a`` / ``dma_b`` / ``dma_c`` pass to the card's kernels:
every output row in exactly one CTA's run (form b: one warp), every piece
of a row within one stage (a multiple of 16 bytes where it is a bulk
copy), the grid and the shared memory within what the kernels take, and
rows that a bulk copy cannot move marked for the kernel's edge path. CPU
only; exact."""
import pytest

from zxc_tpu_torch.ops import probes as P

MAX_GRID = 2**31 - 1          # CUDA's grid.x
MAX_SMEM = 48 << 10           # csrc/gather.cu kMaxSmem
MAX_ROWS, MAX_STAGES = 1024, 8
MAX_WARPS = 32                # kMaxRowWarps: form b's rows a CTA


def runs(plan) -> list[range]:
    """Each CTA's output rows, as the kernel derives them from its index."""
    k = plan.rows_per_cta
    return [range(b * k, min(plan.G, (b + 1) * k)) for b in range(plan.grid)]


def pieces(plan) -> list[tuple[int, int]]:
    """(first word, words) of each piece of a row, as the kernel cuts it."""
    if not plan.piece:
        return []
    return [(c, min(plan.piece, plan.C - c))
            for c in range(0, plan.C, plan.piece)]


@pytest.mark.parametrize("form", ["a", "c"])
@pytest.mark.parametrize("C", [0, 1, 3, 128, 12000])
@pytest.mark.parametrize("G", [0, 1, 7, 1024, 3000])
def test_row_plan_covers_rows_and_pieces(G, C, form):
    plan = P.row_plan(G, C, form)
    assert (plan.G, plan.C) == (G, C)
    # every output row exactly once, each CTA's run non-empty
    cuts = runs(plan)
    assert len(cuts) == plan.grid <= MAX_GRID
    assert [i for r in cuts for i in r] == list(range(G))
    assert all(len(r) for r in cuts)
    assert 1 <= plan.rows_per_cta <= MAX_ROWS
    assert plan.rows_per_cta == P.ROWS_PER_CTA[form]
    # the pieces of a row, in order, each within one stage
    row = pieces(plan)
    assert [c for start, n in row for c in range(start, start + n)] == \
        list(range(C))
    assert all(1 <= n <= plan.piece for _, n in row)
    assert 4 * plan.piece <= P.STAGE_BYTES
    # bulk copies: 16-byte rows and pieces; else the edge path
    assert plan.bulk == (C % 4 == 0)
    if plan.bulk:
        assert all(4 * n % 16 == 0 and 4 * start % 16 == 0
                   for start, n in row)
    assert plan.stages == P.STAGES[form]
    assert (plan.stages == 1) if form == "a" else (
        2 <= plan.stages <= MAX_STAGES)
    # shared memory: the mbarriers and the run's indices, then the stages
    head = 8 * plan.stages + 4 * plan.rows_per_cta
    stages = 4 * plan.piece * plan.stages if plan.bulk else 0
    assert head + stages <= plan.smem <= MAX_SMEM
    assert (plan.smem - stages) % 128 == 0


@pytest.mark.parametrize("form", ["a", "c"])
@pytest.mark.parametrize("C", [1, 3, 128, 12000])
def test_row_plan_marks_unaligned_rows_for_the_edge_path(C, form):
    """A table or output that does not start on 16 bytes (for example a
    view 4 bytes into its storage) or rows of C % 4 != 0 words go by the
    threads' plain loads, and then need no stage."""
    aligned, offset = P.row_plan(1024, C, form), P.row_plan(1024, C, form,
                                                            aligned=False)
    assert not offset.bulk
    assert offset.smem == -(-(8 * offset.stages + 4 * offset.rows_per_cta)
                            // 128) * 128
    assert aligned.bulk == (C % 4 == 0)
    assert offset._replace(bulk=aligned.bulk, smem=aligned.smem) == aligned


@pytest.mark.parametrize("G", [0, 1, 1024, 3000])
def test_row_plan_of_form_b_is_a_warp_a_row(G):
    """Form b: ``ROWS_PER_CTA["b"]`` warps a CTA (at most 32), a warp a
    row, every output row in exactly one warp; the whole row one piece,
    no stage, no shared memory; 16-byte copies only where the rows are
    16-byte aligned."""
    plan = P.row_plan(G, 128, "b")
    k = P.ROWS_PER_CTA["b"]
    assert 1 <= k <= MAX_WARPS
    assert (plan.grid, plan.rows_per_cta, plan.piece, plan.stages,
            plan.bulk, plan.smem) == (-(-G // k), k, 128, 0, True, 0)
    cuts = runs(plan)
    assert [i for r in cuts for i in r] == list(range(G))
    assert all(1 <= len(r) <= k for r in cuts)
    assert not P.row_plan(G, 128, "b", aligned=False).bulk
    assert not P.row_plan(G, 127, "b").bulk


def test_row_plan_refuses_other_forms():
    with pytest.raises(ValueError, match="form"):
        P.row_plan(8, 8, "d")
