"""The schedules of the row-wise gather (``probes.gather_axis1``) and of
form b of the row gather (``probes.dma_b``) on the card, as numpy models
run on the CPU.

``gather_axis1`` runs the grid gather's kernels in the geometry of
``probes.grid_plan``: the plan at each of the six shapes of
``tools/tpu_pallas_gather_probe.py``'s ``main()`` on 132 SMs (the L2
form, about one CTA an SM), and
``test_torch_walk_schedule.grid_model`` (each CTA's slice of the table row
and its columns, thread by thread, every output written once) on
gather_axis1's plans at small sizes of each form, int32 and uint8, held
against ``pallas_gather_axis1`` in interpret mode where the index lies in
the row, and against the plain version everywhere (indices outside the
row and at +-2^31 read 0), with index columns no multiple of 4 or 16 and
an empty row.

``warp_row_model`` follows ``csrc/gather.cu``'s form b: CTA k's warp w
copies output row k * warps + w, lane l its 16-byte pieces (or words) l,
l + 32, ...; held against ``build_b`` of ``tools/tpu_indirect_dma_probe.py``
run in interpret mode by the probe's own ``main()`` (its R, C and G
patched), and against the plain version on rows outside the table.
Tolerance: exact equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_gather_schedule.py
"""
import functools
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
from jax.experimental import pallas as pl

from zxc_tpu_torch.ops import probes as P

from test_torch_walk_schedule import grid_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import tpu_indirect_dma_probe as dma_probe  # noqa: E402
import tpu_pallas_gather_probe as gather_probe  # noqa: E402

SMS = 132
MAX_WARPS = 32                # csrc/gather.cu kMaxRowWarps


@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the probes' own kernels."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


# -- gather_axis1's plans -------------------------------------------------------

PROBE_PLANS = {  # (M, N, esize): the plan gather_axis1 ships on 132 SMs,
    # (form, K, CTAs a row, threads, columns a CTA)
    (8, 1 << 13, 4): ("l2", 1, 8, 64, 1024),
    (8, 1 << 16, 4): ("l2", 1, 16, 256, 4096),
    (8, 1 << 19, 4): ("l2", 1, 16, 512, 32768),
    (64, 1 << 16, 4): ("l2", 1, 2, 512, 32768),
    (256, 1 << 13, 4): ("l2", 1, 1, 512, 8192),
    (8, 1 << 16, 1): ("l2", 1, 16, 256, 4096),
}


@pytest.mark.parametrize("M,N,esize", list(PROBE_PLANS))
def test_gather_axis1_plan_at_the_probe_shapes(M, N, esize):
    """Form, K, CTAs a row, threads and columns a CTA at each shape of the
    probe's ``main()`` (a square index reads each row element once on
    average: the L2 form); about one CTA an SM, or one a row; the
    CTAs' columns cover the index row once; 16-byte access only on
    aligned rows."""
    plan = P.grid_plan(M, N, N, esize, True, SMS)
    form, K, ctas, threads, cols = PROBE_PLANS[(M, N, esize)]
    assert (plan.form, plan.K, plan.clusters, plan.threads, plan.cols) == (
        form, K, ctas, threads, cols)
    assert plan.clusters * plan.cols >= N > (plan.clusters - 1) * plan.cols
    assert N < P.GRID_CLUSTER_READS * N
    assert plan.cols % (plan.threads * P.GRID_L2_COLS) == 0
    assert plan.vec and plan.smem == plan.slice == 0
    assert M * plan.clusters <= max(SMS, M)
    assert P.grid_plan(M, N, N, esize, False, SMS) == plan._replace(
        vec=False)


AXIS1_SMALL = [  # M, N, NI, dtype, aligned: form, K
    (3, 500, 4099, np.int32, True, "cluster", 1),
    (2, 60_000, 500_000, np.int32, False, "cluster", 2),
    (4, 2048, 16_400, np.uint8, True, "cluster", 1),
    (2, 300_000, 2_400_001, np.uint8, True, "cluster", 2),
    (3, 1000, 3001, np.int32, True, "l2", 1),
    (2, 420_000, 4096, np.int32, True, "l2", 1),
    (200, 10_000, 20_000, np.int32, True, "l2", 1),
    (2, 1_700_000, 4112, np.uint8, True, "l2", 1),
    (2, 1_700_000, 4100, np.uint8, False, "l2", 1),
]


def _inputs(M, N, NI, dtype, seed, outside: bool):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256 if dtype == np.uint8 else 100,
                     (M, N)).astype(dtype)
    if not outside:
        return x, rng.integers(0, N, (M, NI)).astype(np.int32)
    idx = rng.integers(-3, N + 3, (M, NI)).astype(np.int64)
    idx[:, ::11] = rng.integers(-2**31, 2**31 - 1, idx[:, ::11].shape)
    idx[0, :2] = (-2**31, 2**31 - 1)
    return x, idx.astype(np.int32)


def _plain(x, idx):
    ok = (idx >= 0) & (idx < x.shape[1])
    if x.shape[1] == 0:
        return np.zeros(idx.shape, x.dtype)
    return np.where(ok, np.take_along_axis(x, np.where(ok, idx, 0), 1),
                    0).astype(x.dtype)


@pytest.mark.parametrize("M,N,NI,dtype,aligned,form,K", AXIS1_SMALL)
def test_gather_axis1_schedule_equals_jax(interpret, M, N, NI, dtype,
                                          aligned, form, K):
    """The grid model on gather_axis1's plan equals ``pallas_gather_axis1``
    in interpret mode (indices in the row), and the plain version with
    indices outside the row and at +-2^31, where the JAX kernel promises
    nothing and the port reads 0."""
    plan = P.grid_plan(M, N, NI, np.dtype(dtype).itemsize, aligned, SMS)
    assert (plan.form, plan.K) == (form, K)
    assert plan.vec == (form == "l2" and aligned
                        and NI % (16 // np.dtype(dtype).itemsize) == 0)
    x, idx = _inputs(M, N, NI, dtype, N + NI, outside=False)
    want = np.asarray(gather_probe.pallas_gather_axis1(jnp.asarray(x),
                                                       jnp.asarray(idx)))
    assert np.array_equal(grid_model(x, idx, plan), want)
    x, idx = _inputs(M, N, NI, dtype, N + NI + 1, outside=True)
    got = grid_model(x, idx, plan)
    ok = (idx >= 0) & (idx < N)
    want = np.asarray(gather_probe.pallas_gather_axis1(
        jnp.asarray(x), jnp.asarray(np.where(ok, idx, 0))))
    assert np.array_equal(got[ok], want[ok])
    assert np.array_equal(got, _plain(x, idx))


@pytest.mark.parametrize("dtype", [np.int32, np.uint8])
def test_gather_axis1_schedule_of_an_empty_row(dtype):
    """N = 0: the L2 form, every output 0."""
    plan = P.grid_plan(3, 0, 100, np.dtype(dtype).itemsize, True, SMS)
    assert plan.form == "l2" and plan.clusters == 1
    x = np.zeros((3, 0), dtype)
    _, idx = _inputs(3, 5, 100, np.int32, 7, outside=True)
    got = grid_model(x, idx, plan)
    assert got.dtype == dtype and not got.any()


# -- dma_b, a warp a row --------------------------------------------------------

def warp_row_model(table: np.ndarray, idx: np.ndarray, plan) -> np.ndarray:
    """Form b by ``plan``'s schedule: CTA k's warp w copies output row
    k * rows_per_cta + w (warps past G idle), lane l the pieces l, l +
    32, ... of 4 words (``bulk``: 16-byte loads and stores) or of one
    word; a row outside the table is written 0; every output word
    exactly once."""
    R, C = table.shape
    G = len(idx)
    assert 1 <= plan.rows_per_cta <= MAX_WARPS
    assert plan.grid * plan.rows_per_cta >= G
    assert (plan.piece, plan.stages, plan.smem) == (C, 0, 0)
    run = 4 if plan.bulk else 1
    if plan.bulk:
        assert C % 4 == 0
    out = np.zeros((G, C), np.int32)
    written = np.zeros((G, C), np.int64)
    for k in range(plan.grid):
        for w in range(plan.rows_per_cta):
            g = k * plan.rows_per_cta + w
            if g >= G:
                continue
            r = int(idx[g])
            ok = 0 <= r < R
            for lane in range(32):
                pieces = np.arange(lane, C // run, 32)
                words = (pieces[:, None] * run + np.arange(run)).reshape(-1)
                out[g, words] = table[r, words] if ok else 0
                written[g, words] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("C", [127, 128, 129, 256])
def test_dma_b_schedule_equals_build_b(interpret, monkeypatch, C):
    """The probe's own ``main()`` with its R, C and G patched (G = 37, no
    multiple of the warps a CTA), ``build_b`` in interpret mode: its
    output equals the warp-a-row model, with 16-byte pieces where C % 4
    == 0 and words otherwise, and with words on a table off 16 bytes."""
    G = 37
    monkeypatch.setattr(dma_probe, "C", C)
    monkeypatch.setattr(dma_probe, "G", G)
    outs = {}

    def attempt(name, build):      # build_b only, its output kept
        if name.startswith("B "):
            outs[name] = np.asarray(build()())
        return False
    monkeypatch.setattr(dma_probe, "attempt", attempt)
    dma_probe.main()
    (want,) = outs.values()
    rng = np.random.default_rng(0)          # main()'s draws
    table = rng.integers(0, 256, (dma_probe.R, C)).astype(np.int32)
    idx = rng.integers(0, dma_probe.R, (G,)).astype(np.int32)
    assert np.array_equal(want, table[idx])
    for aligned in (True, False):
        plan = P.row_plan(G, C, "b", aligned)
        assert plan.bulk == (aligned and C % 4 == 0)
        assert G % plan.rows_per_cta or plan.rows_per_cta == 1
        assert np.array_equal(warp_row_model(table, idx, plan), want)


@pytest.mark.parametrize("G", [1, 1023, 3000])
@pytest.mark.parametrize("warps", [1, 8, 32])
def test_dma_b_schedule_writes_zero_rows_outside_the_table(G, warps):
    """Rows outside the table, at +-2^31 among them, read 0, over grids
    of 1, 8 and 32 warps a CTA; equal to the plain version."""
    import torch
    rng = np.random.default_rng(G + warps)
    table = rng.integers(-2**31, 2**31, (300, 128)).astype(np.int32)
    idx = rng.integers(-5, 305, G).astype(np.int64)
    idx[::5] = rng.integers(-2**31, 2**31 - 1, len(idx[::5]))
    idx[0] = -2**31
    idx = idx.astype(np.int32)
    plan = P.warp_row_plan(G, 128, True, warps)
    assert plan.grid == -(-G // warps)
    want = P.gather_rows_reference(torch.from_numpy(table),
                                   torch.from_numpy(idx)).numpy()
    assert np.array_equal(warp_row_model(table, idx, plan), want)
