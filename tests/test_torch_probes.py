"""The probe kernels of ``tools/`` in the PyTorch port (``ops/probes.py``)
against their JAX bodies: ``tpu_v13_bisect.make_body`` (shifted, paired),
``tpu_v12_ablate2.make_body`` (full, nopt, statwin, nomm, mmonly),
``tpu_v10_probe.make_kernel_body`` (full, norotate, nobcast, noonehot,
nomatmul) and ``tpu_v12_ablate.make_kernel_body`` (full, nomatmul,
norotate, nomask, floor), each wrapped here in a ``pallas_call`` with
``interpret=True`` shaped as its tool's ``build`` shapes it (those
functions take no ``interpret`` flag);
``tpu_pallas_gather_probe.pallas_gather_axis1`` and
``pallas_gather_grid`` with ``pl.pallas_call`` patched to interpret mode; and ``tpu_indirect_dma_probe.main()`` (forms A, B and C) run the
same way with its row count ``G`` shrunk.

Inputs: v12- and v10-packed groups of resolver plans (16 KiB blocks, as
the other parity files pack them), the hand-made plans of
``test_torch_cuda.quad_plan`` / ``lane_plan`` (rows at or past 128 or
the literal rows, target rows outside the tile, tiles whose batch counts
are not multiples of 4, sums past 255; nomm values past 256, where the
bf16 rounding shows), and the gathers' random tables from numpy seeds.
Tolerance: exact equality of the output bytes (the JAX kernels' int32
output reduced mod 256; max abs err 0) and of the gathered elements.
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from zxc_tpu_torch.ops import attic as A, probes as P, serial as S

from test_torch_jax_native import jax_native
from test_torch_attic_ops import _plans
from test_torch_cuda import lane_plan, quad_plan

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import tpu_indirect_dma_probe as dma_probe  # noqa: E402
import tpu_pallas_gather_probe as gather_probe  # noqa: E402
import tpu_v10_probe  # noqa: E402
import tpu_v12_ablate  # noqa: E402
import tpu_v12_ablate2  # noqa: E402
import tpu_v13_bisect  # noqa: E402

BLOCK = 16384


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _vmem(shape):
    return pl.BlockSpec(shape, lambda b, *_: (b, 0, 0),
                        memory_space=pltpu.VMEM)


def jax_quad_body(body, args) -> np.ndarray:
    """A quad body of tpu_v13_bisect / tpu_v12_ablate2 as their ``build``
    calls it, in interpret mode: (B, NT*32, 128) uint8."""
    qs, qbase, pctrl, tq, lit8 = args
    B, NR = pctrl.shape[0], (qs.shape[1] - 1) * 32
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(B,),
        in_specs=[_vmem((1,) + pctrl.shape[1:]), _vmem((1,) + tq.shape[1:]),
                  _vmem((1,) + lit8.shape[1:])],
        out_specs=_vmem((1, NR, 128)))
    out = pl.pallas_call(body, grid_spec=spec, interpret=True,
                         out_shape=jax.ShapeDtypeStruct((B, NR, 128),
                                                        jnp.int32))(
        qs, qbase, pctrl, tq, jnp.asarray(lit8).astype(jnp.bfloat16))
    return (np.asarray(out) & 255).astype(np.uint8)


def jax_lane_body(body, ts, pctrl, lit8) -> np.ndarray:
    """A lane-sum body of tpu_v10_probe / tpu_v12_ablate as their
    ``build_kernel`` calls it, in interpret mode."""
    B, NR = pctrl.shape[0], (ts.shape[1] - 1) * 32
    spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(B,),
        in_specs=[_vmem((1,) + pctrl.shape[1:]),
                  _vmem((1,) + lit8.shape[1:])],
        out_specs=_vmem((1, NR, 128)))
    out = pl.pallas_call(body, grid_spec=spec, interpret=True,
                         out_shape=jax.ShapeDtypeStruct((B, NR, 128),
                                                        jnp.int32))(
        ts, pctrl, jnp.asarray(lit8).astype(jnp.bfloat16))
    return (np.asarray(out) & 255).astype(np.uint8)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(got: torch.Tensor, want: np.ndarray) -> None:
    got = got.numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert int(np.abs(got.astype(np.int32) - want).max()) == 0


@functools.lru_cache(maxsize=None)
def _v12_group(quad_align: int):
    _, totals, pieces, lits = _plans("l3", BLOCK)
    return S.pack_blocks_v12(pieces, lits, totals, BLOCK,
                             quad_align=quad_align)


@functools.lru_cache(maxsize=None)
def _v10_group():
    """(ts, pctrl, lit8) of one v10-packed group with at least 208 literal
    rows (nomatmul reads rows 0-127, nobcast row 200)."""
    _, totals, pieces, lits = _plans("l3", BLOCK)
    RL = max(max(-(-len(x) // 128) for x in lits) + 1, 208)
    _, ts, pctrl, lit8 = A.pack_blocks_v10(pieces, lits, totals, BLOCK,
                                           RL=RL)
    return ts, pctrl, lit8


def _quad_hand_made(seed: int):
    return quad_plan(seed, 2, 4 + seed, 24, 256, 12)


# -- the quad probes ---------------------------------------------------------

@pytest.mark.parametrize("shifted,paired", P.V13_BISECT_MODES)
def test_v13_bisect_equals_jax(shifted, paired):
    body = tpu_v13_bisect.make_body(shifted, paired)
    group = _v12_group(2)
    _equal(P.v13_bisect(*_t(group), shifted, paired),
           jax_quad_body(body, group))
    for seed in range(2):
        plan = _quad_hand_made(seed)
        got = P.v13_bisect(*_t(plan), shifted, paired)
        _equal(got, jax_quad_body(body, plan))
        assert got.any()


@pytest.mark.parametrize("mode", P.V12_ABLATE2_MODES)
def test_v12_ablate2_equals_jax(mode):
    body = tpu_v12_ablate2.make_body(mode)
    group = _v12_group(1)
    _equal(P.v12_ablate2(*_t(group), mode), jax_quad_body(body, group))
    for seed in range(2):
        plan = _quad_hand_made(seed)
        _equal(P.v12_ablate2(*_t(plan), mode), jax_quad_body(body, plan))


def test_nomm_rounds_to_bf16_as_jax_does():
    """One slot a quad, its row field 2047 and a byte of 255 or less: each
    masked value (byte + 2047) rounds to a multiple of 16 in bf16, half to
    even, before the sum (the JAX body's bf16 permute)."""
    MAXQ, RLP = 8, 256
    G32 = 32 * -(-4 * MAXQ // 128)
    pctrl = np.full((1, G32, 128), 1 << 7, np.int64)
    pctrl[0, 0, 0:4 * MAXQ:4] = (127 << 14) | (2047 << 21)   # slot 0
    lit8 = np.zeros((1, RLP, 128), np.uint8)
    lit8[0, 0] = np.arange(128) * 2 + 1                      # odd bytes
    lit8[0, 16] = np.arange(128) * 2
    qbase = np.array([[0, 16, 0, 16, 0, 0, 0, 0]], np.int32)
    plan = (np.array([[0, 4]], np.int32), qbase,
            pctrl.astype(np.uint32).view(np.int32),
            np.zeros((1, MAXQ, 128), np.int32), lit8)
    got = P.v12_ablate2(*_t(plan), "nomm")
    _equal(got, jax_quad_body(tpu_v12_ablate2.make_body("nomm"), plan))
    want = sum(torch.tensor(lit8[0, r].astype(np.int64) + 2047).float()
               .to(torch.bfloat16).int() for r in (0, 16, 0, 16))
    assert torch.equal(got[0, 0].int(), want & 255)
    assert (want % 16 == 0).all()


# -- the lane probes ---------------------------------------------------------

@pytest.mark.parametrize("mode", P.V10_PROBE_MODES)
def test_v10_probe_equals_jax(mode):
    body = tpu_v10_probe.make_kernel_body(mode)
    ts, pctrl, lit8 = _v10_group()
    _equal(P.v10_probe(*_t((ts, pctrl, lit8)), mode),
           jax_lane_body(body, ts, pctrl, lit8))
    for seed in range(2):
        ts, _, pctrl, lit, _ = lane_plan(seed, 3, 8192, 10, RL=256)
        _equal(P.v10_probe(*_t((ts, pctrl, lit)), mode),
               jax_lane_body(body, ts, pctrl, lit))


@pytest.mark.parametrize("mode", P.V12_ABLATE_MODES)
def test_v12_ablate_equals_jax(mode):
    body = tpu_v12_ablate.make_kernel_body(mode)
    ts, pctrl, lit8 = _v10_group()
    _equal(P.v12_ablate(*_t((ts, pctrl, lit8)), mode),
           jax_lane_body(body, ts, pctrl, lit8))
    for seed in range(2):
        ts, _, pctrl, lit, _ = lane_plan(seed, 3, 8192, 10, RL=256)
        _equal(P.v12_ablate(*_t((ts, pctrl, lit)), mode),
               jax_lane_body(body, ts, pctrl, lit))


def test_probe_modes_are_checked():
    ts, pctrl, lit8 = _t(_v10_group())
    group = _t(_v12_group(1))
    with pytest.raises(ValueError, match="mode"):
        P.v10_probe(ts, pctrl, lit8, "floor")
    with pytest.raises(ValueError, match="mode"):
        P.v12_ablate(ts, pctrl, lit8, "noonehot")
    with pytest.raises(ValueError, match="mode"):
        P.v12_ablate2(*group, "norotate")
    with pytest.raises(ValueError, match="rows 0-127"):
        P.v10_probe(ts, pctrl, lit8[:, :112].contiguous(), "nomatmul")
    with pytest.raises(ValueError, match="cuda or cpu"):
        P.v12_ablate(ts.to("meta"), pctrl.to("meta"), lit8.to("meta"),
                     "full")
    before = {k: f.launches for k, f in P.KERNELS.items()}
    P.v10_probe(ts, pctrl, lit8, "full")
    P.v13_bisect(*group, True, True)
    assert {k: f.launches for k, f in P.KERNELS.items()} == before


# -- the gathers -------------------------------------------------------------

@pytest.fixture
def interpret(monkeypatch):
    """``pl.pallas_call`` in interpret mode for the probes' own kernels."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))


@pytest.mark.parametrize("M,N,dtype", [(8, 1024, np.int32),
                                       (16, 256, np.int32),
                                       (8, 2048, np.uint8)])
def test_gather_axis1_equals_jax(interpret, M, N, dtype):
    rng = np.random.default_rng(M + N)
    x = rng.integers(0, 256 if dtype == np.uint8 else 100,
                     (M, N)).astype(dtype)
    idx = rng.integers(0, N, (M, N)).astype(np.int32)
    want = np.asarray(gather_probe.pallas_gather_axis1(jnp.asarray(x),
                                                       jnp.asarray(idx)))
    got = P.gather_axis1(*_t((x, idx)))
    assert got.dtype == torch.from_numpy(x).dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, np.take_along_axis(x, idx, axis=1))


def test_gather_grid_equals_jax(interpret):
    rng = np.random.default_rng(5)
    M, N, tile = 8, 1024, 512
    x = rng.integers(0, 100, (M, N)).astype(np.int32)
    idx = rng.integers(0, N, (M, 4 * tile)).astype(np.int32)
    want = np.asarray(gather_probe.pallas_gather_grid(
        jnp.asarray(x), jnp.asarray(idx), tile))
    assert np.array_equal(P.gather_grid(*_t((x, idx)), tile).numpy(), want)
    with pytest.raises(ValueError, match="tile"):
        P.gather_grid(*_t((x, idx[:, :700])), tile)


def test_gathers_read_zero_outside_the_table():
    x = torch.arange(12, dtype=torch.int32).view(2, 6) + 1
    idx = torch.tensor([[0, -1, 6, 5], [7, 2, -9, 1]], dtype=torch.int32)
    got = P.gather_axis1(x, idx)
    assert got.tolist() == [[1, 0, 0, 6], [0, 9, 0, 8]]
    assert torch.equal(P.gather_grid(x, idx, 2), got)
    table = torch.arange(8, dtype=torch.int32).view(4, 2)
    rows = P.gather_rows(table, torch.tensor([3, 4, -1, 0],
                                             dtype=torch.int32), "b")
    assert rows.tolist() == [[6, 7], [0, 0], [0, 0], [0, 1]]
    with pytest.raises(TypeError):
        P.gather_axis1(x.long(), idx)
    with pytest.raises(ValueError, match="form"):
        P.gather_rows(table, idx[0], "d")


def test_indirect_dma_probe_forms_equal_the_port(interpret, monkeypatch,
                                                 capsys):
    """The probe's own main() with its forms in interpret mode (G rows
    shrunk from 1024): A, B and C run and give table[idx]; the port's
    forms equal table[idx] on the same draws."""
    monkeypatch.setattr(dma_probe, "G", 64)
    dma_probe.main()
    out = capsys.readouterr().out
    assert "WRONG RESULT" not in out and "FAIL" not in out
    assert out.count(" OK ") == 3
    rng = np.random.default_rng(0)
    table = rng.integers(0, 256, (dma_probe.R, dma_probe.C)).astype(np.int32)
    idx = rng.integers(0, dma_probe.R, (64,)).astype(np.int32)
    for form, fn in P.ROW_ENTRIES.items():
        got = fn(*_t((table, idx)))
        assert np.array_equal(got.numpy(), table[idx])
        assert torch.equal(got, P.gather_rows(*_t((table, idx)), form))


def test_bytes_moved_of_the_gathers():
    x = np.zeros((2, 10), np.int32)
    idx = np.array([[0, 0, 3, 11], [1, 1, 1, -2]], np.int32)
    # index 32 B, output 32 B, distinct in-table elements (0,0) (0,3) (1,1)
    assert P.gather_bytes_moved(x, idx) == 32 + 32 + 3 * 4
    table = np.zeros((5, 3), np.int32)
    rows = np.array([4, 4, 0, 9], np.int32)
    assert P.rows_bytes_moved(table, rows) == 16 + 4 * 12 + 2 * 12
