"""The port of the probe kernels in ``tools/``: wrappers, plain versions,
launch counters and byte counts.

The JAX package has nine ``pl.pallas_call`` sites that only the probes'
own ``main()`` reach; each measures one piece of a decode kernel on the
TPU. Their ablated modes give wrong output on purpose ("timing only"), so
the port's counterpart of each mode is the body's arithmetic, stated in
its plain version and run by a hand-written kernel:

* ``v13_bisect`` (``tools/tpu_v13_bisect.py``, ``build`` / ``make_body``):
  the v12 quad body with shifted-iota compares, which select the same
  rows, rolls and lanes, so ``shifted`` changes nothing; ``paired`` walks
  pairs (v13) where the unpaired body runs every quad (v12). Launches the
  copy engine's mode-12 or v13 instantiation.
* ``v12_ablate2`` (``tools/tpu_v12_ablate2.py``, ``build`` / ``make_body``):
  v12's quad body, ``full`` or one of ``copy_engine.QUAD_ABLATIONS``
  (``csrc/copy_engine.cu``, ``zxc_copy_engine_quad_ablate``).
* ``v10_probe`` and ``v12_ablate`` (``tools/tpu_v10_probe.py`` and
  ``tools/tpu_v12_ablate.py``, ``build_kernel`` / ``make_kernel_body``):
  v10's lane sum, ``full`` or an ablation (``attic.LANE_PROBES``;
  ``csrc/attic.cu``, ``zxc_lane_sum_probe``). ``norotate`` is two
  functions: v10_probe drops the roll, v12_ablate adds the roll amount.
* ``gather_axis1`` and ``gather_grid`` (``tools/tpu_pallas_gather_probe.py``):
  ``out[i, j] = x[i, idx[i, j]]``; the grid form's ``tile`` is checked.
  Both run the same kernels on ``grid_plan``'s schedule: the table row in
  the shared memory of a cluster of CTAs, each answering the indices of
  its own slice, where the index reads each row element 4 times or more;
  else read through L1 and L2, a run of one row's columns a CTA.
* ``gather_rows`` (``tools/tpu_indirect_dma_probe.py``, ``build_a/b/c``):
  ``out[i] = table[idx[i]]``, by bulk async row copies one at a time a CTA
  (``dma_a``), a warp a row all at once (``dma_b``) or bulk row copies
  pipelined through a ring of stages a CTA (``dma_c``), over the grid of
  ``row_plan``; ``csrc/gather.cu``.

An index outside its table reads 0 (the JAX kernels leave it undefined).
Inputs are the probes' own: the packers' groups (``serial.pack_blocks_v12``
for the quad probes, ``attic.pack_blocks_v10`` for the lane probes) and
the gathers' int32 or uint8 tables. Outputs of the decode probes are (B,
NR, 128) uint8, the JAX kernels' int32 tiles mod 256. On a CPU tensor
each wrapper runs its plain version; on a CUDA tensor it launches its
kernel or raises, counting launches in ``.launches`` (the row gather's
forms each in their own entry's counter).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import attic, copy_engine as CE

# the modes each probe's main() runs, in its order
V13_BISECT_MODES = ((True, False), (False, True), (True, True))
V12_ABLATE2_MODES = ("full", "nopt", "statwin", "nomm", "mmonly")
V10_PROBE_MODES = ("full", "norotate", "nobcast", "noonehot", "nomatmul")
V12_ABLATE_MODES = ("full", "nomatmul", "norotate", "nomask", "floor")
V12_MODE = CE.QUAD_MODES[12]
ROW_FORMS = {"a": 0, "b": 1, "c": 2}     # build_a, build_b, build_c
# The row gather's geometry, chosen by measurement on the card (``python3
# -m zxc_tpu_torch.row_gather_sweep`` for forms a and c, ``python3 -m
# zxc_tpu_torch.gather_ab`` for b; PERF.md, P6): output rows a CTA (form
# b: warps a CTA, a warp a row) and stages a CTA at the probe's shape,
# the largest piece of a row one bulk copy moves on 48,000-byte rows.
ROWS_PER_CTA = {"a": 1, "b": 8, "c": 2}
STAGES = {"a": 1, "c": 2}
STAGE_BYTES = 8192
# The grid gather's geometry (``grid_plan``; ``csrc/gather.cu``): the
# cluster form's CTAs of 1024 threads, 16 index columns a thread at a time,
# clusters of at most 8 CTAs, each holding at most 200 KiB of its row,
# where the index reads each row element GRID_CLUSTER_READS times or more;
# the L2 form's CTAs of 64-512 threads (kGridL2Cols = 16 columns a thread
# a pass), about one CTA an SM. Set by measurement on the card (``python3
# -m zxc_tpu_torch.gather_ab``; PERF.md, P6).
GRID_THREADS = 1024
GRID_COLS = 16
GRID_L2_THREADS = (64, 128, 256, 512)
GRID_L2_COLS = 16
GRID_MAX_CLUSTER = 8
GRID_MAX_SLICE = 200 << 10
GRID_CLUSTER_READS = 4


# -- quad probes: tpu_v13_bisect.py, tpu_v12_ablate2.py ----------------------

def _quad_launch(name: str, args, mode: CE.QuadMode, entry: str, tail):
    """Checks a v12-packed group for ``mode`` and launches ``entry`` with
    the words ``tail(RLP)`` after (B, NT, MAXQ, G32), then the cluster size
    of ``copy_engine.tile_plan``; returns (B, NT*32, 128) uint8."""
    B, NT, MAXQ, G32, RLP = CE._dims(*args, 1, mode)
    if B > 65535:
        raise ValueError(f"{name}: B {B} is over 65535")
    C = CE.cluster_size(B, NT, mode.rows, args[0].device)
    return CE._launch(entry, args, B, NT * mode.rows,
                      (B, NT, MAXQ, G32) + tail(RLP) + (C,))


def v13_bisect_reference(qs, qbase, pctrl, tq, lit8, shifted: bool,
                         paired: bool) -> torch.Tensor:
    """Plain version of ``tpu_v13_bisect.make_body(shifted, paired)``: v13
    when ``paired``, else v12 (quad mode 12); ``shifted`` computes the
    same function."""
    if paired:
        return CE.v13_reference(qs, qbase, pctrl, tq, lit8)
    return CE.quad_reference(qs, qbase, pctrl, tq, lit8, mode=12)


def v13_bisect(qs, qbase, pctrl, tq, lit8, shifted: bool,
               paired: bool) -> torch.Tensor:
    """``tpu_v13_bisect``'s body over one v12-packed group (int32 tq,
    32-row tiles): the copy engine's v13 (``paired``) or mode-12 kernel
    for CUDA tensors, the plain version for CPU tensors."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not CE._on_card("v13_bisect", qs):
        return v13_bisect_reference(*args, shifted, paired)
    if paired:
        out = _quad_launch("v13_bisect", args, CE.V13_MODE,
                           "zxc_copy_engine_v13", lambda rlp: (rlp,))
    else:
        out = _quad_launch("v13_bisect", args, V12_MODE,
                           "zxc_copy_engine_quad", lambda rlp: (1, rlp, 12))
    v13_bisect.launches += 1
    return out


def _ablation(mode: str):
    if mode not in V12_ABLATE2_MODES:
        raise ValueError(f"v12_ablate2 mode {mode}: one of "
                         f"{V12_ABLATE2_MODES}")
    return None if mode == "full" else mode


def v12_ablate2_reference(qs, qbase, pctrl, tq, lit8,
                          mode: str) -> torch.Tensor:
    """Plain version of ``tpu_v12_ablate2.make_body(mode)`` on any device
    (``copy_engine._reference`` with the ablation)."""
    return CE._reference(qs, qbase, pctrl, tq, lit8, 1, mode=V12_MODE,
                         ablate=_ablation(mode))


def v12_ablate2(qs, qbase, pctrl, tq, lit8, mode: str) -> torch.Tensor:
    """``tpu_v12_ablate2``'s body in ``mode`` over one v12-packed group:
    the copy engine's mode-12 tile routine with the ablation compiled in
    for CUDA tensors, the plain version for CPU tensors. Returns
    (B, NT*32, 128) uint8."""
    ablate = _ablation(mode)
    args = (qs, qbase, pctrl, tq, lit8)
    if not CE._on_card("v12_ablate2", qs):
        return v12_ablate2_reference(*args, mode)
    if ablate is None:
        out = _quad_launch("v12_ablate2", args, V12_MODE,
                           "zxc_copy_engine_quad", lambda rlp: (1, rlp, 12))
    else:
        out = _quad_launch("v12_ablate2", args, V12_MODE,
                           "zxc_copy_engine_quad_ablate",
                           lambda rlp: (rlp, CE.QUAD_ABLATIONS[ablate]))
    v12_ablate2.launches += 1
    return out


# -- lane probes: tpu_v10_probe.py, tpu_v12_ablate.py ------------------------

def lane_probe_kind(name: str, mode: str, lit8):
    """The lane-sum probe (``attic.LANE_PROBES``; None for full) of
    ``name``'s ``mode``; checks the mode and nomatmul's 128 literal
    rows."""
    modes = V10_PROBE_MODES if name == "v10_probe" else V12_ABLATE_MODES
    if mode not in modes:
        raise ValueError(f"{name} mode {mode}: one of {modes}")
    probe = None if mode == "full" else mode
    if name == "v12_ablate" and mode == "norotate":
        probe = "norotate_add"
    if probe == "nomatmul" and lit8.shape[1] < 128:
        raise ValueError(f"{name} nomatmul reads literal rows 0-127; the "
                         f"group has {lit8.shape[1]}")
    return probe


def lane_probe_reference(name: str, ts, pctrl, lit8,
                         mode: str) -> torch.Tensor:
    """Plain version of ``v10_probe`` or ``v12_ablate`` (``name``) on any
    device: (B, NT*32, 128) uint8."""
    probe = lane_probe_kind(name, mode, lit8)
    block = (ts.shape[1] - 1) * attic.TILE
    return attic.lane_sum_reference(pctrl, lit8, block, 10, ts=ts,
                                    probe=probe).view(len(pctrl), -1, 128)


def _lane_run(name: str, fn, ts, pctrl, lit8, mode: str) -> torch.Tensor:
    """``name``'s body in ``mode`` over one v10-packed group: the lane
    sum or its probe kernel for CUDA tensors, the plain version for CPU
    tensors; (B, NT*32, 128) uint8."""
    probe = lane_probe_kind(name, mode, lit8)
    if pctrl.device.type == "cpu":
        return lane_probe_reference(name, ts, pctrl, lit8, mode)
    if pctrl.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {pctrl.device}")
    block = (ts.shape[1] - 1) * attic.TILE
    attic._check_lane(pctrl, lit8, block, 10, ts, None, 0)
    attic._launchable(name, (ts, pctrl, lit8), pctrl.shape[0])
    from . import _build
    B = pctrl.shape[0]
    out = torch.empty((B, block // 128, 128), dtype=torch.uint8,
                      device=pctrl.device)
    L = _build.attic_kernels()
    with torch.cuda.device(pctrl.device):
        if probe is None:
            attic._launch("zxc_lane_sum", L.zxc_lane_sum, ts.data_ptr(), 0,
                          0, pctrl.data_ptr(), pctrl.shape[1],
                          lit8.data_ptr(), lit8.shape[1], out.data_ptr(), B,
                          block, 10, 0)
        else:
            attic._launch("zxc_lane_sum_probe", L.zxc_lane_sum_probe,
                          ts.data_ptr(), pctrl.data_ptr(), pctrl.shape[1],
                          lit8.data_ptr(), lit8.shape[1], out.data_ptr(), B,
                          block, attic.LANE_PROBES[probe])
    fn.launches += 1
    return out


def v10_probe(ts, pctrl, lit8, mode: str) -> torch.Tensor:
    """``tpu_v10_probe``'s body in ``mode`` (``V10_PROBE_MODES``) over one
    ``attic.pack_blocks_v10`` group (ts, pctrl, lit8): the lane-sum kernel
    for CUDA tensors, the plain version for CPU tensors. Returns
    (B, NT*32, 128) uint8."""
    return _lane_run("v10_probe", v10_probe, ts, pctrl, lit8, mode)


def v12_ablate(ts, pctrl, lit8, mode: str) -> torch.Tensor:
    """``tpu_v12_ablate``'s body in ``mode`` (``V12_ABLATE_MODES``; its
    norotate adds the roll amount) over one ``attic.pack_blocks_v10``
    group: as ``v10_probe``."""
    return _lane_run("v12_ablate", v12_ablate, ts, pctrl, lit8, mode)


# -- gathers: tpu_pallas_gather_probe.py, tpu_indirect_dma_probe.py ----------

def _check_gather(x, idx) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype not in (torch.int32,
                                                          torch.uint8):
        raise TypeError("x must be an int32 or uint8 tensor")
    if (not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32
            or idx.device != x.device):
        raise TypeError(f"idx must be an int32 tensor on {x.device}")
    if x.dim() != 2 or idx.dim() != 2 or idx.shape[0] != x.shape[0]:
        raise ValueError(f"gather shapes: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}")


def gather_axis1_reference(x, idx) -> torch.Tensor:
    """``out[i, j] = x[i, idx[i, j]]`` on any device, 0 for an index
    outside the row: ``torch.gather`` on the clamped index."""
    _check_gather(x, idx)
    ok = (idx >= 0) & (idx < x.shape[1])
    if x.shape[1] == 0:
        return torch.zeros(idx.shape, dtype=x.dtype, device=x.device)
    got = torch.gather(x, 1, idx.long().clamp(0, x.shape[1] - 1))
    return torch.where(ok, got, 0).to(x.dtype)


def _gather_operands(name: str, x, idx) -> None:
    _check_gather(x, idx)
    for t in (x, idx):
        if not t.is_contiguous():
            raise ValueError(f"{name} operands must be contiguous")


class GridPlan(NamedTuple):
    """The launch geometry of the grid gather ``zxc_gather_grid`` takes.
    ``form`` "cluster": each row i has ``clusters`` clusters of ``K``
    CTAs of ``threads`` = 1024; CTA rank r of a cluster holds elements [r
    * slice, (r + 1) * slice) of row i in ``smem`` bytes of shared memory,
    and every CTA of cluster c takes index columns [c * cols, (c + 1) *
    cols), writing the outputs whose element it holds. ``form`` "l2":
    ``clusters`` CTAs of ``threads`` a row, ``cols`` columns each in
    passes of threads * 16, the row read through L1 and L2 (K 1, slice
    and smem 0), with 16-byte index loads and output stores where
    ``vec``."""
    M: int
    N: int
    NI: int
    esize: int
    form: str
    K: int
    clusters: int
    slice: int
    cols: int
    vec: bool
    smem: int
    threads: int


def grid_plan(M: int, N: int, NI: int, esize: int, aligned: bool = True,
              sms: int = 132) -> GridPlan:
    """The grid gather's geometry for x (M, N) of ``esize``-byte elements
    and idx (M, NI). The cluster form where the row fits the shared memory
    of a cluster of at most 8 CTAs and the index reads each row element
    ``GRID_CLUSTER_READS`` times or more (NI >= 4 N), with enough clusters
    a row to fill ``sms`` SMs (one CTA of 1024 threads an SM) and at least
    one pass of the CTA's threads each: the fill of the row's slices pays
    only over many reads. Else the L2 form, about one CTA an SM: ``sms //
    M`` CTAs a row (at least one), each a contiguous run of the row's
    columns, so that its table reads stay within one row and hit the SM's
    L1; the widest CTA (512 threads at most) whose pass of 16 columns a
    thread fits the run, 64 threads at least. 16-byte access where
    ``aligned`` (the index and output rows start on 16 bytes) and NI is a
    multiple of 16 / esize."""
    v = 16 // esize
    K = 1
    while K <= GRID_MAX_CLUSTER and -(-N // K) * esize > GRID_MAX_SLICE:
        K *= 2
    if 0 < N and K <= GRID_MAX_CLUSTER and NI >= GRID_CLUSTER_READS * N:
        slice_ = -(-(-(-N // K)) // v) * v
        clusters = max(1, min(sms // max(1, M * K),
                              -(-NI // (GRID_THREADS * GRID_COLS))))
        return GridPlan(M, N, NI, esize, "cluster", K, clusters, slice_,
                        -(-NI // clusters), False, slice_ * esize,
                        GRID_THREADS)
    run = -(-NI // max(1, sms // max(1, M)))
    threads = max([t for t in GRID_L2_THREADS if t * GRID_L2_COLS <= run],
                  default=GRID_L2_THREADS[0])
    return l2_plan(M, N, NI, esize, aligned, threads,
                   -(-run // (threads * GRID_L2_COLS)))


def l2_plan(M: int, N: int, NI: int, esize: int, aligned: bool,
            threads: int, passes: int) -> GridPlan:
    """The L2 form: CTAs of ``threads``, each ``passes`` passes of
    ``threads * GRID_L2_COLS`` columns of a row."""
    cols = threads * GRID_L2_COLS * max(1, passes)
    return GridPlan(M, N, NI, esize, "l2", 1, max(1, -(-NI // cols)), 0,
                    cols, aligned and NI % (16 // esize) == 0, 0, threads)


def _launch_grid(x, idx, out, plan: GridPlan,
                 name: str = "gather_grid") -> None:
    from . import _build
    with torch.cuda.device(x.device):
        attic._launch(name, _build.gather_kernels().zxc_gather_grid,
                      x.data_ptr(), idx.data_ptr(), out.data_ptr(), plan.M,
                      plan.N, plan.NI, plan.esize,
                      int(plan.form == "cluster"), plan.K, plan.clusters,
                      plan.slice, plan.cols, int(plan.vec), plan.smem,
                      plan.threads)


def gather_grid_plan(x, idx, out) -> GridPlan:
    """``grid_plan`` of CUDA operands as ``gather_axis1`` and
    ``gather_grid`` launch them."""
    (M, N), NI = x.shape, idx.shape[1]
    aligned = idx.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return grid_plan(M, N, NI, x.element_size(), aligned, sms)


def _grid_gather(name: str, x, idx) -> torch.Tensor:
    """The grid gather's kernels on CUDA operands, in ``grid_plan``'s
    geometry."""
    _gather_operands(name, x, idx)
    out = torch.empty(idx.shape, dtype=x.dtype, device=x.device)
    _launch_grid(x, idx, out, gather_grid_plan(x, idx, out), name)
    return out


def gather_axis1(x, idx) -> torch.Tensor:
    """``tpu_pallas_gather_probe.pallas_gather_axis1``: ``out[i, j] =
    x[i, idx[i, j]]`` for x (M, N) int32 or uint8 and idx (M, NI) int32;
    the grid gather's kernels (``grid_plan``) for CUDA tensors, counted
    here and not in ``gather_grid``; the plain version for CPU tensors."""
    if not CE._on_card("gather_axis1", x):
        return gather_axis1_reference(x, idx)
    out = _grid_gather("gather_axis1", x, idx)
    gather_axis1.launches += 1
    return out


def gather_grid(x, idx, tile: int) -> torch.Tensor:
    """``tpu_pallas_gather_probe.pallas_gather_grid``: ``gather_axis1``'s
    function; NI must be a multiple of ``tile``, which the card's schedule
    (``grid_plan``) does not otherwise follow. The CUDA kernels for CUDA
    tensors, the plain version for CPU tensors."""
    _check_gather(x, idx)
    if tile < 1 or idx.shape[1] % tile:
        raise ValueError(f"gather_grid: tile {tile} does not divide the "
                         f"{idx.shape[1]} index columns")
    if not CE._on_card("gather_grid", x):
        return gather_axis1_reference(x, idx)
    out = _grid_gather("gather_grid", x, idx)
    gather_grid.launches += 1
    return out


def _check_rows(table, idx) -> None:
    if (not isinstance(table, torch.Tensor) or table.dtype != torch.int32
            or table.dim() != 2):
        raise TypeError("table must be a 2-d int32 tensor")
    if (not isinstance(idx, torch.Tensor) or idx.dtype != torch.int32
            or idx.dim() != 1 or idx.device != table.device):
        raise TypeError(f"idx must be a 1-d int32 tensor on {table.device}")


def gather_rows_reference(table, idx) -> torch.Tensor:
    """``out[i] = table[idx[i]]`` on any device, a row of 0 for an index
    outside the table: ``torch.index_select`` on the clamped index."""
    _check_rows(table, idx)
    ok = (idx >= 0) & (idx < table.shape[0])
    if table.shape[0] == 0:
        return torch.zeros((len(idx), table.shape[1]), dtype=table.dtype,
                           device=table.device)
    got = torch.index_select(table, 0, idx.long().clamp(0, len(table) - 1))
    return torch.where(ok[:, None], got, 0).to(table.dtype)


class RowPlan(NamedTuple):
    """The launch geometry of the row gather ``zxc_gather_rows`` takes:
    ``grid`` CTAs, each copying output rows ``[k * rows_per_cta, (k + 1)
    * rows_per_cta)`` of the G rows. Forms a and c: a row of C words in
    pieces of at most ``piece`` words, each through one of ``stages``
    shared-memory stages when ``bulk``, else by the CTA's threads with
    plain loads; ``smem`` bytes of dynamic shared memory. Form b: a warp
    a row (``rows_per_cta`` warps a CTA), ``piece`` C, no stage and no
    shared memory; ``bulk`` there means 16-byte loads and stores a
    lane."""
    G: int
    C: int
    grid: int
    rows_per_cta: int
    piece: int
    stages: int
    bulk: bool
    smem: int


def _row_plan(G: int, C: int, aligned: bool, rows_per_cta: int,
              stages: int, stage_bytes: int) -> RowPlan:
    """Forms a and c at the given geometry (``row_gather_sweep`` tries
    others than the constants)."""
    bulk = aligned and C % 4 == 0
    piece = min(C, stage_bytes // 16 * 4)
    head = -(-(8 * stages + 4 * rows_per_cta) // 128) * 128
    return RowPlan(G, C, -(-G // rows_per_cta), rows_per_cta, piece,
                   stages, bulk, head + (4 * piece * stages if bulk else 0))


def warp_row_plan(G: int, C: int, aligned: bool,
                  warps: int) -> RowPlan:
    """Form b at ``warps`` rows a CTA (``gather_ab`` sweeps them): 16-byte
    copies where the table and the output start on 16 bytes and C % 4 ==
    0, else 4-byte copies, in the same kernel."""
    return RowPlan(G, C, -(-G // warps), warps, C, 0,
                   aligned and C % 4 == 0, 0)


def row_plan(G: int, C: int, form: str, aligned: bool = True) -> RowPlan:
    """The geometry of a row gather of G rows of C int32 words in ``form``;
    ``aligned``: the table and the output start on 16 bytes. Forms a and c
    copy rows by bulk copies only when every row is 16-byte aligned and a
    multiple of 16 bytes, else by the kernel's edge path; form b copies 16
    bytes a lane under the same condition, else 4."""
    if form not in ROW_FORMS:
        raise ValueError(f"row gather form {form}: a, b or c")
    if form == "b":
        return warp_row_plan(G, C, aligned, ROWS_PER_CTA["b"])
    return _row_plan(G, C, aligned, ROWS_PER_CTA[form], STAGES[form],
                     STAGE_BYTES)


def _launch_rows(table, idx, out, form: str, plan: RowPlan) -> None:
    from . import _build
    with torch.cuda.device(table.device):
        attic._launch("zxc_gather_rows", _build.gather_kernels()
                      .zxc_gather_rows, table.data_ptr(), len(table),
                      plan.C, idx.data_ptr(), plan.G, out.data_ptr(),
                      ROW_FORMS[form], plan.grid, plan.rows_per_cta,
                      plan.piece, plan.stages, int(plan.bulk), plan.smem)


def gather_rows(table, idx, form: str) -> torch.Tensor:
    """``tpu_indirect_dma_probe``'s row gather in ``form`` "a" (one row
    at a time a CTA), "b" (all rows at once, a warp a row) or "c" (rows
    pipelined a CTA), over the grid of ``row_plan``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. The launch counts in
    ``dma_a``, ``dma_b`` or ``dma_c``."""
    if form not in ROW_FORMS:
        raise ValueError(f"row gather form {form}: a, b or c")
    if not CE._on_card("gather_rows", table):
        return gather_rows_reference(table, idx)
    _check_rows(table, idx)
    for t in (table, idx):
        if not t.is_contiguous():
            raise ValueError("gather_rows operands must be contiguous")
    G, C = len(idx), table.shape[1]
    out = torch.empty((G, C), dtype=table.dtype, device=table.device)
    aligned = table.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    _launch_rows(table, idx, out, form, row_plan(G, C, form, aligned))
    ROW_ENTRIES[form].launches += 1
    return out


def dma_a(table, idx) -> torch.Tensor:
    """``build_a``: one bulk row copy after another, a CTA."""
    return gather_rows(table, idx, "a")


def dma_b(table, idx) -> torch.Tensor:
    """``build_b``: one indirect DMA of every row; a warp a row."""
    return gather_rows(table, idx, "b")


def dma_c(table, idx) -> torch.Tensor:
    """``build_c``: bulk row copies pipelined through a ring of stages, a
    CTA."""
    return gather_rows(table, idx, "c")


ROW_ENTRIES = {"a": dma_a, "b": dma_b, "c": dma_c}

KERNELS = {"v13_bisect": v13_bisect, "v12_ablate2": v12_ablate2,
           "v10_probe": v10_probe, "v12_ablate": v12_ablate,
           "gather_axis1": gather_axis1, "gather_grid": gather_grid,
           "dma_a": dma_a, "dma_b": dma_b, "dma_c": dma_c}
for _k in KERNELS.values():
    _k.launches = 0


def gather_bytes_moved(x, idx) -> int:
    """The bytes a row-wise gather must move: the index and the output
    once, and each distinct table element the index reaches once."""
    x, idx = (np.asarray(a.cpu()) if isinstance(a, torch.Tensor)
              else np.asarray(a) for a in (x, idx))
    M, N = x.shape
    i = idx.astype(np.int64)
    ok = (i >= 0) & (i < N)
    flat = (np.arange(M)[:, None] * N + i)[ok]
    return (idx.nbytes + idx.size * x.itemsize
            + len(np.unique(flat)) * x.itemsize)


def rows_bytes_moved(table, idx) -> int:
    """The bytes a row gather must move: the index, the output rows once
    and each distinct table row the index reaches once."""
    table, idx = (np.asarray(a.cpu()) if isinstance(a, torch.Tensor)
                  else np.asarray(a) for a in (table, idx))
    i = idx.astype(np.int64)
    distinct = len(np.unique(i[(i >= 0) & (i < len(table))]))
    row = table.shape[1] * table.itemsize
    return idx.nbytes + len(idx) * row + distinct * row
