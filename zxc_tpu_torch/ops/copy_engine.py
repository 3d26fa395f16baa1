"""Copy-engine decode kernels v19, v25, v26, v27, v13 and the attic's
quad-tile generations (``quad``, modes 12, 14-17, 20, 21, 23, 24):
wrappers, plain versions and launch counters.

Replaces ``zxc_tpu/ops/pallas_decode.py``: ``_make_kernel_v19`` /
``v19_kernel``, ``_make_kernel_v25`` / ``v25_kernel``, ``_make_kernel_v26``
/ ``v26_kernel``, ``_make_kernel_v27`` / ``v27_kernel`` and ``_kernel_v13``
/ ``v13_kernel``; and
``tools/kernel_attic.py``: ``v12_kernel``, ``v14_kernel``, ``v15_kernel``,
``v16_kernel``, ``v17_kernel``, ``v20_kernel``, ``v21_kernel``,
``v23_kernel`` and ``v24_kernel``. The Pallas kernels reach their function
through one-hot MXU matmuls and bf16 (v17: int8, v24: f32) byte carriers
because gathers are slow on a TPU; the Hopper kernels
(``csrc/copy_engine.cu``) do indexed byte loads and shared-memory adds
instead. The function, for block b and tile t of ``R`` rows (R = 128; 32
for v13, v12 and v14):

* an (R,128) int32 tile starts at 0 and runs the quads of
  ``[qs[b,t], qs[b,t+1])`` that the body's loop reaches: ``QuadMode.floor``
  f runs ``f * floor((q1 - q0) / f)`` quads from q0 (pairs for v19, v26,
  v27 and v13: an odd trailing quad is skipped), v14 then one at a time up
  to q1, and v20 runs the pairs of ``[qs[b,2t], qs[b,2t+1])`` with plane 0
  only and those of ``[qs[b,2t+1], qs[b,2t+2])`` with all K planes;
* slot i of quad q reads plane j's control word
  ``w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127]``,
  ``bat = 4q + (i>>5)`` (v23: row ``(bat>>7)*32K + 32j + (i&31)``; one
  plane for v13 and v12-v17); its source row is ``qbase[b,q] + (w_0 >>>
  21)`` and its target row ``tq[b,q,i]`` (uint8 for v19, v26, v27, v21, v23
  and v24; int32 for the rest);
* lane l is covered by plane j when ``((w_j>>7)&127) <= l <= ((w_j>>14)&127)``;
  the roll is the highest covering plane's ``w_j & 127`` and a covered lane
  adds ``win[src, (l + roll) & 127]`` into ``tile[tgt, l]``;
* the tile is stored to output rows ``t*R .. t*R+R-1`` mod 256.

v19's, v13's and the attic modes' window is ``lit8[b]``. v26's window is
``lit8[b]`` followed by the block's own output rows, each of which reads 0
until its supertile has been stored. v27 is v26 whose rows ``r < RLP`` are
``flat[loff[b] + r]`` of one ragged lit buffer per group (a row outside
``[0, ROWS_TOT)``, or any row of a block with ``loff[b] < 0``, reads 0).
v25 chooses the window per quad: ``lit8[b]``, or, for a quad whose
``qbase`` is at least ``OUT_QB_FLAG``, the block's own output at row
``qbase - OUT_QB_FLAG`` plus the slot's row, which reads 0 until its
supertile has been stored (the JAX kernel reads what its output buffer
holds there; no packed plan reads such a row). ``_reference`` also states
the ablations of v12's body that ``probes.v12_ablate2`` runs
(``QUAD_ABLATIONS``). A slot whose window-relative row exceeds 127, whose
source lies outside the window, whose target row lies outside the tile
or whose quad lies outside ``[0, MAXQ)`` adds nothing.

Bound on the card: the bytes each call must move (``bytes_moved``: ``qs``,
the live quads' control and the window rows their slots read, each read
once, and the uint8 output written once) over the H100's 3.35 TB/s; a
dispatch group of 16 x 64 KiB blocks moves a few MB, a microsecond or
two. The kernels are far from it: each slot is a chain of dependent
loads. The design keeps the tile in shared memory as int32 with atomic
adds (exact for any control) and lets a warp serve 32 slots at a time
with several source-row loads in flight. v19, v13 and the attic modes
run one tile on a cluster of ``tile_plan(...).C`` CTAs, each adding its
share of the tile's slots into its own tile before the cluster sums them
through distributed shared memory (C > 1 only where the grid leaves most
SMs idle). v25, v26 and v27 run one CTA per (supertile, block): each adds
its lit-row slots at once and waits on ready flags of its block's earlier
supertiles only for the slots that read the block's own output; see the
source for details.

On a CPU tensor a wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LANES = 128        # bytes per row
TILE_ROWS = 128    # rows per supertile (v19, v25, v26, v27)
V13_ROWS = 32      # rows per tile (v13)
OUT_QB_FLAG = 1 << 24   # v25: a quad whose qbase is at least this reads out
# tools/tpu_v12_ablate2.py's ablations of v12's quad body, as the C entry
# numbers them: nopt adds slot i into tile row i & 31 (no target permute);
# statwin reads window row w >>> 21 whatever qbase says; nomm reads lit8
# row qbase + i, adds the row field to each byte before the roll and rounds
# each masked value to bf16; mmonly adds the gathered row, not rolled or
# masked, into tile row i & 31
QUAD_ABLATIONS = {"nopt": 1, "statwin": 2, "nomm": 3, "mmonly": 4}


# The tile routine's launch geometry (``tile_plan``; ``csrc/copy_engine.cu``
# ``tiled_kernel``): 1024 threads a CTA, one CTA an SM. The kernel takes
# clusters of up to 8 CTAs a tile; the plan gives at most 4, chosen by
# measurement on the card (``python3 -m zxc_tpu_torch.copy_engine_ab``;
# PERF.md, P6): clusters of 8 full-SM CTAs launch and sync slower than
# their work gains, and a grid past one wave of the card loses.
TILE_THREADS = 1024
TILE_MAX_CLUSTER = 4


class TilePlan(NamedTuple):
    """The tile routine's launch geometry: a grid of (NT * C, B) CTAs of
    ``TILE_THREADS`` threads in clusters of C, one cluster a (tile, block).
    CTA rank r adds the items r, r + C, r + 2C, ... of its tile's walk
    (warp w starts at w * C + r and steps by 32 * C; an item is a quad's
    32-slot batch, or a half or quarter of it when the tile's items are
    fewer than the cluster's warps) into its own int32 tile of ``rows``
    rows, then sums rows [r * slice, (r + 1) * slice) over the cluster's C
    tiles and stores them."""
    B: int
    NT: int
    rows: int
    C: int
    slice: int


def tile_plan(B: int, NT: int, rows: int, sms: int = 132) -> TilePlan:
    """The tile routine's geometry for B blocks of NT tiles of ``rows``
    rows on a card of ``sms`` SMs (one CTA of 1024 threads an SM): the
    largest cluster C of 1, 2 or 4 CTAs that divides ``rows`` and keeps
    the B * NT * C CTAs within one wave of the card; 1 when the B * NT
    tiles alone fill half of it or more."""
    C = 1
    while (C < TILE_MAX_CLUSTER and rows % (2 * C) == 0
           and B * NT * 2 * C <= sms):
        C *= 2
    return TilePlan(B, NT, rows, C, rows // C)


def cluster_size(B: int, NT: int, rows: int, device, forced=None) -> int:
    """The cluster size a tile-routine launch takes: ``forced`` (tests and
    the sweep of ``copy_engine_ab``; the C entry refuses a bad one), else
    ``tile_plan``'s for ``device``'s SM count."""
    if forced is not None:
        return int(forced)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return tile_plan(B, NT, rows, sms).C


class QuadMode(NamedTuple):
    """How one generation of the tile routine walks and reads its control."""
    rows: int                  # tile rows: 128, or 32 (v13, v12, v14)
    floor: int                 # a range runs floor * (its count // floor)
    tq: torch.dtype            # target rows' type
    multi: bool = False        # reads K planes (else one)
    epilogue: bool = False     # v14: then one quad at a time to its end
    split: bool = False        # v20: plane-0 range, then K-plane range
    interleaved: bool = False  # v23: plane j at (bat>>7)*32K + 32j + sub


V19_MODE = QuadMode(TILE_ROWS, 2, torch.uint8, multi=True)
V13_MODE = QuadMode(V13_ROWS, 2, torch.int32)
# the attic's generations (tools/kernel_attic.py); 17 is 15's function
# mod 256, 21 and 24 are v19's
QUAD_MODES = {
    12: QuadMode(V13_ROWS, 1, torch.int32),
    14: QuadMode(V13_ROWS, 4, torch.int32, epilogue=True),
    15: QuadMode(TILE_ROWS, 2, torch.int32),
    16: QuadMode(TILE_ROWS, 4, torch.int32),
    17: QuadMode(TILE_ROWS, 2, torch.int32),
    20: QuadMode(TILE_ROWS, 2, torch.int32, multi=True, split=True),
    21: V19_MODE,
    23: V19_MODE._replace(interleaved=True),
    24: V19_MODE,
}


def _ctrl_dims(qs, qbase, pctrl, tq, K: int, mode: QuadMode = V19_MODE):
    """Validate one dispatch group's control for ``mode`` (``K`` planes);
    returns (B, NT, MAXQ, G32)."""
    want = ((qs, torch.int32, 2), (qbase, torch.int32, 2),
            (pctrl, torch.int32, 3), (tq, mode.tq, 3))
    for name, (t, dt, nd) in zip(("qs", "qbase", "pctrl", "tq"), want):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != qs.device:
            raise ValueError(f"{name} is on {t.device}, qs on {qs.device}")
    B = qs.shape[0]
    NT = (qs.shape[1] - 1) // 2 if mode.split else qs.shape[1] - 1
    MAXQ = qbase.shape[1]
    if (NT < 0 or K < 1 or pctrl.shape[1] % K
            or (mode.split and qs.shape[1] % 2 == 0)):
        raise ValueError(f"bad qs {tuple(qs.shape)} / pctrl "
                         f"{tuple(pctrl.shape)} for K={K}")
    G32 = pctrl.shape[1] // K
    if (qbase.shape[0] != B or pctrl.shape[0] != B or pctrl.shape[2] != LANES
            or tuple(tq.shape) != (B, MAXQ, LANES)
            or G32 < 32 * -(-4 * MAXQ // 128)):
        raise ValueError("inconsistent copy-engine shapes: qs "
                         f"{tuple(qs.shape)}, qbase {tuple(qbase.shape)}, "
                         f"pctrl {tuple(pctrl.shape)}, tq {tuple(tq.shape)}")
    return B, NT, MAXQ, G32


def _dims(qs, qbase, pctrl, tq, lit8, K: int, mode: QuadMode = V19_MODE):
    """Validate one dispatch group; returns (B, NT, MAXQ, G32, RLP)."""
    B, NT, MAXQ, G32 = _ctrl_dims(qs, qbase, pctrl, tq, K, mode)
    if (not isinstance(lit8, torch.Tensor) or lit8.dtype != torch.uint8
            or lit8.dim() != 3):
        raise TypeError(f"lit8 must be a 3-d {torch.uint8} tensor")
    if lit8.device != qs.device:
        raise ValueError(f"lit8 is on {lit8.device}, qs on {qs.device}")
    if tuple(lit8.shape[::2]) != (B, LANES):
        raise ValueError(f"inconsistent copy-engine shapes: lit8 "
                         f"{tuple(lit8.shape)} for B={B}")
    return B, NT, MAXQ, G32, lit8.shape[1]


def _flat_dims(qs, loff, flat, RLP: int):
    """Validate v27's shipping layout: loff (B,) int32, flat (ROWS_TOT,
    128) uint8 on qs's device, RLP >= 1."""
    for name, t, dt, nd in (("loff", loff, torch.int32, 1),
                            ("flat", flat, torch.uint8, 2)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != qs.device:
            raise ValueError(f"{name} is on {t.device}, qs on {qs.device}")
    if loff.shape[0] != qs.shape[0] or flat.shape[1] != LANES or RLP < 1:
        raise ValueError(f"bad v27 layout: loff {tuple(loff.shape)}, flat "
                         f"{tuple(flat.shape)}, RLP {RLP} for "
                         f"B={qs.shape[0]}")


def quad_ranges(qs, t: int, mode: QuadMode, K: int):
    """The quad ranges tile ``t`` of each block runs: [(lo, hi, planes)]
    with int64 (B,) bounds (before the clip to [0, MAXQ)), as the body's
    loops walk them."""
    c = qs.long()
    if mode.split:           # v20: pairs of [q0, qm) on plane 0, [qm, q1)
        q0, qm, q1 = c[:, 2 * t], c[:, 2 * t + 1], c[:, 2 * t + 2]
        return [(q0, q0 + 2 * ((qm - q0) >> 1).clamp(min=0), 1),
                (qm, qm + 2 * ((q1 - qm) >> 1).clamp(min=0), K)]
    q0, q1 = c[:, t], c[:, t + 1]
    n = torch.div(q1 - q0, mode.floor, rounding_mode="floor")
    planes = K if mode.multi else 1
    if mode.epilogue:        # v14: fours, then ones from q0 + 4n to q1
        return [(q0 + mode.floor * n.clamp(max=0), q1, planes)]
    return [(q0, q0 + mode.floor * n.clamp(min=0), planes)]


def _bf16_round(v: torch.Tensor) -> torch.Tensor:
    """Integers rounded to bf16, nearest even (exact below 2^8)."""
    return v.float().to(torch.bfloat16).float().to(v.dtype)


def _reference(qs, qbase, pctrl, tq, lit8, K: int, window: str = "lit",
               mode: QuadMode = V19_MODE, ablate: str | None = None):
    """The copy engine's function: ``window`` "lit" (lit8), "self" (v26:
    lit8, then the block's output rows) or "quad" (v25: per quad);
    ``ablate`` one of ``QUAD_ABLATIONS`` (v12's one-plane walk)."""
    B, NT, MAXQ, G32, RLP = _dims(qs, qbase, pctrl, tq, lit8, K, mode)
    rows = mode.rows
    dev = qs.device
    NR = NT * rows
    out = torch.zeros((B, NR, LANES), dtype=torch.uint8, device=dev)
    lanes = torch.arange(LANES, device=dev)
    slot = torch.arange(128, device=dev)
    qidx = torch.arange(MAXQ, device=dev)
    win_rows = RLP if window == "lit" else RLP + NR
    for t in range(NT):
        # the window as the kernel sees it at supertile t: the output rows
        # not yet stored are still 0 in `out`
        win = lit8 if window == "lit" else torch.cat([lit8, out], dim=1)
        tile = torch.zeros(B * rows * LANES, dtype=torch.int32, device=dev)
        for lo, hi, nk in quad_ranges(qs, t, mode, K):
            bb, qq = ((qidx >= lo[:, None]) & (qidx < hi[:, None])).nonzero(
                as_tuple=True)
            if bb.numel() == 0:
                continue
            bat = 4 * qq[:, None] + (slot >> 5)                     # (n,128)
            planes = torch.arange(nk, device=dev)
            if mode.interleaved:
                prow = (((bat >> 7) * K)[..., None] + planes) * 32
            else:
                prow = planes * G32 + (32 * (bat >> 7))[..., None]
            w = pctrl[bb[:, None, None], prow + (slot & 31)[:, None],
                      (bat & 127)[:, :, None]].long()               # (n,128,nk)
            rowrel = (w[:, :, 0] >> 21) & 0x7FF                     # logical
            qb = qbase[bb, qq].long()[:, None]
            lo_w, hi_w = 0, win_rows
            if window == "quad":      # v25: a flagged quad reads out rows
                out_q = qb >= OUT_QB_FLAG
                qb = torch.where(out_q, qb - OUT_QB_FLAG + RLP, qb)
                lo_w = torch.where(out_q, RLP, 0)
                hi_w = torch.where(out_q, RLP + NR, RLP)
            if ablate == "statwin":
                qb = torch.zeros_like(qb)
            src = qb + (slot if ablate == "nomm" else rowrel)
            tgt = ((slot & 31).expand(len(qq), -1)
                   if ablate in ("nopt", "mmonly") else tq[bb, qq].long())
            valid = ((tgt >= 0) & (tgt < rows) & (src >= lo_w)
                     & (src < hi_w))
            if ablate != "nomm":
                valid &= rowrel < 128
            lo_l = ((w >> 7) & 127)[..., None]
            hi_l = ((w >> 14) & 127)[..., None]
            cov = (lo_l <= lanes) & (lanes <= hi_l)                 # (n,128,nk,128)
            roll = (w[:, :, 0] & 127)[..., None].expand(-1, -1, LANES)
            for j in range(1, nk):            # the highest covering plane
                roll = torch.where(cov[:, :, j], (w[:, :, j] & 127)[..., None],
                                   roll)
            if ablate == "mmonly":            # the gathered row as it is
                cov = torch.ones_like(cov)
                roll = torch.zeros_like(roll)
            keep = cov.any(dim=2) & valid[..., None]
            wrow = bb[:, None] * win.shape[1] + torch.where(valid, src, 0)
            idx = (wrow[..., None] * LANES + ((lanes + roll) & 127))
            val = win.reshape(-1)[idx].to(torch.int32)
            if ablate == "nomm":
                val = _bf16_round(val + rowrel[..., None].int())
            val = torch.where(keep, val, 0)
            tidx = ((bb[:, None] * rows + torch.where(valid, tgt, 0))[..., None]
                    * LANES + lanes)
            tile.index_add_(0, tidx.reshape(-1), val.reshape(-1))
        out[:, t * rows:(t + 1) * rows] = (
            tile.view(B, rows, LANES) & 255).to(torch.uint8)
    return out


def flat_windows(loff, flat, RLP: int) -> torch.Tensor:
    """v27's per-block windows as a (B, RLP, 128) lit8: row r of block b is
    ``flat[loff[b] + r]``, or 0 where that row lies outside the buffer or
    ``loff[b] < 0``."""
    rows = loff.long()[:, None] + torch.arange(RLP, device=flat.device)
    ok = (loff[:, None] >= 0) & (rows >= 0) & (rows < flat.shape[0])
    if flat.shape[0] == 0:
        return torch.zeros((loff.shape[0], RLP, LANES), dtype=torch.uint8,
                           device=flat.device)
    win = flat[rows.clamp(0, flat.shape[0] - 1)]
    return win * ok[..., None].to(torch.uint8)


def v19_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v19 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K)


def v25_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v25 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K, window="quad")


def v26_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v26 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K, window="self")


def v27_reference(qs, qbase, loff, pctrl, tq, flat, RLP: int,
                  K: int = 2) -> torch.Tensor:
    """Plain PyTorch v27 on any device: v26 over the windows that
    ``flat_windows`` cuts from the flat buffer. (B, NST*128, 128) uint8."""
    _flat_dims(qs, loff, flat, RLP)
    return _reference(qs, qbase, pctrl, tq, flat_windows(loff, flat, RLP),
                      K, window="self")


def v13_reference(qs, qbase, pctrl, tq, lit8) -> torch.Tensor:
    """Plain PyTorch v13 on any device: one plane, 32-row tiles, int32 tq.
    (B, NT*32, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, 1, mode=V13_MODE)


def _launch(entry: str, args, B: int, out_rows: int, ints,
            sync_words: int = 0) -> torch.Tensor:
    """Launch ``entry`` over the tensors ``args`` (each contiguous and
    16-byte aligned), a fresh (B, out_rows, 128) uint8 output, with
    ``sync_words`` a fresh int32 scratch of that many words after it (v25,
    v26, v27: the entry zeroes it on the stream), and the ints ``ints``,
    on the current stream."""
    from . import _build
    dev = args[0].device
    for t in args:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("copy-engine operands must be contiguous and "
                             "16-byte aligned")
    out = torch.empty((B, out_rows, LANES), dtype=torch.uint8, device=dev)
    scratch = ([torch.empty(sync_words, dtype=torch.int32, device=dev)]
               if sync_words else [])
    fn = getattr(_build.kernels(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (*args, out, *scratch)), *ints,
                stream)
    if rc:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out


def _on_card(name: str, qs) -> bool:
    """False for CPU tensors (the plain version runs); True for CUDA
    tensors; raises for any other device."""
    if qs.device.type == "cpu":
        return False
    if qs.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {qs.device}")
    return True


def v19(qs, qbase, pctrl, tq, lit8, K: int = 2, *,
        _cluster: int | None = None) -> torch.Tensor:
    """v19 copy engine over one dispatch group: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    (B, NST*128, 128) uint8. ``_cluster`` forces the cluster size (tests
    and sweeps only)."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v19", qs):
        return v19_reference(*args, K)
    B, NST, MAXQ, G32, RLP = _dims(*args, K)
    C = cluster_size(B, NST, TILE_ROWS, qs.device, _cluster)
    out = _launch("zxc_copy_engine_v19", args, B, NST * TILE_ROWS,
                  (B, NST, MAXQ, G32, K, RLP, C))
    v19.launches += 1
    return out


def v25(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """v25 copy engine (window chosen per quad by ``OUT_QB_FLAG``) over one
    dispatch group: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. Returns (B, NST*128, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v25", qs):
        return v25_reference(*args, K)
    B, NST, MAXQ, G32, RLP = _dims(*args, K)
    if RLP >= OUT_QB_FLAG:
        raise ValueError(f"v25: RLP {RLP} is not below OUT_QB_FLAG")
    out = _launch("zxc_copy_engine_v25", args, B, NST * TILE_ROWS,
                  (B, NST, MAXQ, G32, K, RLP), 1 + B * NST)
    v25.launches += 1
    return out


def v26(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """v26 copy engine (self-referential window) over one dispatch group:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (B, NST*128, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v26", qs):
        return v26_reference(*args, K)
    B, NST, MAXQ, G32, RLP = _dims(*args, K)
    out = _launch("zxc_copy_engine_v26", args, B, NST * TILE_ROWS,
                  (B, NST, MAXQ, G32, K, RLP), 1 + B * NST)
    v26.launches += 1
    return out


def v27(qs, qbase, loff, pctrl, tq, flat, RLP: int, K: int = 2):
    """v27 copy engine (v26 over one ragged flat lit buffer per group,
    block b's window at row ``loff[b]``): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    (B, NST*128, 128) uint8."""
    if not _on_card("v27", qs):
        return v27_reference(qs, qbase, loff, pctrl, tq, flat, RLP, K)
    B, NST, MAXQ, G32 = _ctrl_dims(qs, qbase, pctrl, tq, K)
    _flat_dims(qs, loff, flat, RLP)
    out = _launch("zxc_copy_engine_v27", (qs, qbase, loff, pctrl, tq, flat),
                  B, NST * TILE_ROWS,
                  (B, NST, MAXQ, G32, K, RLP, flat.shape[0]), 1 + B * NST)
    v27.launches += 1
    return out


def v13(qs, qbase, pctrl, tq, lit8, *,
        _cluster: int | None = None) -> torch.Tensor:
    """v13 copy engine (one op per slot, 32-row tiles) over one dispatch
    group: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (B, NT*32, 128) uint8. ``_cluster`` forces the
    cluster size (tests and sweeps only)."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v13", qs):
        return v13_reference(*args)
    B, NT, MAXQ, G32, RLP = _dims(*args, 1, V13_MODE)
    C = cluster_size(B, NT, V13_ROWS, qs.device, _cluster)
    out = _launch("zxc_copy_engine_v13", args, B, NT * V13_ROWS,
                  (B, NT, MAXQ, G32, RLP, C))
    v13.launches += 1
    return out


def _quad_mode(mode: int) -> QuadMode:
    if mode not in QUAD_MODES:
        raise ValueError(f"quad mode {mode}: one of {sorted(QUAD_MODES)}")
    return QUAD_MODES[mode]


def quad_reference(qs, qbase, pctrl, tq, lit8, mode: int,
                   K: int = 2) -> torch.Tensor:
    """Plain PyTorch version of the attic's quad-tile generation ``mode``
    on any device (``K`` planes for modes 20, 21, 23 and 24; modes 12-17
    read one): (B, NT*R, 128) uint8."""
    m = _quad_mode(mode)
    return _reference(qs, qbase, pctrl, tq, lit8, K if m.multi else 1,
                      mode=m)


def quad(qs, qbase, pctrl, tq, lit8, mode: int, K: int = 2) -> torch.Tensor:
    """The attic's quad-tile generation ``mode`` (``QUAD_MODES``) over one
    dispatch group: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. ``tq`` must have the mode's type (never converted); v20's
    ``qs`` is 2*NST+1 wide. Returns (B, NT*R, 128) uint8."""
    m = _quad_mode(mode)
    K = K if m.multi else 1
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("quad", qs):
        return quad_reference(*args, mode, K)
    B, NT, MAXQ, G32, RLP = _dims(*args, K, m)
    if B > 65535:
        raise ValueError(f"quad: B {B} is over 65535")
    out = _launch("zxc_copy_engine_quad", args, B, NT * m.rows,
                  (B, NT, MAXQ, G32, K, RLP, mode,
                   cluster_size(B, NT, m.rows, qs.device)))
    quad.launches += 1
    return out


v19.launches = 0
v25.launches = 0
v26.launches = 0
v27.launches = 0
v13.launches = 0
quad.launches = 0

KERNELS = {19: v19, 25: v25, 26: v26, 27: v27, 13: v13, "quad": quad}
REFERENCES = {19: v19_reference, 25: v25_reference, 26: v26_reference,
              27: v27_reference, 13: v13_reference, "quad": quad_reference}


def bytes_moved(qs, qbase, pctrl, tq, lit8, K: int = 2, *,
                rows: int = TILE_ROWS, loff=None, RLP: int | None = None,
                mode: int | None = None, ablate: str | None = None) -> int:
    """The bytes one call must move for this group's control, padding
    excluded: all of ``qs``; for each live quad (inside a range that a tile
    runs, below MAXQ) its ``qbase`` word, its 128 ``tq`` entries at their
    item size and the 128 ``pctrl`` words of each plane it reads; each
    distinct window row of ``lit8`` that a slot adding anything reads (v26's
    and v27's rows past RLP are the call's own output, not an input); and
    the (B, NT*rows, 128) uint8 output. v13: ``rows=32, K=1`` (int32
    ``tq``). v27: ``lit8`` is the flat buffer, with ``loff`` (whose B words
    count too) and ``RLP``. ``mode``: an attic generation of ``quad``
    (its rows, walk, split and layout; K planes only if it reads them).
    v25: a quad flagged with ``OUT_QB_FLAG`` reads rows past RLP, the
    call's own output, counted once as output; so the count holds the lit
    rows of the other quads. ``ablate`` (mode 12's walk): the rows and
    ``tq`` entries that ablation reads."""
    m = (_quad_mode(mode) if mode is not None
         else V13_MODE if rows == V13_ROWS else V19_MODE)
    K = K if m.multi else 1
    qs, qbase, pctrl, tq = (np.asarray(a.cpu()) if isinstance(a, torch.Tensor)
                            else np.asarray(a) for a in (qs, qbase, pctrl, tq))
    B = qs.shape[0]
    NT = (qs.shape[1] - 1) // 2 if m.split else qs.shape[1] - 1
    MAXQ = qbase.shape[1]
    G32 = pctrl.shape[1] // K
    flat = loff is not None
    if flat:
        loff = np.asarray(loff.cpu() if isinstance(loff, torch.Tensor)
                          else loff).astype(np.int64)
    else:
        RLP = lit8.shape[1]
    qidx = np.arange(MAXQ)
    planes = np.zeros((B, MAXQ), np.int64)      # planes a live quad reads
    qs_t = torch.from_numpy(np.ascontiguousarray(qs))
    for t in range(NT):
        for lo, hi, nk in quad_ranges(qs_t, t, m, K):
            planes[(qidx >= lo.numpy()[:, None])
                   & (qidx < hi.numpy()[:, None])] = nk
    slot = np.arange(128)
    control, read = 0, []
    for nk in np.unique(planes[planes > 0]):
        bb, qq = (planes == nk).nonzero()
        bat = 4 * qq[:, None] + (slot >> 5)                          # (n,128)
        j = np.arange(nk)
        prow = ((((bat >> 7) * K)[..., None] + j) * 32 if m.interleaved
                else j * G32 + (32 * (bat >> 7))[..., None])
        w = pctrl[bb[:, None, None], prow + (slot & 31)[:, None],
                  (bat & 127)[:, :, None]].astype(np.int64) & 0xFFFFFFFF
        rowrel = w[:, :, 0] >> 21
        qb = qbase[bb, qq].astype(np.int64)[:, None]
        src = ((0 if ablate == "statwin" else qb)
               + (slot if ablate == "nomm" else rowrel))
        own_tq = ablate not in ("nopt", "mmonly")
        tgt = tq[bb, qq].astype(np.int64) if own_tq else slot & 31
        adds = ((tgt >= 0) & (tgt < m.rows) & (src >= 0) & (src < RLP)
                & (ablate == "mmonly"
                   or (((w >> 7) & 127) <= ((w >> 14) & 127)).any(axis=2)))
        if ablate != "nomm":
            adds &= rowrel < 128
        if flat:   # rows of the shared flat buffer
            frow = loff[bb][:, None] + src
            adds &= ((loff[bb] >= 0)[:, None] & (frow >= 0)
                     & (frow < lit8.shape[0]))
            read.append(frow[adds])
        else:
            read.append((bb[:, None] * RLP + src)[adds])
        control += len(qq) * (4 * (ablate != "statwin") + nk * LANES * 4
                              + LANES * tq.itemsize * own_tq)
    n_rows = len(np.unique(np.concatenate(read))) if read else 0
    return (qs.nbytes + control + n_rows * LANES + (4 * B if flat else 0)
            + B * NT * m.rows * LANES)


def group_from_numpy(*arrays, device="cpu"):
    """One dispatch group's packed control, as made by the JAX package's
    packers or the native prep, to the port's tensors on ``device``, bit
    for bit: (qs, qbase, pctrl, tq, lit8) with int32 qs/qbase/pctrl, uint8
    tq (int32 for v13 and the int32 attic packers) and uint8 lit8; or v27's (qs, qbase, loff, pctrl,
    tq, flat) with int32 loff and uint8 flat."""
    if len(arrays) == 5:
        names = ("qs", "qbase", "pctrl", "tq", "lit8")
        want = ("i4", "i4", "i4", ("u1", "i4"), "u1")
    elif len(arrays) == 6:
        names = ("qs", "qbase", "loff", "pctrl", "tq", "flat")
        want = ("i4", "i4", "i4", "i4", "u1", "u1")
    else:
        raise TypeError(f"a group has 5 or 6 arrays, not {len(arrays)}")
    out = []
    for name, a, dt in zip(names, arrays, want):
        a = np.asarray(a)
        if a.dtype not in [np.dtype(d) for d in np.atleast_1d(dt)]:
            raise TypeError(f"{name} is {a.dtype}, the layout has {dt}")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)
