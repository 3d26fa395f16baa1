"""Copy-engine decode kernels v19, v26, v27 and v13: wrappers, plain
versions and launch counters.

Replaces ``zxc_tpu/ops/pallas_decode.py``: ``_make_kernel_v19`` /
``v19_kernel``, ``_make_kernel_v26`` / ``v26_kernel``, ``_make_kernel_v27``
/ ``v27_kernel`` and ``_kernel_v13`` / ``v13_kernel``. The Pallas kernels
reach their function through one-hot MXU matmuls and bf16 byte carriers
because gathers are slow on a TPU; the Hopper kernels
(``csrc/copy_engine.cu``) do indexed byte loads and shared-memory adds
instead. The function, for block b and tile t of ``R`` rows (R = 128 for
v19/v26/v27, 32 for v13):

* an (R,128) int32 tile starts at 0 and runs quads
  ``qs[b,t] .. qs[b,t] + 2*((qs[b,t+1]-qs[b,t]) >> 1) - 1`` (pair-unrolled:
  an odd trailing quad is skipped);
* slot i of quad q reads plane j's control word
  ``w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127]``,
  ``bat = 4q + (i>>5)`` (one plane for v13); its source row is
  ``qbase[b,q] + (w_0 >>> 21)`` and its target row ``tq[b,q,i]`` (uint8;
  int32 for v13);
* lane l is covered by plane j when ``((w_j>>7)&127) <= l <= ((w_j>>14)&127)``;
  the roll is the highest covering plane's ``w_j & 127`` and a covered lane
  adds ``win[src, (l + roll) & 127]`` into ``tile[tgt, l]``;
* the tile is stored to output rows ``t*R .. t*R+R-1`` mod 256.

v19's and v13's window is ``lit8[b]``. v26's window is ``lit8[b]`` followed
by the block's own output rows, each of which reads 0 until its supertile
has been stored. v27 is v26 whose rows ``r < RLP`` are
``flat[loff[b] + r]`` of one ragged lit buffer per group (a row outside
``[0, ROWS_TOT)``, or any row of a block with ``loff[b] < 0``, reads 0).
A slot whose window-relative row exceeds 127, whose source lies outside
the window or whose target row lies outside the tile adds nothing.

Bound on the card: the bytes each call must move (``bytes_moved``: ``qs``,
the live quads' control and the window rows their slots read, each read
once, and the uint8 output written once) over the H100's 3.35 TB/s; a
dispatch group of 16 x 64 KiB blocks moves a few MB, a microsecond or
two. The kernels are far from it: each slot is a
chain of dependent loads and v26/v27 have one CTA per block (16 CTAs on 132
SMs). The design keeps the tile in shared memory as int32 with atomic
adds (exact for any control) and lets one warp serve one slot with a
coalesced row load and register shuffles; see the source for details.

On a CPU tensor a wrapper runs the plain PyTorch version; on a CUDA
tensor it launches the kernel or raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

LANES = 128        # bytes per row
TILE_ROWS = 128    # rows per supertile (v19, v26, v27)
V13_ROWS = 32      # rows per tile (v13)


def _ctrl_dims(qs, qbase, pctrl, tq, K: int, rows: int = TILE_ROWS):
    """Validate one dispatch group's control; returns (B, NT, MAXQ,
    G32)."""
    tq_dt = torch.int32 if rows == V13_ROWS else torch.uint8
    want = ((qs, torch.int32, 2), (qbase, torch.int32, 2),
            (pctrl, torch.int32, 3), (tq, tq_dt, 3))
    for name, (t, dt, nd) in zip(("qs", "qbase", "pctrl", "tq"), want):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != qs.device:
            raise ValueError(f"{name} is on {t.device}, qs on {qs.device}")
    B = qs.shape[0]
    NT = qs.shape[1] - 1
    MAXQ = qbase.shape[1]
    if NT < 0 or K < 1 or pctrl.shape[1] % K:
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


def _dims(qs, qbase, pctrl, tq, lit8, K: int, rows: int = TILE_ROWS):
    """Validate one dispatch group; returns (B, NT, MAXQ, G32, RLP)."""
    B, NT, MAXQ, G32 = _ctrl_dims(qs, qbase, pctrl, tq, K, rows)
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


def _reference(qs, qbase, pctrl, tq, lit8, K: int, self_ref: bool,
               rows: int = TILE_ROWS):
    B, NT, MAXQ, G32, RLP = _dims(qs, qbase, pctrl, tq, lit8, K, rows)
    dev = qs.device
    NR = NT * rows
    out = torch.zeros((B, NR, LANES), dtype=torch.uint8, device=dev)
    lanes = torch.arange(LANES, device=dev)
    slot = torch.arange(128, device=dev)
    planes = torch.arange(K, device=dev)
    qidx = torch.arange(MAXQ, device=dev)
    pc = pctrl.reshape(B, K, G32, LANES)
    win_rows = RLP + NR if self_ref else RLP
    for t in range(NT):
        q0 = qs[:, t].long()
        qend = q0 + 2 * ((qs[:, t + 1].long() - q0) >> 1).clamp(min=0)
        bb, qq = ((qidx >= q0[:, None]) & (qidx < qend[:, None])).nonzero(
            as_tuple=True)
        if bb.numel() == 0:
            continue
        bat = 4 * qq[:, None] + (slot >> 5)                        # (n,128)
        w = pc[bb[:, None, None], planes,
               (32 * (bat >> 7) + (slot & 31))[:, :, None],
               (bat & 127)[:, :, None]].long()                     # (n,128,K)
        rowrel = (w[:, :, 0] >> 21) & 0x7FF                        # logical
        src = qbase[bb, qq].long()[:, None] + rowrel
        tgt = tq[bb, qq].long()
        valid = ((rowrel < 128) & (tgt >= 0) & (tgt < rows) & (src >= 0)
                 & (src < win_rows))
        lo = ((w >> 7) & 127)[..., None]
        hi = ((w >> 14) & 127)[..., None]
        cov = (lo <= lanes) & (lanes <= hi)                        # (n,128,K,128)
        roll = (w[:, :, 0] & 127)[..., None].expand(-1, -1, LANES)
        for j in range(1, K):                 # the highest covering plane
            roll = torch.where(cov[:, :, j], (w[:, :, j] & 127)[..., None],
                               roll)
        keep = cov.any(dim=2) & valid[..., None]
        # the window as the kernel sees it at supertile t: v26's output
        # rows not yet stored are still 0 in `out`
        win = torch.cat([lit8, out], dim=1) if self_ref else lit8
        wrow = bb[:, None] * win.shape[1] + torch.where(valid, src, 0)
        idx = (wrow[..., None] * LANES + ((lanes + roll) & 127))
        val = torch.where(keep, win.reshape(-1)[idx].to(torch.int32), 0)
        tile = torch.zeros(B * rows * LANES, dtype=torch.int32, device=dev)
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
    return _reference(qs, qbase, pctrl, tq, lit8, K, self_ref=False)


def v26_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v26 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K, self_ref=True)


def v27_reference(qs, qbase, loff, pctrl, tq, flat, RLP: int,
                  K: int = 2) -> torch.Tensor:
    """Plain PyTorch v27 on any device: v26 over the windows that
    ``flat_windows`` cuts from the flat buffer. (B, NST*128, 128) uint8."""
    _flat_dims(qs, loff, flat, RLP)
    return _reference(qs, qbase, pctrl, tq, flat_windows(loff, flat, RLP),
                      K, self_ref=True)


def v13_reference(qs, qbase, pctrl, tq, lit8) -> torch.Tensor:
    """Plain PyTorch v13 on any device: one plane, 32-row tiles, int32 tq.
    (B, NT*32, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, 1, self_ref=False,
                      rows=V13_ROWS)


def _launch(entry: str, args, B: int, out_rows: int, ints) -> torch.Tensor:
    """Launch ``entry`` over the tensors ``args`` (each contiguous and
    16-byte aligned), a fresh (B, out_rows, 128) uint8 output and the
    ints ``ints``, on the current stream."""
    from . import _build
    dev = args[0].device
    for t in args:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("copy-engine operands must be contiguous and "
                             "16-byte aligned")
    out = torch.empty((B, out_rows, LANES), dtype=torch.uint8, device=dev)
    fn = getattr(_build.kernels(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), *ints, stream)
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


def v19(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """v19 copy engine over one dispatch group: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    (B, NST*128, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v19", qs):
        return v19_reference(*args, K)
    B, NST, MAXQ, G32, RLP = _dims(*args, K)
    out = _launch("zxc_copy_engine_v19", args, B, NST * TILE_ROWS,
                  (B, NST, MAXQ, G32, K, RLP))
    v19.launches += 1
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
                  (B, NST, MAXQ, G32, K, RLP))
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
                  (B, NST, MAXQ, G32, K, RLP, flat.shape[0]))
    v27.launches += 1
    return out


def v13(qs, qbase, pctrl, tq, lit8) -> torch.Tensor:
    """v13 copy engine (one op per slot, 32-row tiles) over one dispatch
    group: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors. Returns (B, NT*32, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if not _on_card("v13", qs):
        return v13_reference(*args)
    B, NT, MAXQ, G32, RLP = _dims(*args, 1, V13_ROWS)
    out = _launch("zxc_copy_engine_v13", args, B, NT * V13_ROWS,
                  (B, NT, MAXQ, G32, RLP))
    v13.launches += 1
    return out


v19.launches = 0
v26.launches = 0
v27.launches = 0
v13.launches = 0

KERNELS = {19: v19, 26: v26, 27: v27, 13: v13}
REFERENCES = {19: v19_reference, 26: v26_reference, 27: v27_reference,
              13: v13_reference}


def bytes_moved(qs, qbase, pctrl, tq, lit8, K: int = 2, *,
                rows: int = TILE_ROWS, loff=None, RLP: int | None = None
                ) -> int:
    """The bytes one call must move for this group's control, padding
    excluded: all of ``qs``; for each live quad (inside a tile's
    pair-rounded range and below MAXQ) its ``qbase`` word, its 128 ``tq``
    entries and its K x 128 ``pctrl`` words; each distinct window row of
    ``lit8`` that a slot adding anything reads (v26's and v27's rows past
    RLP are the call's own output, not an input); and the (B, NT*rows,
    128) uint8 output. v13: ``rows=32, K=1`` (int32 ``tq``). v27: ``lit8``
    is the flat buffer, with ``loff`` (whose B words count too) and
    ``RLP``."""
    qs, qbase, pctrl, tq = (np.asarray(a.cpu()) if isinstance(a, torch.Tensor)
                            else np.asarray(a) for a in (qs, qbase, pctrl, tq))
    B, NT1 = qs.shape
    MAXQ = qbase.shape[1]
    G32 = pctrl.shape[1] // K
    flat = loff is not None
    if flat:
        loff = np.asarray(loff.cpu() if isinstance(loff, torch.Tensor)
                          else loff).astype(np.int64)
    else:
        RLP = lit8.shape[1]
    qidx = np.arange(MAXQ)
    live = np.zeros((B, MAXQ), bool)
    for t in range(NT1 - 1):
        q0 = qs[:, t].astype(np.int64)
        qend = q0 + 2 * np.maximum((qs[:, t + 1].astype(np.int64) - q0) >> 1,
                                   0)
        live |= (qidx >= q0[:, None]) & (qidx < qend[:, None])
    bb, qq = live.nonzero()
    slot = np.arange(128)
    bat = 4 * qq[:, None] + (slot >> 5)                              # (n,128)
    w = pctrl[bb[:, None, None], np.arange(K) * G32
              + (32 * (bat >> 7) + (slot & 31))[:, :, None],
              (bat & 127)[:, :, None]].astype(np.int64) & 0xFFFFFFFF  # (n,128,K)
    rowrel = w[:, :, 0] >> 21
    src = qbase[bb, qq].astype(np.int64)[:, None] + rowrel
    tgt = tq[bb, qq].astype(np.int64)
    adds = ((((w >> 7) & 127) <= ((w >> 14) & 127)).any(axis=2)
            & (rowrel < 128) & (tgt >= 0) & (tgt < rows)
            & (src >= 0) & (src < RLP))
    if flat:   # rows of the shared flat buffer
        frow = loff[bb][:, None] + src
        adds &= ((loff[bb] >= 0)[:, None] & (frow >= 0)
                 & (frow < lit8.shape[0]))
        n_rows = len(np.unique(frow[adds]))
    else:
        n_rows = len(np.unique((bb[:, None] * RLP + src)[adds]))
    control = len(qq) * (4 + LANES * tq.itemsize + K * LANES * 4)
    return (qs.nbytes + control + n_rows * LANES + (4 * B if flat else 0)
            + B * (NT1 - 1) * rows * LANES)


def group_from_numpy(*arrays, device="cpu"):
    """One dispatch group's packed control, as made by the JAX package's
    packers or the native prep, to the port's tensors on ``device``, bit
    for bit: (qs, qbase, pctrl, tq, lit8) with int32 qs/qbase/pctrl, uint8
    tq (int32 for v13) and uint8 lit8; or v27's (qs, qbase, loff, pctrl,
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
