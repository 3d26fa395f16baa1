"""Copy-engine decode kernels v19 and v26: wrappers, plain versions and
launch counters.

Replaces ``zxc_tpu/ops/pallas_decode.py``: ``_make_kernel_v19`` /
``v19_kernel`` and ``_make_kernel_v26`` / ``v26_kernel``. The Pallas
kernels reach their function through one-hot MXU matmuls and bf16 byte
carriers because gathers are slow on a TPU; the Hopper kernels
(``csrc/copy_engine.cu``) do indexed byte loads and shared-memory adds
instead. The function, for block b and 128-row supertile t:

* a (128,128) int32 tile starts at 0 and runs quads
  ``qs[b,t] .. qs[b,t] + 2*((qs[b,t+1]-qs[b,t]) >> 1) - 1`` (pair-unrolled:
  an odd trailing quad is skipped);
* slot i of quad q reads plane j's control word
  ``w_j = pctrl[b, j*G32 + 32*(bat>>7) + (i&31), bat&127]``,
  ``bat = 4q + (i>>5)``; its source row is ``qbase[b,q] + (w_0 >>> 21)``
  and its target row ``tq[b,q,i]``;
* lane l is covered by plane j when ``((w_j>>7)&127) <= l <= ((w_j>>14)&127)``;
  the roll is the highest covering plane's ``w_j & 127`` and a covered lane
  adds ``win[src, (l + roll) & 127]`` into ``tile[tgt, l]``;
* the tile is stored to output rows ``t*128 .. t*128+127`` mod 256.

v19's window is ``lit8[b]``. v26's window is ``lit8[b]`` followed by the
block's own output rows, each of which reads 0 until its supertile has
been stored. A slot whose window-relative row exceeds 127, whose source
lies outside the window or whose target row is >= 128 adds nothing.

Bound on the card: the bytes each call must move (``bytes_moved``: ``qs``,
the live quads' control and the window rows their slots read, each read
once, and the uint8 output written once) over the H100's 3.35 TB/s; a
dispatch group of 16 x 64 KiB blocks moves a few MB, a microsecond or
two. The kernels are far from it: each slot is a
chain of dependent loads and v26 has one CTA per block (16 CTAs on 132
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
TILE_ROWS = 128    # rows per supertile


def _dims(qs, qbase, pctrl, tq, lit8, K: int):
    """Validate one dispatch group; returns (B, NST, MAXQ, G32, RLP)."""
    want = ((qs, torch.int32, 2), (qbase, torch.int32, 2),
            (pctrl, torch.int32, 3), (tq, torch.uint8, 3),
            (lit8, torch.uint8, 3))
    for name, (t, dt, nd) in zip(("qs", "qbase", "pctrl", "tq", "lit8"),
                                 want):
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != qs.device:
            raise ValueError(f"{name} is on {t.device}, qs on {qs.device}")
    B = qs.shape[0]
    NST = qs.shape[1] - 1
    MAXQ = qbase.shape[1]
    RLP = lit8.shape[1]
    if NST < 0 or K < 1 or pctrl.shape[1] % K:
        raise ValueError(f"bad qs {tuple(qs.shape)} / pctrl "
                         f"{tuple(pctrl.shape)} for K={K}")
    G32 = pctrl.shape[1] // K
    if (qbase.shape[0] != B or pctrl.shape[0] != B or pctrl.shape[2] != LANES
            or tuple(tq.shape) != (B, MAXQ, LANES)
            or tuple(lit8.shape[::2]) != (B, LANES)
            or G32 < 32 * -(-4 * MAXQ // 128)):
        raise ValueError("inconsistent copy-engine shapes: qs "
                         f"{tuple(qs.shape)}, qbase {tuple(qbase.shape)}, "
                         f"pctrl {tuple(pctrl.shape)}, tq {tuple(tq.shape)}, "
                         f"lit8 {tuple(lit8.shape)}")
    return B, NST, MAXQ, G32, RLP


def _reference(qs, qbase, pctrl, tq, lit8, K: int, self_ref: bool):
    B, NST, MAXQ, G32, RLP = _dims(qs, qbase, pctrl, tq, lit8, K)
    dev = qs.device
    NR = NST * TILE_ROWS
    out = torch.zeros((B, NR, LANES), dtype=torch.uint8, device=dev)
    lanes = torch.arange(LANES, device=dev)
    slot = torch.arange(128, device=dev)
    planes = torch.arange(K, device=dev)
    qidx = torch.arange(MAXQ, device=dev)
    pc = pctrl.reshape(B, K, G32, LANES)
    win_rows = RLP + NR if self_ref else RLP
    for t in range(NST):
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
        valid = ((rowrel < 128) & (tgt < TILE_ROWS) & (src >= 0)
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
        rows = bb[:, None] * win.shape[1] + torch.where(valid, src, 0)
        idx = (rows[..., None] * LANES + ((lanes + roll) & 127))
        val = torch.where(keep, win.reshape(-1)[idx].to(torch.int32), 0)
        tile = torch.zeros(B * TILE_ROWS * LANES, dtype=torch.int32,
                           device=dev)
        tidx = ((bb[:, None] * TILE_ROWS + torch.where(valid, tgt, 0))[..., None]
                * LANES + lanes)
        tile.index_add_(0, tidx.reshape(-1), val.reshape(-1))
        out[:, t * TILE_ROWS:(t + 1) * TILE_ROWS] = (
            tile.view(B, TILE_ROWS, LANES) & 255).to(torch.uint8)
    return out


def v19_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v19 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K, self_ref=False)


def v26_reference(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """Plain PyTorch v26 on any device: (B, NST*128, 128) uint8."""
    return _reference(qs, qbase, pctrl, tq, lit8, K, self_ref=True)


def _launch(entry: str, args, K: int) -> torch.Tensor:
    from . import _build
    qs, qbase, pctrl, tq, lit8 = args
    B, NST, MAXQ, G32, RLP = _dims(*args, K)
    dev = qs.device
    for name, t in zip(("qs", "qbase", "pctrl", "tq", "lit8"), args):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    out = torch.empty((B, NST * TILE_ROWS, LANES), dtype=torch.uint8,
                      device=dev)
    fn = getattr(_build.kernels(), entry)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), B, NST, MAXQ,
                G32, K, RLP, stream)
    if rc:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out


def v19(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """v19 copy engine over one dispatch group: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors. Returns
    (B, NST*128, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if qs.device.type == "cpu":
        return v19_reference(*args, K)
    if qs.device.type != "cuda":
        raise ValueError(f"v19 runs on cuda or cpu, not {qs.device}")
    out = _launch("zxc_copy_engine_v19", args, K)
    v19.launches += 1
    return out


def v26(qs, qbase, pctrl, tq, lit8, K: int = 2) -> torch.Tensor:
    """v26 copy engine (self-referential window) over one dispatch group:
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (B, NST*128, 128) uint8."""
    args = (qs, qbase, pctrl, tq, lit8)
    if qs.device.type == "cpu":
        return v26_reference(*args, K)
    if qs.device.type != "cuda":
        raise ValueError(f"v26 runs on cuda or cpu, not {qs.device}")
    out = _launch("zxc_copy_engine_v26", args, K)
    v26.launches += 1
    return out


v19.launches = 0
v26.launches = 0

KERNELS = {19: v19, 26: v26}
REFERENCES = {19: v19_reference, 26: v26_reference}


def bytes_moved(qs, qbase, pctrl, tq, lit8, K: int = 2) -> int:
    """The bytes one call must move for this group's control, padding
    excluded: all of ``qs``; for each live quad (inside a supertile's
    pair-rounded range and below MAXQ) its ``qbase`` word, its 128 ``tq``
    bytes and its K x 128 ``pctrl`` words; each distinct ``lit8`` row that
    a slot adding anything reads (v26's rows past RLP are the call's own
    output, not an input); and the (B, NR, 128) uint8 output."""
    qs, qbase, pctrl, tq = (np.asarray(a.cpu()) if isinstance(a, torch.Tensor)
                            else np.asarray(a) for a in (qs, qbase, pctrl, tq))
    B, NST1 = qs.shape
    MAXQ = qbase.shape[1]
    G32 = pctrl.shape[1] // K
    RLP = lit8.shape[1]
    qidx = np.arange(MAXQ)
    live = np.zeros((B, MAXQ), bool)
    for t in range(NST1 - 1):
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
    adds = ((((w >> 7) & 127) <= ((w >> 14) & 127)).any(axis=2)
            & (rowrel < 128) & (tq[bb, qq] < TILE_ROWS)
            & (src >= 0) & (src < RLP))
    rows = np.unique((bb[:, None] * RLP + src)[adds])
    control = len(qq) * (4 + LANES + K * LANES * 4)
    return (qs.nbytes + control + len(rows) * LANES
            + B * (NST1 - 1) * TILE_ROWS * LANES)


def group_from_numpy(qs, qbase, pctrl, tq, lit8, device="cpu"):
    """One dispatch group's packed control, as made by the JAX package's
    packers (``pack_blocks_v19`` / ``pack_blocks_v26`` + ``pad_v19_set``)
    or the native prep, to the port's tensors on ``device``. The layout is
    taken bit for bit: int32 qs/qbase/pctrl, uint8 tq/lit8."""
    want = (np.int32, np.int32, np.int32, np.uint8, np.uint8)
    out = []
    for name, a, dt in zip(("qs", "qbase", "pctrl", "tq", "lit8"),
                           (qs, qbase, pctrl, tq, lit8), want):
        a = np.asarray(a)
        if a.dtype != dt:
            raise TypeError(f"{name} is {a.dtype}, the layout has {np.dtype(dt)}")
        out.append(torch.from_numpy(np.ascontiguousarray(a)).to(device))
    return tuple(out)
