"""The attic route of ``ops.decompress(use_serial=True, variant=1|2|3)``:
the port of ``tools/kernel_attic.py``'s ``pack_blocks``, ``decode_blocks``
and ``serial_kernel_wrapped`` (bodies v1 ``_kernel``, v2 ``_kernel_v2``,
v3 ``_kernel_v3``).

``pack_blocks`` lays the resolver's ``device_pure`` pieces out as the JAX
package does, array for array: ``npieces``, ``totals``, ``pcs`` (B, PR,
128) int32 with the four fields ``[o, c, s, max(k, 1)]`` of each piece
flat, 32 pieces a row, and ``lit8`` (B, RL, 128) uint8.
``piece_serial`` runs one dispatch group through the piece-serial kernel
(``csrc/attic.cu``); its function, for output byte p < totals[b] of block
b in piece i (the last piece with o_i <= p):

    p0 = max(o_i, 1024 * (p // 1024))
    out[p] = lit[c_i + rem(p0 - s_i, k_i) + (p - p0)]

with ``rem`` truncating and int32 arithmetic that wraps, or ``s_i & 255``
for a piece whose stored k is 1 when ``fill_from_s`` (v2 and v3 splat s;
v1 does not). A lit index outside the block's lit row reads 0, and so do
bytes before the first piece and from ``totals[b]`` on. v2 and v3 differ
only in their TPU schedule, so they share the kernel.

Bound on the card: the bytes of the call (``bytes_moved``: 16 bytes a
live piece, each ``lit_full`` byte once, the output once) over 3.35 TB/s.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises, counting launches in
``piece_serial.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from .device_pipeline import _device

CHUNK = 1024          # output window of the JAX bodies (8 rows x 128 lanes)
ROWS = CHUNK // 128
WIN = 2 * ROWS
STAGE = 512           # pieces the JAX bodies stage into SMEM a round
STAGE_LOAD = 24       # rows a stage DMA reads (pcs is padded for it)
VARIANTS = {1: False, 2: True, 3: True}    # variant -> fill_from_s


def pack_blocks(pieces, lit_fulls, totals, block: int):
    """Pack device_pure piece plans into the kernel's input arrays, as the
    JAX package's ``kernel_attic.pack_blocks``. Returns (args, (PR, RL))
    with args = (npieces, totals, pcs, lit8)."""
    B = len(pieces)
    P = max(2, 1 << int(np.ceil(np.log2(max(max(len(p[0]) for p in pieces),
                                            2)))))
    Lmax = max(len(lf) for lf in lit_fulls)
    RL = -(-Lmax // CHUNK) * ROWS + 2 * WIN
    PR = -(-((P + STAGE + 2) * 4) // 128)
    PR = -(-PR // STAGE_LOAD) * STAGE_LOAD
    pcs = np.zeros((B, PR, 128), np.int32)
    lit8 = np.zeros((B, RL, 128), np.uint8)
    npieces = np.zeros(B, np.int32)
    tot = np.asarray(totals, np.int32).reshape(B)
    for j, ((p_o, p_c, p_s, p_k), lf) in enumerate(zip(pieces, lit_fulls)):
        n = len(p_o)
        flatp = pcs[j].reshape(-1)
        flatp[0:4 * n:4] = p_o
        flatp[1:4 * n:4] = p_c
        flatp[2:4 * n:4] = p_s
        flatp[3:4 * n:4] = np.maximum(p_k, 1)
        npieces[j] = n
        lit8[j].reshape(-1)[:len(lf)] = lf
    return (npieces, tot, pcs, lit8), (PR, RL)


def _check(npieces, totals, pcs, lit8):
    want = (("npieces", npieces, torch.int32, 1),
            ("totals", totals, torch.int32, 1),
            ("pcs", pcs, torch.int32, 3), ("lit8", lit8, torch.uint8, 3))
    for name, t, dt, nd in want:
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != pcs.device:
            raise ValueError(f"{name} is on {t.device}, pcs on {pcs.device}")
    B = pcs.shape[0]
    if (npieces.shape[0] != B or totals.shape[0] != B or pcs.shape[2] != 128
            or lit8.shape[0] != B or lit8.shape[2] != 128):
        raise ValueError("inconsistent attic shapes: npieces "
                         f"{tuple(npieces.shape)}, totals "
                         f"{tuple(totals.shape)}, pcs {tuple(pcs.shape)}, "
                         f"lit8 {tuple(lit8.shape)}")


def piece_serial_reference(npieces, totals, pcs, lit8, block: int,
                           fill_from_s: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel on any device: (B, block)
    uint8. Piece starts must not decrease within a block's n pieces."""
    _check(npieces, totals, pcs, lit8)
    B = pcs.shape[0]
    cap = pcs.shape[1] * 32
    dev = pcs.device
    f = pcs.reshape(B, cap, 4)
    n = npieces.clamp(0, cap)
    T = totals.clamp(0, block)
    live = torch.arange(cap, device=dev) < n[:, None]
    o = torch.where(live, f[..., 0], torch.iinfo(torch.int32).max)
    p = torch.arange(block, dtype=torch.int32, device=dev).expand(B, block)
    i = torch.searchsorted(o.contiguous(), p.contiguous(), right=True) - 1
    ic = i.clamp_min(0)
    c, s, kraw = (f[..., x].gather(1, ic) for x in (1, 2, 3))
    k = kraw.clamp_min(1)
    p0 = torch.maximum(o.gather(1, ic), p & -CHUNK)
    idx = c + torch.fmod(p0 - s, k) + (p - p0)
    L = lit8.shape[1] * 128
    val = lit8.reshape(B, L).gather(1, idx.clamp(0, max(L - 1, 0)).long())
    val = torch.where((idx >= 0) & (idx < L), val, 0)
    if fill_from_s:
        val = torch.where(kraw == 1, (s & 255).to(torch.uint8), val)
    return torch.where((i >= 0) & (p < T[:, None]), val, 0)


def piece_serial(npieces, totals, pcs, lit8, block: int,
                 fill_from_s: bool) -> torch.Tensor:
    """The piece-serial copy engine over one dispatch group: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Returns
    (B, block) uint8."""
    if pcs.device.type == "cpu":
        return piece_serial_reference(npieces, totals, pcs, lit8, block,
                                      fill_from_s)
    if pcs.device.type != "cuda":
        raise ValueError(
            f"piece_serial runs on cuda or cpu, not {pcs.device}")
    _check(npieces, totals, pcs, lit8)
    if block % CHUNK or pcs.shape[0] > 65535:
        raise ValueError(f"block {block} must be a multiple of {CHUNK} and "
                         f"B {pcs.shape[0]} at most 65535")
    args = (npieces, totals, pcs, lit8)
    for t in args:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("attic operands must be contiguous and 16-byte "
                             "aligned")
    from . import _build
    B = pcs.shape[0]
    out = torch.empty((B, block), dtype=torch.uint8, device=pcs.device)
    with torch.cuda.device(pcs.device):
        stream = torch.cuda.current_stream(pcs.device).cuda_stream
        rc = _build.attic_kernels().zxc_piece_serial(
            npieces.data_ptr(), totals.data_ptr(), pcs.data_ptr(),
            pcs.shape[1] * 32, lit8.data_ptr(), lit8.shape[1] * 128,
            out.data_ptr(), B, block, int(fill_from_s), stream)
    if rc:
        raise RuntimeError(f"zxc_piece_serial launch failed: cudaError {rc}")
    piece_serial.launches += 1
    return out


piece_serial.launches = 0
KERNELS = {"attic": piece_serial}


def bytes_moved(pieces, lit_fulls, block: int) -> int:
    """The bytes one call must move for these blocks: npieces and totals,
    16 bytes a live piece, each ``lit_full`` byte once and the (B, block)
    uint8 output once (the padding of pcs and lit8 is not counted)."""
    B = len(pieces)
    return (8 * B + 16 * sum(len(p[0]) for p in pieces)
            + sum(len(lf) for lf in lit_fulls) + B * block)


def pack_groups(pieces, lit_fulls, totals, block: int, dispatch: int = 16):
    """``pack_blocks`` of each dispatch group of ``dispatch`` blocks (the
    last group may be smaller). Piece starts must not decrease within a
    block, as the resolver makes them."""
    for p in pieces:
        if len(p[0]) > 1 and (np.diff(p[0]) < 0).any():
            raise ValueError("piece starts decrease: not a resolver plan")
    return [pack_blocks(pieces[g:g + dispatch], lit_fulls[g:g + dispatch],
                        totals[g:g + dispatch], block)[0]
            for g in range(0, len(pieces), dispatch)]


def decode_groups(groups, totals, block: int, variant: int,
                  device) -> list[bytes]:
    """Each packed group through ``piece_serial`` on ``device`` (one
    launch a group, one readback a group); each block's bytes cut at its
    total."""
    res = []
    for args in groups:
        t = [torch.from_numpy(a).to(device) for a in args]
        out = piece_serial(*t, block=block,
                           fill_from_s=VARIANTS[variant]).cpu().numpy()
        base = len(res)
        res += [out[j, :totals[base + j]].tobytes()
                for j in range(len(args[0]))]
    return res


def decode_blocks(pieces, lit_fulls, totals, block: int, device=None,
                  variant: int = 2, dispatch: int = 16) -> list[bytes]:
    """Decode device_pure piece plans (the JAX package's
    ``kernel_attic.decode_blocks``), one launch per dispatch group.
    ``device``: None means cuda (raises without it); "cpu" runs the plain
    version. Returns each block's bytes."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"attic variant {variant} is not the piece-serial kernel "
            "(variants 1-3); ROADMAP queue 1 item 1 lists the others")
    dev = _device(device, "attic.decode_blocks")
    return decode_groups(pack_groups(pieces, lit_fulls, totals, block,
                                     dispatch), totals, block, variant, dev)
