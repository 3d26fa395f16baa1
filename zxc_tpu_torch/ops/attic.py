"""The port of ``tools/kernel_attic.py``: three generations of the
attic's decode kernels, each with its packer (the JAX package's, array for
array), a hand-written CUDA kernel (``csrc/attic.cu``), the kernel's plain
PyTorch version and a decode entry that launches once per dispatch group.

**Piece-serial** (v1-v3; ``ops.decompress(use_serial=True,
variant=1|2|3)`` and ``decode_blocks``): ``pack_blocks`` lays the
resolver's ``device_pure`` pieces out as ``npieces``, ``totals``, ``pcs``
(B, PR, 128) int32 with the four fields ``[o, c, s, max(k, 1)]`` of each
piece flat, 32 pieces a row, and ``lit8`` (B, RL, 128) uint8.
``piece_serial``'s function, for output byte p < totals[b] of block b in
piece i (the last piece with o_i <= p):

    p0 = max(o_i, 1024 * (p // 1024))
    out[p] = lit[c_i + rem(p0 - s_i, k_i) + (p - p0)]

with ``rem`` truncating and int32 arithmetic that wraps, or ``s_i & 255``
for a piece whose stored k is 1 when ``fill_from_s`` (v2 and v3 splat s;
v1 does not). A lit index outside the block's lit row reads 0, and so do
bytes before the first piece and from ``totals[b]`` on. v2 and v3 differ
only in their TPU schedule, so they share the kernel.

**Window ops** (v4-v7; ``decode_blocks_v4``): ``pack_blocks_v4`` splits
the pieces into merge ops confined to 1024-byte output windows
(``runtime.window_ops``), four int32 fields an op: ``srow``, ``net``,
``dlo | dhi << 16`` and ``f3``; ``wstart`` (B, NW+1) holds each window's
first op. ``window_merge`` computes, for window wi of block b, starting
from 0 and applying the ops of its range in order (the last op wins), for
each position pos in [dlo, dhi):

    acc[pos] = f3 - 1                              if f3 > 0
    acc[pos] = lit[r * 128 + mod(pos + net, W)]    otherwise

and returns the low byte. W is 2048 for v4 (a 16-row window of lit) and
1024 for v5-v7 (8 rows); r is ``srow`` after the JAX dynamic slice's
normalisation (a negative start counts from the end of the block's lit
rows, then the start is clamped so the window fits). v4 and v5 walk ops
[ws[wi], ws[wi+1]); v6 and v7 walk them in groups of U = 8 or 16,
[U * (ws[wi] // U), U * (ws[wi+1] // U)). An op outside the ops array adds
nothing.

**Lane ops** (v9-v11; ``decode_blocks_v9/v10/v11``): the resolver's
pieces split into 32-op batches of lane ops (``serial.lane_ops_blocks``),
packed by ``pack_blocks_v9/v10/v11``. ``lane_sum`` computes, for 4096-byte
tile t of block b, sublane k and lane l,

    out[b, 32t + k, l] = low8( sum over batches bat of
                               [s <= l <= e1] * lit[row][(l + rl) & 127] )

with the control word ``c = pctrl[b, 32 * (bat >> 7) + k, bat & 127]``:
for v9 ``rl, s, e1 = c & 255, c >> 8 & 255, c >> 16 & 255`` and ``row =
rows[b, 32 * bat + k]`` (normalised and clamped into the lit rows as
above); for v10 and v11 ``rl, s, e1 = c & 127, c >> 7 & 127, c >> 14 &
127`` and ``row = c >>> 21``, a row at or past the lit rows adding 0 (the
TPU's one-hot row is empty there; the card gathers the row). v9 and v10
sum batches [ts[b,t], ts[b,t] + 4 * ((ts[b,t+1] - ts[b,t]) // 4)), v11
[t * LAYERS, t * LAYERS + 4 * (LAYERS // 4)). A batch outside the control
(or, for v9, the rows) adds nothing. ``lane_sum_reference(probe=)``
states the ablations of v10's body that ``probes.v10_probe`` and
``probes.v12_ablate`` run (``LANE_PROBES``; kernel ``zxc_lane_sum_probe``).

Bounds on the card: the bytes each call must move (``bytes_moved``,
``bytes_moved_window``, ``bytes_moved_lane``; padding not counted) over
3.35 TB/s. On a CPU tensor each wrapper runs its plain version; on a CUDA
tensor it launches the kernel or raises, counting launches in
``.launches``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import runtime
from . import serial
from .device_pipeline import _add, _device

CHUNK = 1024          # output window of the JAX bodies (8 rows x 128 lanes)
ROWS = CHUNK // 128
WIN = 2 * ROWS
STAGE = 512           # pieces the JAX bodies stage into SMEM a round
STAGE_LOAD = 24       # rows a stage DMA reads (pcs is padded for it)
VARIANTS = {1: False, 2: True, 3: True}    # variant -> fill_from_s

UNROLL = 8            # ops a v6 loop iteration (windows padded to it)
UNROLL7 = 16          # the same for v7
# variant -> (lit rows a window op reads, op group the body walks)
WINDOW_MODES = {4: (WIN, 1), 5: (ROWS, 1), 6: (ROWS, UNROLL),
                7: (ROWS, UNROLL7)}

TILE = 4096           # output bytes of a lane-op tile (32 rows x 128 lanes)
V9_GROUP = 8          # MAXB is a multiple of it
V9_CTRL = 128         # int32 lanes of a batch's control row
V9_UNROLL = 4         # batches a tile-loop iteration (lane_ops pads to it)
V10_ROWBITS = 11      # row field of v10/v11 control: at most 2048 lit rows
LANE_MODES = (9, 10, 11)

MERGE_PAIRS = 4096    # (window, op) pairs a chunk of the plain merge
LANE_PAIRS = 1024     # (tile, batch) pairs a chunk of the plain lane sum

# the lane-sum probes of tools/tpu_v10_probe.py and tools/tpu_v12_ablate.py
# (v10's layout), as csrc/attic.cu numbers them; see lane_sum_reference
LANE_PROBES = {"nomatmul": 1, "noonehot": 2, "nobcast": 3, "norotate": 4,
               "norotate_add": 5, "nomask": 6, "floor": 7}
BCAST_WORD = (3 << 14) | (200 << 21)   # nobcast's slot: row 200, lanes 0-3


def _want(specs, device) -> None:
    """Each (name, tensor, dtype, ndim) of ``specs`` is such a tensor on
    ``device``; raises TypeError or ValueError."""
    for name, t, dt, nd in specs:
        if not isinstance(t, torch.Tensor) or t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{name} must be a {nd}-d {dt} tensor")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")


def _launchable(name: str, tensors, B: int) -> None:
    """The card's kernels take contiguous, 16-byte aligned operands and at
    most 65535 blocks (the grid's second dimension)."""
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} operands must be contiguous and "
                             "16-byte aligned")
    if B > 65535:
        raise ValueError(f"{name}: B {B} is over 65535")


def _launch(name: str, fn, *args) -> None:
    """Calls a kernel's C entry on the current stream of the operands'
    card; raises when the launch fails."""
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _groups(n: int, dispatch: int):
    return [slice(g, g + dispatch) for g in range(0, n, dispatch)]


def _decode(pieces, lit_fulls, totals, dev, dispatch: int, ph, group):
    """Each dispatch group of blocks through ``group(pieces, lits,
    totals) -> (host arrays, launch)``: the arrays go to ``dev`` and
    ``launch`` takes them as tensors, once; each block's bytes cut at its
    total. ``ph`` receives the ``pack`` and ``device`` seconds."""
    res = []
    for sl in _groups(len(pieces), dispatch):
        t0 = time.perf_counter()
        host, launch = group(pieces[sl], lit_fulls[sl], totals[sl])
        t0 = _add(ph, "pack", t0)
        out = launch(*(torch.from_numpy(a).to(dev) for a in host))
        out = out.cpu().numpy()
        _add(ph, "device", t0)
        res += [out[j, :totals[sl.start + j]].tobytes()
                for j in range(len(out))]
    return res


# -- piece-serial: v1, v2, v3 ------------------------------------------------

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
    _want((("npieces", npieces, torch.int32, 1),
           ("totals", totals, torch.int32, 1),
           ("pcs", pcs, torch.int32, 3), ("lit8", lit8, torch.uint8, 3)),
          pcs.device)
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
    if block % CHUNK:
        raise ValueError(f"block {block} must be a multiple of {CHUNK}")
    _launchable("piece_serial", (npieces, totals, pcs, lit8), pcs.shape[0])
    from . import _build
    B = pcs.shape[0]
    out = torch.empty((B, block), dtype=torch.uint8, device=pcs.device)
    with torch.cuda.device(pcs.device):
        _launch("zxc_piece_serial", _build.attic_kernels().zxc_piece_serial,
                npieces.data_ptr(), totals.data_ptr(), pcs.data_ptr(),
                pcs.shape[1] * 32, lit8.data_ptr(), lit8.shape[1] * 128,
                out.data_ptr(), B, block, int(fill_from_s))
    piece_serial.launches += 1
    return out


piece_serial.launches = 0


def bytes_moved(pieces, lit_fulls, block: int) -> int:
    """The bytes one call must move for these blocks: npieces and totals,
    16 bytes a live piece, each ``lit_full`` byte once and the (B, block)
    uint8 output once (the padding of pcs and lit8 is not counted)."""
    B = len(pieces)
    return (8 * B + 16 * sum(len(p[0]) for p in pieces)
            + sum(len(lf) for lf in lit_fulls) + B * block)


def _check_starts(pieces) -> None:
    for p in pieces:
        if len(p[0]) > 1 and (np.diff(p[0]) < 0).any():
            raise ValueError("piece starts decrease: not a resolver plan")


def pack_groups(pieces, lit_fulls, totals, block: int, dispatch: int = 16):
    """``pack_blocks`` of each dispatch group of ``dispatch`` blocks (the
    last group may be smaller). Piece starts must not decrease within a
    block, as the resolver makes them."""
    _check_starts(pieces)
    return [pack_blocks(pieces[sl], lit_fulls[sl], totals[sl], block)[0]
            for sl in _groups(len(pieces), dispatch)]


OTHER_VARIANTS = (
    "the port decodes resolver plans with variants 4-7 through "
    "attic.decode_blocks_v4, with 9, 10 and 11 through "
    "attic.decode_blocks_v9, decode_blocks_v10 and decode_blocks_v11, and "
    "with 12, 14-17 and 20-24 through attic_quad.decode_blocks_v12, "
    "decode_blocks_v14, ..., decode_blocks_v24, and with 25 through "
    "serial.decode_blocks_v25 on plans of batch.resolve_serial(plan, "
    "self_ref=True), which the JAX package's decompress does not route "
    "either (ROADMAP queue 3, attic variants past 3)")


def decode_blocks(pieces, lit_fulls, totals, block: int, device=None,
                  variant: int = 2, dispatch: int = 16, *,
                  _phases: dict | None = None) -> list[bytes]:
    """Decode device_pure piece plans (the JAX package's
    ``kernel_attic.decode_blocks``), one launch per dispatch group; piece
    starts must not decrease within a block. ``device``: None means cuda
    (raises without it); "cpu" runs the plain version. ``_phases``
    receives the ``pack`` and ``device`` seconds. Returns each block's
    bytes."""
    if variant not in VARIANTS:
        raise NotImplementedError(
            f"attic variant {variant} is not the piece-serial kernel "
            f"(variants 1-3): {OTHER_VARIANTS}")
    dev = _device(device, "attic.decode_blocks")
    _check_starts(pieces)

    def group(p, lf, t):
        return pack_blocks(p, lf, t, block)[0], lambda *a: piece_serial(
            *a, block=block, fill_from_s=VARIANTS[variant])

    return _decode(pieces, lit_fulls, totals, dev, dispatch, _phases, group)


# -- window ops: v4, v5, v6, v7 ------------------------------------------------

def _pad_ops_to_unroll(opsf, ws, unroll=UNROLL):
    """Pad each window's op list to a multiple of `unroll` with no-ops
    (dlo == dhi == 0 -> empty mask)."""
    counts = np.diff(ws)
    padded = -(-counts // unroll) * unroll
    new_ws = np.concatenate([[0], np.cumsum(padded)]).astype(np.int32)
    out = np.zeros(int(new_ws[-1]) * 4, np.int32)
    ops2 = opsf.reshape(-1, 4)
    for wi, cnt in enumerate(counts):
        src0 = ws[wi]
        dst0 = new_ws[wi]
        out.reshape(-1, 4)[dst0:dst0 + cnt] = ops2[src0:src0 + cnt]
    return out, new_ws


def pack_blocks_v4(pieces, lit_fulls, totals, block: int,
                   split_src: bool = False, pad_unroll: bool = False):
    """Pack window-op plans for the window merge, as the JAX package's
    ``kernel_attic.pack_blocks_v4``.

    Returns (args, (OR, RL, NW)) with args = (wstart (B,NW+1), ops
    (B,OR,128), lit8 (B,RL,128))."""
    B = len(pieces)
    NW = block // CHUNK
    Lmax = max(len(lf) for lf in lit_fulls)
    RL = -(-Lmax // CHUNK) * ROWS + 2 * WIN
    plans = []
    max_ops = 2
    for (p_o, p_c, p_s, p_k), total in zip(pieces, totals):
        r = runtime.window_ops(p_o, p_c, p_s, p_k, int(total), split_src)
        if r is None:
            # the JAX package asserts here; the archive is not at fault
            raise ValueError(
                f"window ops of a block exceed zxch_window_ops"
                f"{'2' if split_src else ''}'s budget of "
                f"{(3 if split_src else 2)} ops a piece + 1 a window + 64")
        if pad_unroll:
            r = _pad_ops_to_unroll(*r, unroll=pad_unroll)
        plans.append(r)
        max_ops = max(max_ops, len(r[0]) // 4)
    OPS = 1 << int(np.ceil(np.log2(max_ops + 1)))
    OR = -(-((OPS + STAGE + 2) * 4) // 128)
    OR = -(-OR // STAGE_LOAD) * STAGE_LOAD
    ops = np.zeros((B, OR, 128), np.int32)
    wstart = np.zeros((B, NW + 1), np.int32)
    lit8 = np.zeros((B, RL, 128), np.uint8)
    for j, ((opsf, ws), lf) in enumerate(zip(plans, lit_fulls)):
        flat = ops[j].reshape(-1)
        flat[:len(opsf)] = opsf
        wstart[j, :len(ws)] = ws
        wstart[j, len(ws):] = ws[-1]
        lflat = lit8[j].reshape(-1)
        lflat[:len(lf)] = lf
    return (wstart, ops, lit8), (OR, RL, NW)


def _check_window(wstart, ops, lit8, block: int, mode: int) -> None:
    _want((("wstart", wstart, torch.int32, 2), ("ops", ops, torch.int32, 3),
           ("lit8", lit8, torch.uint8, 3)), ops.device)
    if mode not in WINDOW_MODES:
        raise ValueError(f"window-op mode {mode}: 4, 5, 6 or 7")
    B = ops.shape[0]
    if (block % CHUNK or wstart.shape != (B, block // CHUNK + 1)
            or ops.shape[2] != 128 or lit8.shape[0] != B
            or lit8.shape[2] != 128 or lit8.shape[1] < WINDOW_MODES[mode][0]):
        raise ValueError(
            f"inconsistent window-op shapes for block {block}, mode {mode}: "
            f"wstart {tuple(wstart.shape)}, ops {tuple(ops.shape)}, lit8 "
            f"{tuple(lit8.shape)}")


def window_merge_reference(wstart, ops, lit8, block: int,
                           mode: int) -> torch.Tensor:
    """Plain PyTorch version of the window merge on any device: (B,
    block) uint8. The last op of a window's range that covers a position
    is found by a max-reduce over (window, op) pairs, a chunk at a time."""
    _check_window(wstart, ops, lit8, block, mode)
    wrows, unroll = WINDOW_MODES[mode]
    B, NW, RL = ops.shape[0], block // CHUNK, lit8.shape[1]
    dev = ops.device
    cap = ops.shape[1] * 32
    ws = torch.div(wstart.long(), unroll, rounding_mode="floor") * unroll
    t0, t1 = ws[:, :-1].clamp(0, cap), ws[:, 1:].clamp(0, cap)
    n = (t1 - t0).clamp_min(0).reshape(-1)
    win = torch.repeat_interleave(torch.arange(B * NW, device=dev), n)
    first = torch.cumsum(n, 0) - n
    t = (t0.reshape(-1)[win] + torch.arange(len(win), device=dev)
         - first[win])
    op = torch.cat([ops.reshape(B, cap, 4)[win // NW, t].long(),
                    torch.zeros((1, 4), dtype=torch.long, device=dev)])
    pos = torch.arange(CHUNK, device=dev)
    last = torch.full((B * NW, CHUNK), -1, dtype=torch.long, device=dev)
    for c in range(0, len(win), MERGE_PAIRS):
        f2 = op[c:min(c + MERGE_PAIRS, len(win)), 2:3]
        hit = (pos >= (f2 & 0xFFFF)) & (pos < ((f2 >> 16) & 0xFFFF))
        key = torch.arange(c, c + len(f2), device=dev)[:, None]
        last.scatter_reduce_(0, win[c:c + len(f2), None].expand(-1, CHUNK),
                             torch.where(hit, key, -1), "amax")
    w = op[torch.where(last >= 0, last, len(win))]       # (B*NW, CHUNK, 4)
    srow, net, f3 = w[..., 0], w[..., 1], w[..., 3]
    r = torch.where(srow < 0, srow + RL, srow).clamp(0, RL - wrows)
    b = torch.arange(B * NW, device=dev)[:, None] // NW
    idx = (b * RL + r) * 128 + ((pos + net) & (wrows * 128 - 1))
    val = torch.where(f3 > 0, f3 - 1, lit8.reshape(-1)[idx].long())
    val = torch.where(last >= 0, val & 255, 0)
    return val.to(torch.uint8).reshape(B, block)


def window_merge(wstart, ops, lit8, block: int, mode: int) -> torch.Tensor:
    """The window merge (v4-v7) over one dispatch group: the CUDA kernel
    for CUDA tensors, the plain version for CPU tensors. Returns (B,
    block) uint8."""
    if ops.device.type == "cpu":
        return window_merge_reference(wstart, ops, lit8, block, mode)
    if ops.device.type != "cuda":
        raise ValueError(f"window_merge runs on cuda or cpu, not "
                         f"{ops.device}")
    _check_window(wstart, ops, lit8, block, mode)
    _launchable("window_merge", (wstart, ops, lit8), ops.shape[0])
    from . import _build
    B = ops.shape[0]
    out = torch.empty((B, block), dtype=torch.uint8, device=ops.device)
    with torch.cuda.device(ops.device):
        _launch("zxc_window_merge", _build.attic_kernels().zxc_window_merge,
                wstart.data_ptr(), ops.data_ptr(), ops.shape[1] * 32,
                lit8.data_ptr(), lit8.shape[1], out.data_ptr(), B, block,
                mode)
    window_merge.launches += 1
    return out


window_merge.launches = 0


def bytes_moved_window(wstart: np.ndarray, ops: np.ndarray, lit_fulls,
                       block: int) -> int:
    """The bytes one window merge must move: ``wstart``, 16 bytes a live
    op (dlo < dhi; the no-ops v6/v7 pad with are not counted), each
    ``lit_full`` byte once and the (B, block) uint8 output once."""
    f2 = ops.reshape(-1, 4)[:, 2].astype(np.int64)
    live = int(((f2 & 0xFFFF) < ((f2 >> 16) & 0xFFFF)).sum())
    return (wstart.nbytes + 16 * live + sum(len(lf) for lf in lit_fulls)
            + len(ops) * block)


def decode_blocks_v4(pieces, lit_fulls, totals, block: int, device=None,
                     variant: int = 4, dispatch: int = 16, *,
                     _phases: dict | None = None) -> list[bytes]:
    """Decode device_pure piece plans through the window merge (the JAX
    package's ``kernel_attic.decode_blocks_v4``, ``variant`` 4-7), one
    launch per dispatch group. ``device``: None means cuda (raises
    without it); "cpu" runs the plain version. ``_phases`` receives the
    ``pack`` and ``device`` seconds. Returns each block's bytes."""
    if variant not in WINDOW_MODES:
        raise ValueError(f"window-op variant {variant}: 4, 5, 6 or 7")
    dev = _device(device, "attic.decode_blocks_v4")

    def group(p, lf, t):
        host, _ = pack_blocks_v4(
            p, lf, t, block, split_src=(variant >= 5),
            pad_unroll={6: UNROLL, 7: UNROLL7}.get(variant, 0))
        return host, lambda *a: window_merge(*a, block=block, mode=variant)

    return _decode(pieces, lit_fulls, totals, dev, dispatch, _phases, group)


# -- lane ops: v9, v10, v11 ----------------------------------------------------

def _rows_for_v10(RL: int, name: str) -> int:
    """v10/v11's lit rows (RL padded to 16); raises past the row field."""
    RLP = -(-RL // 16) * 16
    if RLP > (1 << V10_ROWBITS):
        raise ValueError(
            f"lit_full too large for the {name} row field: {RLP} rows, at "
            f"most {1 << V10_ROWBITS} (256 KiB)")
    return RLP


def pack_blocks_v9(pieces_list, lit_list, totals, block: int,
                   per=None, MAXB=None, RL=None):
    """Build the v9 dispatch batch from per-block pieces + lit_full, as
    the JAX package's ``kernel_attic.pack_blocks_v9``.

    Returns (nb, ts, rows, pctrl, lit32) where
      nb    (B,)            int32  batches per block
      ts    (B, NT+1)       int32  per-tile batch prefix
      rows  (B, MAXB*32)    int32  src row per (batch,sub)
      pctrl (B, G32, 128)   int32  pre-transposed packed control: for batch
                                   bat = 128*g + j, sublane k,
                                   pctrl[b, 32*g + k, j] = rl | s<<8 | (e-1)<<16
                                   (empty ops packed as s=1, e-1=0)
      lit32 (B, RL, 128)    int32  lit_full bytes, row-padded
    """
    B = len(pieces_list)
    if per is None:
        per = serial.lane_ops_blocks(pieces_list, totals)
    if MAXB is None:
        MAXB = max(max(len(r[0]), 1) for r in per)
        MAXB = -(-MAXB // V9_GROUP) * V9_GROUP
    if RL is None:
        RL = max(-(-len(lit) // 128) for lit in lit_list) + 1
    NT = block // TILE
    NG = -(-MAXB // 128)
    nb = np.array([len(r[0]) for r in per], np.int32)
    ts = np.zeros((B, NT + 1), np.int32)
    rows_f = np.zeros((B, MAXB * 32), np.int32)
    pctrl = np.full((B, NG * 32, 128), 1 << 8, np.int32)
    lit32 = np.zeros((B, RL, 128), np.int32)
    for j, ((rows, rl, s, e, tile_start), lit) in enumerate(
            zip(per, lit_list)):
        k = len(rows)
        nts = len(tile_start) - 1
        ts[j, :nts + 1] = tile_start
        ts[j, nts + 1:] = tile_start[-1]
        rows_f[j, :k * 32] = rows.reshape(-1)
        packed = np.where(e > 0, rl | (s << 8) | ((e - 1) << 16), 1 << 8)
        bat = np.arange(k)[:, None]
        sub = np.arange(32)[None, :]
        pctrl[j, 32 * (bat >> 7) + sub, bat & 127] = packed
        flat = np.frombuffer(bytes(lit), np.uint8)
        lit32[j].reshape(-1)[:len(flat)] = flat
    return nb, ts, rows_f, pctrl, lit32


def pack_blocks_v10(pieces_list, lit_list, totals, block: int,
                    per=None, MAXB=None, RL=None):
    """Build the v10 dispatch batch, as the JAX package's
    ``kernel_attic.pack_blocks_v10``; raises ValueError for a lit_full
    over 2048 rows.

    Returns (nb, ts, pctrl, lit8) where
      nb    (B,)          int32  batches per block
      ts    (B, NT+1)     int32  per-tile batch prefix
      pctrl (B, G32, 128) int32  pre-transposed packed control: for batch
                                 bat = 128*g + j, sublane k,
                                 pctrl[b, 32*g + k, j] =
                                     roll | s<<7 | (e-1)<<14 | src_row<<21
                                 (empty ops packed as s=1, e-1=0)
      lit8  (B, RLP, 128) uint8  lit_full bytes
    """
    B = len(pieces_list)
    if per is None:
        per = serial.lane_ops_blocks(pieces_list, totals)
    if MAXB is None:
        MAXB = max(max(len(r[0]), 1) for r in per)
        MAXB = -(-MAXB // V9_GROUP) * V9_GROUP
    if RL is None:
        RL = max(-(-len(lit) // 128) for lit in lit_list) + 1
    RLP = _rows_for_v10(RL, "v10")
    NT = block // TILE
    NG = -(-MAXB // 128)
    nb = np.array([len(r[0]) for r in per], np.int32)
    ts = np.zeros((B, NT + 1), np.int32)
    pctrl = np.full((B, NG * 32, 128), 1 << 7, np.int32)
    lit8 = np.zeros((B, RLP, 128), np.uint8)
    for j, ((rows, rl, s, e, tile_start), lit) in enumerate(
            zip(per, lit_list)):
        k = len(rows)
        nts = len(tile_start) - 1
        ts[j, :nts + 1] = tile_start
        ts[j, nts + 1:] = tile_start[-1]
        packed = np.where(e > 0,
                          rl | (s << 7) | ((e - 1) << 14) | (rows << 21),
                          1 << 7)
        bat = np.arange(k)[:, None]
        sub = np.arange(32)[None, :]
        pctrl[j, 32 * (bat >> 7) + sub, bat & 127] = packed
        flat = np.frombuffer(bytes(lit), np.uint8)
        lit8[j].reshape(-1)[:len(flat)] = flat
    return nb, ts, pctrl, lit8


def v11_layers(per) -> int:
    """The static batch count a tile of v11 (the most any tile of the
    group has, rounded up to V9_UNROLL)."""
    layers = max(int(np.diff(r[4]).max(initial=1)) for r in per)
    return -(-layers // V9_UNROLL) * V9_UNROLL


def pack_blocks_v11(pieces_list, lit_list, totals, block: int,
                    per=None, LAYERS=None, RL=None):
    """Pack the v11 static-layers dispatch batch, as the JAX package's
    ``kernel_attic.pack_blocks_v11``; raises ValueError for a lit_full
    over 2048 rows.

    Returns (pctrl, lit8): pctrl (B, G32, 128) i32 as in v10 but with
    batch index bat = tile*LAYERS + layer; lit8 (B, RLP, 128) uint8.
    """
    B = len(pieces_list)
    if per is None:
        per = serial.lane_ops_blocks(pieces_list, totals)
    if LAYERS is None:
        LAYERS = v11_layers(per)
    if RL is None:
        RL = max(-(-len(lit) // 128) for lit in lit_list) + 1
    RLP = _rows_for_v10(RL, "v11")
    NT = block // TILE
    NB = NT * LAYERS
    NG = -(-NB // 128)
    pctrl = np.full((B, NG * 32, 128), 1 << 7, np.int32)
    lit8 = np.zeros((B, RLP, 128), np.uint8)
    for j, ((rows, rl, s, e, tile_start), lit) in enumerate(
            zip(per, lit_list)):
        k = len(rows)
        if k:
            # original batch index -> (tile, layer) -> static-stride index
            tl = np.searchsorted(tile_start, np.arange(k), side='right') - 1
            layer = np.arange(k) - tile_start[tl]
            if (layer >= LAYERS).any():
                raise ValueError(f"LAYERS {LAYERS} below a tile's layer "
                                 "count")
            bat = (tl * LAYERS + layer)[:, None]
            packed = np.where(e > 0,
                              rl | (s << 7) | ((e - 1) << 14) | (rows << 21),
                              1 << 7)
            sub = np.arange(32)[None, :]
            pctrl[j, 32 * (bat >> 7) + sub, bat & 127] = packed
        flat = np.frombuffer(bytes(lit), np.uint8)
        lit8[j].reshape(-1)[:len(flat)] = flat
    return pctrl, lit8


def _check_lane(pctrl, lit, block: int, mode: int, ts, rows,
                layers: int) -> None:
    if mode not in LANE_MODES:
        raise ValueError(f"lane-op mode {mode}: 9, 10 or 11")
    specs = [("pctrl", pctrl, torch.int32, 3),
             ("lit", lit, torch.int32 if mode == 9 else torch.uint8, 3)]
    if mode != 11:
        specs.append(("ts", ts, torch.int32, 2))
    if mode == 9:
        specs.append(("rows", rows, torch.int32, 2))
    _want(specs, pctrl.device)
    B = pctrl.shape[0]
    if (block % TILE or pctrl.shape[1] % 32 or pctrl.shape[2] != 128
            or lit.shape[0] != B or lit.shape[1] < 1 or lit.shape[2] != 128
            or (mode != 11 and ts.shape != (B, block // TILE + 1))
            or (mode == 9 and rows.shape[0] != B)
            or (mode == 11 and layers < 0)):
        raise ValueError(
            f"inconsistent lane-op shapes for block {block}, mode {mode}: "
            f"pctrl {tuple(pctrl.shape)}, lit {tuple(lit.shape)}, ts "
            f"{None if ts is None else tuple(ts.shape)}, rows "
            f"{None if rows is None else tuple(rows.shape)}, layers {layers}")


def lane_sum_reference(pctrl, lit, block: int, mode: int, ts=None,
                       rows=None, layers: int = 0,
                       probe: str | None = None) -> torch.Tensor:
    """Plain PyTorch version of the lane sum on any device: (B, block)
    uint8. ``ts`` for v9 and v10, ``rows`` for v9, ``layers`` for v11.

    ``probe`` (mode 10; ``LANE_PROBES``), with u = (bat - ts[b,t]) & 3 the
    batch's place in the TPU body's group of four: nomatmul adds
    ``lit[32u + k][(l + rl) & 127] + row`` (masked); noonehot
    ``lit[32u + k][(l + rl) & 127]`` (0 past the rows); nobcast takes
    ``BCAST_WORD`` for every slot; norotate ``lit[row][l]``; norotate_add
    ``lit[row][l] + rl`` (rl alone past the rows); nomask
    ``lit[row][(l + rl) & 127]`` on every lane of every slot; floor the
    control word itself on every lane."""
    _check_lane(pctrl, lit, block, mode, ts, rows, layers)
    if probe is not None and (mode != 10 or probe not in LANE_PROBES):
        raise ValueError(f"lane probe {probe} (mode {mode}): one of "
                         f"{sorted(LANE_PROBES)}, in mode 10")
    B, RL, NT = pctrl.shape[0], lit.shape[1], block // TILE
    dev = pctrl.device
    cap = pctrl.shape[1] // 32 * 128
    if mode == 9:
        cap = min(cap, rows.shape[1] // 32)
    if mode == 11:
        b0 = (torch.arange(NT, device=dev) * layers).expand(B, NT)
        n = 4 * (layers // 4)
    else:
        b0 = ts[:, :-1].long()
        n = torch.div(ts[:, 1:].long() - b0, 4, rounding_mode="floor") * 4
    lo, hi = b0.clamp(0, cap), (b0 + n).clamp(0, cap)
    cnt = (hi - lo).clamp_min(0).reshape(-1)
    tile = torch.repeat_interleave(torch.arange(B * NT, device=dev), cnt)
    first = torch.cumsum(cnt, 0) - cnt
    bat = (lo.reshape(-1)[tile] + torch.arange(len(tile), device=dev)
           - first[tile])[:, None]
    b = tile[:, None] // NT
    k = torch.arange(32, device=dev)
    c = pctrl[b, 32 * (bat >> 7) + k, bat & 127].long()      # (pairs, 32)
    if probe == "nobcast":
        c = torch.full_like(c, BCAST_WORD)
    if mode == 9:
        rl, s, e1 = c & 255, (c >> 8) & 255, (c >> 16) & 255
        row = rows[b, 32 * bat + k].long()
        row = torch.where(row < 0, row + RL, row).clamp(0, RL - 1)
        live = s <= e1
    else:
        rl, s, e1 = c & 127, (c >> 7) & 127, (c >> 14) & 127
        row = (c >> 21) & ((1 << V10_ROWBITS) - 1)
        live = (s <= e1) & (row < RL) if probe is None else s <= e1
    src_row, roll, extra = row, rl, torch.zeros_like(row)
    if probe in ("nomatmul", "noonehot"):     # slot 32u + k's own row
        src_row = 32 * ((bat - b0.reshape(-1)[tile][:, None]) & 3) + k
    if probe in ("norotate", "norotate_add"):
        roll = torch.zeros_like(rl)
    if probe == "nomatmul":
        extra = row
    elif probe == "norotate_add":
        extra = rl
    elif probe == "floor":
        extra = c & 255
    low = (lit.reshape(-1) & 255).int() if mode == 9 else lit.reshape(-1).int()
    base = (b * RL + src_row.clamp(max=RL - 1)) * 128
    in_rows = (src_row < RL) & (probe != "floor")
    unmasked = probe in ("nomask", "floor")
    lane = torch.arange(128, device=dev)
    acc = torch.zeros((B * NT, 32, 128), dtype=torch.int32, device=dev)
    for c0 in range(0, len(tile), LANE_PAIRS):
        sl = slice(c0, c0 + LANE_PAIRS)
        v = low[base[sl, :, None] + ((lane + roll[sl, :, None]) & 127)]
        v = (torch.where(in_rows[sl, :, None], v, 0)
             + extra[sl, :, None]).int()
        if not unmasked:
            v = torch.where(live[sl, :, None] & (lane >= s[sl, :, None])
                            & (lane <= e1[sl, :, None]), v, 0)
        acc.index_add_(0, tile[sl], v)
    return (acc & 255).to(torch.uint8).reshape(B, block)


def lane_sum(pctrl, lit, block: int, mode: int, ts=None, rows=None,
             layers: int = 0) -> torch.Tensor:
    """The lane sum (v9-v11) over one dispatch group: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Returns (B, block)
    uint8."""
    if pctrl.device.type == "cpu":
        return lane_sum_reference(pctrl, lit, block, mode, ts, rows, layers)
    if pctrl.device.type != "cuda":
        raise ValueError(f"lane_sum runs on cuda or cpu, not "
                         f"{pctrl.device}")
    _check_lane(pctrl, lit, block, mode, ts, rows, layers)
    _launchable("lane_sum", [t for t in (pctrl, lit, ts, rows)
                             if t is not None], pctrl.shape[0])
    from . import _build
    B = pctrl.shape[0]
    out = torch.empty((B, block), dtype=torch.uint8, device=pctrl.device)
    with torch.cuda.device(pctrl.device):
        _launch("zxc_lane_sum", _build.attic_kernels().zxc_lane_sum,
                0 if ts is None else ts.data_ptr(),
                0 if rows is None else rows.data_ptr(),
                0 if rows is None else rows.shape[1], pctrl.data_ptr(),
                pctrl.shape[1], lit.data_ptr(), lit.shape[1], out.data_ptr(),
                B, block, mode, layers)
    lane_sum.launches += 1
    return out


lane_sum.launches = 0


def bytes_moved_lane(pctrl: np.ndarray, lit_fulls, block: int, mode: int,
                     ts: np.ndarray | None = None,
                     nb: np.ndarray | None = None,
                     probe: str | None = None) -> int:
    """The bytes one lane sum must move: ``ts`` and ``nb`` where the
    packer makes them, 4 bytes of control a live op slot (s <= e1; v9
    also its 4-byte row), each ``lit_full`` byte once and the (B, block)
    uint8 output once. A ``probe`` reads what its function needs: nomask
    and floor every slot of the ``nb`` batches, nobcast no control; the
    literal rows 0-127 (nomatmul, noonehot), 4 bytes of row 200 (nobcast)
    or none (floor)."""
    c = pctrl.astype(np.int64)
    if mode == 9:
        live = ((c >> 8) & 255) <= ((c >> 16) & 255)
    else:
        live = ((c >> 7) & 127) <= ((c >> 14) & 127)
    control = (8 if mode == 9 else 4) * int(live.sum())
    lit = sum(len(lf) for lf in lit_fulls)
    if probe in ("nomask", "floor"):
        control = 4 * 32 * int(nb.sum())
    elif probe == "nobcast":
        control = 0
    if probe in ("nomatmul", "noonehot"):
        lit = sum(min(len(lf), 128 * 128) for lf in lit_fulls)
    elif probe == "nobcast":
        lit = sum(4 for lf in lit_fulls if len(lf) > 200 * 128)
    elif probe == "floor":
        lit = 0
    return (sum(a.nbytes for a in (ts, nb) if a is not None) + control
            + lit + len(pctrl) * block)


def decode_blocks_v9(pieces_list, lit_list, totals, block: int, device=None,
                     dispatch: int = 16, *,
                     _phases: dict | None = None) -> list[bytes]:
    """Decode device_pure piece plans through the lane sum in v9's layout
    (the JAX package's ``kernel_attic.decode_blocks_v9``), one launch per
    dispatch group; ``device`` and ``_phases`` as ``decode_blocks_v4``."""
    dev = _device(device, "attic.decode_blocks_v9")

    def group(p, lf, t):
        nb, ts, rows, pctrl, lit32 = pack_blocks_v9(p, lf, t, block)
        return ((ts, rows, pctrl, lit32),
                lambda ts, rows, pctrl, lit32: lane_sum(
                    pctrl, lit32, block, 9, ts=ts, rows=rows))

    return _decode(pieces_list, lit_list, totals, dev, dispatch, _phases,
                   group)


def decode_blocks_v10(pieces_list, lit_list, totals, block: int,
                      device=None, dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through the lane sum in v10's layout (the JAX package's
    ``kernel_attic.decode_blocks_v10``); as ``decode_blocks_v9``, and a
    ValueError for a lit_full over 2048 rows."""
    dev = _device(device, "attic.decode_blocks_v10")

    def group(p, lf, t):
        nb, ts, pctrl, lit8 = pack_blocks_v10(p, lf, t, block)
        return ((ts, pctrl, lit8), lambda ts, pctrl, lit8: lane_sum(
            pctrl, lit8, block, 10, ts=ts))

    return _decode(pieces_list, lit_list, totals, dev, dispatch, _phases,
                   group)


def decode_blocks_v11(pieces_list, lit_list, totals, block: int,
                      device=None, dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through the lane sum in v11's layout (the JAX package's
    ``kernel_attic.decode_blocks_v11``); as ``decode_blocks_v10``."""
    dev = _device(device, "attic.decode_blocks_v11")

    def group(p, lf, t):
        per = serial.lane_ops_blocks(p, t)
        layers = v11_layers(per)
        pctrl, lit8 = pack_blocks_v11(p, lf, t, block, per=per,
                                      LAYERS=layers)
        return ((pctrl, lit8), lambda pctrl, lit8: lane_sum(
            pctrl, lit8, block, 11, layers=layers))

    return _decode(pieces_list, lit_list, totals, dev, dispatch, _phases,
                   group)


KERNELS = {"attic": piece_serial, "window_merge": window_merge,
           "lane_sum": lane_sum}
