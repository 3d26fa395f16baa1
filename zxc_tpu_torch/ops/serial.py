"""Serial copy-engine route of ``ops.batch.decompress``: the host half of
``zxc_tpu/ops/pallas_decode.py`` for the port.

Per block the resolver's pure pieces (``runtime.resolve_pieces(
device_pure=True, max_frag=1)``) go through the native lane-op splitter
and a numpy packer into the copy engine's control: ``pack_blocks_v12``
for v13 (one op per slot, 32-row tiles, blocks under 16 KiB) and
``pack_blocks_v19`` for v19 (multi-op slots, 128-row supertiles). The
packers are the JAX package's, copied bit for bit. Each dispatch group
goes to the device once and runs one kernel launch
(``copy_engine.v13`` / ``v19``); the output bytes are the kernels' int32
tiles reduced mod 256, as the JAX consumers reduce them.

v25 (``decode_blocks_v25``, the JAX package's ``pallas_decode.v25_kernel``
and ``pack_blocks_v25``, reached there only by
``tools/tpu_v25_selfref.py``) takes plans resolved with ``self_ref=True``
(``batch.resolve_serial(plan, self_ref=True)``): a KOUT piece copies the
block's own output from a source that completes before its destination's
16 KiB supertile. ``lane_ops_blocks_v25`` moves those sources into a
sentinel row space (``OUT_SENT_ROWS``), so the packer chunks them into
quads of their own whose ``qbase`` carries ``copy_engine.OUT_QB_FLAG``,
and ``copy_engine.v25`` reads their rows from the supertiles it has
already stored.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..errors import ZxcError, ERROR_CORRUPT_DATA
from .. import runtime
from . import copy_engine
from .device_pipeline import _add, _device

OUT_SENT_ROWS = 1 << 15          # v25: sentinel row base of OUT sources
OUT_SENT_BYTES = OUT_SENT_ROWS * 128
OUT_QB_FLAG = copy_engine.OUT_QB_FLAG
SUPERTILE = 16384                # output bytes of a 128-row supertile


def lane_ops_blocks(pieces_list, totals):
    """Per-block native lane-op emission (``zxch_lane_ops``). Returns a
    list of (rows, roll, s, e, tile_start) tuples."""
    per = []
    for (po, pc, ps, pk), total in zip(pieces_list, totals):
        r = runtime.lane_ops(po, pc, ps, pk, int(total))
        if r is None:
            raise ZxcError(ERROR_CORRUPT_DATA, "lane_ops budget exceeded")
        per.append(r)
    return per


def lane_ops_blocks_v25(pieces_list, totals):
    """``lane_ops_blocks`` over plans that may hold KOUT pieces: their
    output-coordinate sources move into the sentinel row space and their
    kind becomes pure, so the native splitter needs no change."""
    shifted = []
    for po, pc, ps, pk in pieces_list:
        kout = pk == np.int32(runtime.KOUT)
        if kout.any():
            pc = np.where(kout, pc + np.int32(OUT_SENT_BYTES), pc)
            pk = np.where(kout, np.int32(1 << 30), pk)
        shifted.append((po, pc, ps, pk))
    return lane_ops_blocks(shifted, totals)


def window_chunks(src, base_align: int = 16, out_base_max=None):
    """Split row-sorted sources into runs of at most 128 whose rows lie
    within 127 of the run's base (the first row rounded down to
    ``base_align``, as the bodies' aligned window loads need): [(base, i,
    j)]. ``out_base_max`` (v25): the base of a run of OUT sources (at or
    past ``OUT_SENT_ROWS``) is at most this, so its window fits the
    block's output rows."""
    out = []
    i, n = 0, len(src)
    while i < n:
        base = int(src[i]) & ~(base_align - 1)
        if out_base_max is not None and src[i] >= OUT_SENT_ROWS:
            base = min(base, out_base_max)
        j = min(i + 128, n)
        while src[j - 1] - base > 127:       # shrink until the window fits
            j -= 1
        out.append((base, i, j))
        i = j
    return out


def supertile_ops(rows, rl, s, e, tile_start, st: int):
    """The live lane ops of 128-row supertile ``st`` (its four 32-row
    tiles) as int64 rows [src, tgt, rl, s, e - 1], or None."""
    parts = []
    nts = len(tile_start) - 1
    for g in range(4):
        t = st * 4 + g
        if t >= nts:
            break
        b0, b1 = tile_start[t], tile_start[t + 1]
        if b1 <= b0:
            continue
        er = rows[b0:b1].reshape(-1)
        es = s[b0:b1].reshape(-1)
        ee = e[b0:b1].reshape(-1)
        erl = rl[b0:b1].reshape(-1)
        live = np.nonzero(ee > es)[0]
        if not len(live):
            continue
        tgt = (live & 31) + 32 * g
        parts.append(np.stack([er[live], tgt, erl[live], es[live],
                               ee[live] - 1], axis=1))
    return np.concatenate(parts, axis=0) if parts else None


def group_slots(ops, K: int):
    """Ops [src, tgt, rl, s, e - 1] sharing (src, tgt) grouped into slots of
    K sub-ops: (ssrc, stgt, sctl (n, K, 3), sub-ops a slot holds); an empty
    sub-op is s=1 > e-1=0."""
    if ops is None:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros((0, K, 3), np.int64), z
    key = ops[:, 0] * 128 + ops[:, 1]
    order = np.argsort(key, kind="stable")
    ops = ops[order]
    ks = key[order]
    new = np.r_[True, ks[1:] != ks[:-1]]
    gid = np.cumsum(new) - 1
    gstart = np.flatnonzero(new)
    within = np.arange(len(ks)) - gstart[gid]
    gsizes = np.diff(np.r_[gstart, len(ks)])
    spg = -(-gsizes // K)
    sbase = np.r_[0, np.cumsum(spg)[:-1]]
    slot_of = sbase[gid] + within // K
    sub_of = within % K
    n_slots = int(spg.sum())
    ssrc = np.zeros(n_slots, np.int64)
    stgt = np.zeros(n_slots, np.int64)
    sctl = np.zeros((n_slots, K, 3), np.int64)
    sctl[:, :, 1] = 1
    ssrc[slot_of] = ops[:, 0]
    stgt[slot_of] = ops[:, 1]
    sctl[slot_of, sub_of, 0] = ops[:, 2]
    sctl[slot_of, sub_of, 1] = ops[:, 3]
    sctl[slot_of, sub_of, 2] = ops[:, 4]
    return ssrc, stgt, sctl, np.bincount(slot_of, minlength=n_slots)


def pack_blocks_v12(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, quad_align: int = 1):
    """Pack the v12 dispatch batch.

    Returns (qs, qbase, pctrl, tq, lit8):
      qs    (B, NT+1)      int32  per-tile quad prefix      (scalar prefetch)
      qbase (B, MAXQ)      int32  8-aligned lit row base per quad (prefetch)
      pctrl (B, G32, 128)  int32  pre-transposed packed control for slot
                                  i = 32*u + k of quad q (bat = 4q + u):
                                  pctrl[b, 32*(bat>>7)+k, bat&127] =
                                      roll | s<<7 | (e-1)<<14 | rowrel<<21
                                  (empty slots: s=1, e-1=0)
      tq    (B, MAXQ, 128) int32  lane-major target row per slot
      lit8  (B, RLP, 128)  uint8  lit_full bytes, RLP >= max qbase + 128
    """
    B = len(pieces_list)
    if per is None:
        per = lane_ops_blocks(pieces_list, totals)
    NT = block // 4096
    # pass 1: recover raw ops per (block, tile) from the layered layout and
    # chunk row-sorted ops into window-constrained quads
    blocks = []
    maxq = 1
    maxrow = 0
    for (rows, rl, s, e, tile_start) in per:
        nb = len(rows)
        quads = []          # per tile: list of (base, ops[(rowrel,rl,s,e1,tgt)])
        qs_t = [0]
        for t in range(len(tile_start) - 1):
            b0, b1 = tile_start[t], tile_start[t + 1]
            er = rows[b0:b1].reshape(-1)
            es = s[b0:b1].reshape(-1)
            ee = e[b0:b1].reshape(-1)
            erl = rl[b0:b1].reshape(-1)
            live = np.nonzero(ee > es)[0] if b1 > b0 else np.zeros(0, int)
            tgt = live & 31
            order = np.argsort(er[live], kind="stable")
            lr = er[live][order]
            lops = np.stack([lr, erl[live][order], es[live][order],
                             ee[live][order] - 1, tgt[order]], axis=1) \
                if len(live) else np.zeros((0, 5), np.int64)
            for base, i, j in window_chunks(lops[:, 0]):
                quads.append((base, lops[i:j]))
                maxrow = max(maxrow, base + 128)
            if len(lops) == 0:
                quads.append((0, lops))
                maxrow = max(maxrow, 128)
            while (len(quads) - qs_t[-1]) % quad_align:
                quads.append((0, np.zeros((0, 5), np.int64)))
                maxrow = max(maxrow, 128)
            qs_t.append(len(quads))
        blocks.append((qs_t, quads))
        maxq = max(maxq, len(quads))
    if MAXQ is None:
        MAXQ = maxq
    assert maxq <= MAXQ, "MAXQ below a block's quad count"
    if RL is None:
        RL = max(maxrow, max(-(-len(lit) // 128) for lit in lit_list) + 1)
    RLP = max(-(-RL // 16) * 16, -(-maxrow // 16) * 16)
    NB = MAXQ * 4
    NG = -(-NB // 128)
    qs = np.zeros((B, NT + 1), np.int32)
    qbase = np.zeros((B, MAXQ), np.int32)
    pctrl = np.full((B, NG * 32, 128), 1 << 7, np.int32)
    tq = np.zeros((B, MAXQ, 128), np.int32)
    lit8 = np.zeros((B, RLP, 128), np.uint8)
    for j, ((qs_t, quads), lit) in enumerate(zip(blocks, lit_list)):
        qs[j, :len(qs_t)] = qs_t
        qs[j, len(qs_t):] = qs_t[-1]
        for q, (base, lops) in enumerate(quads):
            qbase[j, q] = base
            if not len(lops):
                continue
            i = np.arange(len(lops))
            bat = 4 * q + (i >> 5)
            sub = i & 31
            packed = (lops[:, 1] | (lops[:, 2] << 7) | (lops[:, 3] << 14)
                      | ((lops[:, 0] - base) << 21))
            pctrl[j, 32 * (bat >> 7) + sub, bat & 127] = packed
            tq[j, q, i] = lops[:, 4]
        flat = np.frombuffer(bytes(lit), np.uint8)
        lit8[j].reshape(-1)[:len(flat)] = flat
    return qs, qbase, pctrl, tq, lit8


def pad_v12_set(s, MAXQ: int, RLP: int):
    """Pad one pack_blocks_v12 result to a common (MAXQ, RLP) shape.

    Padded quads never execute (the qs tile prefix never reaches them)
    and pctrl's filler value 1<<7 encodes an empty slot (s=1 > e-1=0),
    so padding is equivalent to repacking with explicit MAXQ/RL.
    """
    qs, qb, pc, tq, l8 = s
    NG32 = 32 * (-(-(MAXQ * 4) // 128))
    qb = np.pad(qb, ((0, 0), (0, MAXQ - qb.shape[1])))
    tq = np.pad(tq, ((0, 0), (0, MAXQ - tq.shape[1]), (0, 0)))
    pc = np.pad(pc, ((0, 0), (0, NG32 - pc.shape[1]), (0, 0)),
                constant_values=1 << 7)
    l8 = np.pad(l8, ((0, 0), (0, RLP - l8.shape[1]), (0, 0)))
    return (qs, qb, pc, tq, l8)


def pack_blocks_v19(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, quad_align: int = 2,
                    K: int = 2):
    """Pack the v19 dispatch batch: (src,tgt)-grouped multi-op slots.

    Returns (qs, qbase, pctrl, tq, lit8) shaped as pack_blocks_v15's
    output except pctrl is (B, K*NG32, 128) with one plane per sub-op."""
    if per is None:
        per = lane_ops_blocks(pieces_list, totals)
    return _pack_slots(per, lit_list, block, MAXQ, RL, quad_align, K,
                       out_plane=False)


def pack_blocks_v25(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, quad_align: int = 2,
                    K: int = 2):
    """Pack the v25 dispatch batch: v19's layout, with the quads of OUT
    sources (``lane_ops_blocks_v25``) chunked apart, their window base
    clamped to NR - 128 and their ``qbase`` the output row plus
    ``OUT_QB_FLAG``; RLP counts lit windows only."""
    if per is None:
        per = lane_ops_blocks_v25(pieces_list, totals)
    return _pack_slots(per, lit_list, block, MAXQ, RL, quad_align, K,
                       out_plane=True)


def _pack_slots(per, lit_list, block: int, MAXQ, RL, quad_align: int,
                K: int, out_plane: bool):
    """The packing of v19 and (``out_plane``) v25."""
    B = len(per)
    NR = block // 128
    assert NR % 128 == 0, "v19 needs block >= 16384"
    NST = NR // 128
    out_base_max = OUT_SENT_ROWS + NR - 128 if out_plane else None
    blocks = []
    maxq = 1
    maxrow = 0
    for (rows, rl, s, e, tile_start) in per:
        quads = []          # (base, src[], tgt[], ctl[n,K,3])
        qs_t = [0]
        for st in range(NST):
            ssrc, stgt, sctl, _ = group_slots(
                supertile_ops(rows, rl, s, e, tile_start, st), K)
            for base, i, j in window_chunks(ssrc, out_base_max=out_base_max):
                quads.append((base, ssrc[i:j], stgt[i:j], sctl[i:j]))
                if not out_plane or base < OUT_SENT_ROWS:   # lit windows
                    maxrow = max(maxrow, base + 128)
            if len(ssrc) == 0:
                quads.append((0, ssrc, stgt, sctl))
                maxrow = max(maxrow, 128)
            while (len(quads) - qs_t[-1]) % quad_align:
                quads.append((0, np.zeros(0, np.int64),
                              np.zeros(0, np.int64),
                              np.zeros((0, K, 3), np.int64)))
                maxrow = max(maxrow, 128)
            qs_t.append(len(quads))
        blocks.append((qs_t, quads))
        maxq = max(maxq, len(quads))
    if MAXQ is None:
        MAXQ = maxq
    assert maxq <= MAXQ, "MAXQ below a block's quad count"
    if RL is None:
        RL = max(maxrow, max(-(-len(lit) // 128) for lit in lit_list) + 1)
    RLP = max(-(-RL // 16) * 16, -(-maxrow // 16) * 16)
    NB = MAXQ * 4
    NG32 = 32 * (-(-NB // 128))
    qs = np.zeros((B, NST + 1), np.int32)
    qbase = np.zeros((B, MAXQ), np.int32)
    pctrl = np.full((B, K * NG32, 128), 1 << 7, np.int32)
    tq = np.zeros((B, MAXQ, 128), np.uint8)   # tgt < 128: u8 quarters H2D
    lit8 = np.zeros((B, RLP, 128), np.uint8)
    for j, ((qs_t, quads), lit) in enumerate(zip(blocks, lit_list)):
        qs[j, :len(qs_t)] = qs_t
        qs[j, len(qs_t):] = qs_t[-1]
        for q, (base, ssrc, stgt, sctl) in enumerate(quads):
            qbase[j, q] = (base - OUT_SENT_ROWS + OUT_QB_FLAG
                           if out_plane and base >= OUT_SENT_ROWS else base)
            n = len(ssrc)
            if not n:
                continue
            i = np.arange(n)
            bat = 4 * q + (i >> 5)
            sub = i & 31
            p0 = (sctl[:, 0, 0] | (sctl[:, 0, 1] << 7)
                  | (sctl[:, 0, 2] << 14) | ((ssrc - base) << 21))
            pctrl[j, 32 * (bat >> 7) + sub, bat & 127] = p0
            for kk in range(1, K):
                pk_ = (sctl[:, kk, 0] | (sctl[:, kk, 1] << 7)
                       | (sctl[:, kk, 2] << 14))
                pctrl[j, kk * NG32 + 32 * (bat >> 7) + sub, bat & 127] = pk_
            tq[j, q, i] = stgt
        flat = np.frombuffer(bytes(lit), np.uint8)
        lit8[j].reshape(-1)[:len(flat)] = flat
    return qs, qbase, pctrl, tq, lit8


def pad_v19_set(s, MAXQ: int, RLP: int, K: int = 2):
    """Pad one pack_blocks_v19 result to a common (MAXQ, RLP) shape."""
    qs, qb, pc, tq, l8 = s
    NG32 = 32 * (-(-(MAXQ * 4) // 128))
    B = pc.shape[0]
    old_g = pc.shape[1] // K
    qb = np.pad(qb, ((0, 0), (0, MAXQ - qb.shape[1])))
    tq = np.pad(tq, ((0, 0), (0, MAXQ - tq.shape[1]), (0, 0)))
    pc = pc.reshape(B, K, old_g, 128)
    pc = np.pad(pc, ((0, 0), (0, 0), (0, NG32 - old_g), (0, 0)),
                constant_values=1 << 7).reshape(B, K * NG32, 128)
    l8 = np.pad(l8, ((0, 0), (0, RLP - l8.shape[1]), (0, 0)))
    return (qs, qb, pc, tq, l8)

def _groups(pieces_list, lit_list, totals, dispatch: int):
    """Split blocks into groups of min(dispatch, nb); the last group pads
    with copies of the last block whose totals are 0 (as the JAX package
    pads)."""
    nb = len(pieces_list)
    B = min(dispatch, nb)
    nd = -(-nb // B)
    pad = nd * B - nb
    p = list(pieces_list) + [pieces_list[-1]] * pad
    lits = list(lit_list) + [lit_list[-1]] * pad
    t = list(totals) + [0] * pad
    return [(p[d * B:(d + 1) * B], lits[d * B:(d + 1) * B],
             t[d * B:(d + 1) * B]) for d in range(nd)]


def pack_groups(pieces_list, lit_list, totals, block: int, v13: bool,
                dispatch: int = 16, K: int = 2):
    """Every dispatch group's packed control for v13 (``pack_blocks_v12``)
    or v19 (``pack_blocks_v19``), padded to one (MAXQ, RLP) bucket
    (multiples of 32 quads and 128 rows) as the JAX package's
    ``decode_blocks_v13`` / ``decode_blocks_v19`` pad them."""
    groups = _groups(pieces_list, lit_list, totals, dispatch)
    if v13:
        raw = [pack_blocks_v12(p, l, t, block, quad_align=2)
               for p, l, t in groups]
    else:
        raw = [pack_blocks_v19(p, l, t, block, K=K) for p, l, t in groups]
    MAXQ = -(-max(s[1].shape[1] for s in raw) // 32) * 32
    RLP = -(-max(s[4].shape[1] for s in raw) // 128) * 128
    if v13:
        return [pad_v12_set(s, MAXQ, RLP) for s in raw]
    return [pad_v19_set(s, MAXQ, RLP, K) for s in raw]


def decode_groups(groups, totals, block: int, v13: bool,
                  device: torch.device, K: int = 2) -> list[bytes]:
    """Run each packed group through its kernel on ``device`` (one launch
    each) and cut each block's bytes."""
    outs = []
    for args in groups:
        t = copy_engine.group_from_numpy(*args, device=device)
        outs.append(copy_engine.v13(*t) if v13 else copy_engine.v19(*t, K=K))
    host = torch.cat(outs).view(-1, block).cpu().numpy()
    return [host[j, :totals[j]].tobytes() for j in range(len(totals))]



def pack_groups_v25(pieces_list, lit_list, totals, block: int,
                    dispatch: int = 16, K: int = 2):
    """``pack_blocks_v25`` of every dispatch group (the last padded with
    copies of the last block whose totals are 0), padded to one (MAXQ,
    RLP), as ``tools/tpu_v25_selfref.py`` packs them."""
    raw = [pack_blocks_v25(p, l, t, block, quad_align=2, K=K)
           for p, l, t in _groups(pieces_list, lit_list, totals, dispatch)]
    MAXQ = max(s[1].shape[1] for s in raw)
    RLP = max(s[4].shape[1] for s in raw)
    return [pad_v19_set(s, MAXQ, RLP, K) for s in raw]


def decode_blocks_v25(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode plans resolved with ``self_ref=True`` through v25, one
    ``copy_engine.v25`` launch per dispatch group. Blocks must be a
    multiple of 16 KiB and at least 32 KiB: the JAX packer asserts below
    16 KiB, and a block of one supertile has no source that completes
    before its destination's supertile (ValueError). ``device``: None
    means cuda (raises without it); "cpu" runs the plain version.
    ``_phases`` receives the ``pack`` and ``device`` seconds. Returns each
    block's bytes."""
    if block < 2 * SUPERTILE or block % SUPERTILE:
        raise ValueError(f"v25 needs a block of at least 32768 bytes and a "
                         f"multiple of {SUPERTILE}, not {block}")
    dev = _device(device, "serial.decode_blocks_v25")
    if not len(pieces):
        return []
    t0 = time.perf_counter()
    groups = pack_groups_v25(pieces, lits, totals, block, dispatch)
    t0 = _add(_phases, "pack", t0)
    outs = [copy_engine.v25(*copy_engine.group_from_numpy(*g, device=dev))
            for g in groups]
    host = torch.cat(outs).view(-1, block).cpu().numpy()
    _add(_phases, "device", t0)
    return [host[j, :totals[j]].tobytes() for j in range(len(totals))]
