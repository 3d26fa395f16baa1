"""The port of ``tools/kernel_attic.py:1150-2779``: the attic's quad-tile
generations v12, v14, v15, v16, v17, v20, v21 and, with no JAX entry of
their own (``tools/tpu_ab_probe.py:56-70`` pairs their packers with
kernels), v22, v23 and v24. Each has its packer (the JAX package's, array
for array), one mode of the copy engine's tile kernel
(``copy_engine.quad``, ``csrc/copy_engine.cu``) with its plain PyTorch
version, and a decode entry that launches once per dispatch group.

The function (``copy_engine.quad``): for tile t of block b, the quads the
body's loop reaches add, slot by slot, a lane-masked, rolled row of the
block's literal window ``lit8`` (at ``qbase[b, q]`` plus the slot's
7-bit row) into target row ``tq[b, q, i]`` of an int32 tile, stored mod
256. The generations differ in tile height (32 rows for v12 and v14, 128
for the rest), in how a tile's quad count is walked (every quad for v12;
fours then ones for v14; pairs for v15, v17, v21, v23, v24; fours for v16;
two pair-floored ranges for v20 and v22, the first reading plane 0 only),
in the planes read (one up to v17, K = 2 from v20), in the rows of
``pctrl`` (plane-interleaved for v23) and in the TPU's number carriers
(bf16; int8 for v17; f32 for v24), which give the same sums mod 256.

Packers: ``serial.pack_blocks_v12`` (v12, v14; 32-row tiles),
``pack_blocks_v15`` (v15; ``quad_align=4`` for v16, ``base_align=32`` for
v17), ``pack_blocks_v20`` (segregated single- and multi-op quads, qs of
width 2 * NST + 1), ``pack_blocks_v22`` (v20's layout with multi-op quads
absorbing single-op slots), ``serial.pack_blocks_v19`` (v21, v24) and
``pack_blocks_v23`` (v19's arrays with the planes of ``pctrl``
interleaved). Where the JAX packers assert, these raise ValueError.

Entries ``decode_blocks_vN(pieces, lits, totals, block, device=None,
dispatch=16, *, _phases=None)`` run on resolver plans
(``ops.batch.resolve_serial``), pack and launch each dispatch group in
turn (``_phases`` receives ``pack`` and ``device`` seconds) and return each
block's bytes. ``device``: None means cuda (raises without it), "cpu" runs
the plain version. Below 16 KiB blocks v15, v16, v17, v20 and v21 decode
through the v13 group route, as their JAX entries do; v22, v23 and v24
raise ValueError there. v12 with ``dispatch=None`` packs all blocks into
one launch, as its JAX entry does.
"""
from __future__ import annotations

import functools
import time

import numpy as np

from . import copy_engine, serial
from .attic import _decode
from .device_pipeline import _add, _device

SUPERTILE = 16384       # output bytes of a 128-row supertile


def _need_supertiles(block: int, name: str) -> int:
    """NST of ``block``; raises ValueError where the JAX packers assert
    (``(block // 128) % 128``)."""
    if (block // 128) % 128:
        raise ValueError(f"{name} needs block >= 16384, not {block}")
    return block // SUPERTILE


def _check_maxq(maxq: int, MAXQ: int) -> None:
    if maxq > MAXQ:
        raise ValueError(f"MAXQ {MAXQ} below a block's quad count {maxq}")


def _lit_rows(lit_list, maxrow: int, RL):
    if RL is None:
        RL = max(maxrow, max(-(-len(lit) // 128) for lit in lit_list) + 1)
    return max(-(-RL // 16) * 16, -(-maxrow // 16) * 16)


def _fill_lit(lit8, j: int, lit) -> None:
    flat = np.frombuffer(bytes(lit), np.uint8)
    lit8[j].reshape(-1)[:len(flat)] = flat


# -- v15, v16, v17 -------------------------------------------------------------

def pack_blocks_v15(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, quad_align: int = 2,
                    base_align: int = 16):
    """Pack the v15 dispatch batch, as the JAX package's
    ``kernel_attic.pack_blocks_v15``: ``serial.pack_blocks_v12``'s arrays
    with quads grouped per 128-row supertile (qs (B, NST+1)) and 7-bit
    target rows in int32 ``tq``. ``quad_align`` pads each supertile's quad
    count (4 for v16), ``base_align`` aligns window bases (32 for v17).
    Raises ValueError below 16 KiB blocks or for MAXQ below a block's
    quads."""
    B = len(pieces_list)
    if per is None:
        per = serial.lane_ops_blocks(pieces_list, totals)
    NST = _need_supertiles(block, "v15")
    blocks = []
    maxq = 1
    maxrow = 0
    empty = np.zeros((0, 5), np.int64)
    for (rows, rl, s, e, tile_start) in per:
        quads = []
        qs_t = [0]
        for st in range(NST):
            ops = serial.supertile_ops(rows, rl, s, e, tile_start, st)
            # [src, rl, s, e - 1, tgt], stably sorted by src
            lops = empty if ops is None else ops[:, [0, 2, 3, 4, 1]]
            lops = lops[np.argsort(lops[:, 0], kind="stable")]
            for base, i, j in serial.window_chunks(lops[:, 0], base_align):
                quads.append((base, lops[i:j]))
                maxrow = max(maxrow, base + 128)
            if len(lops) == 0:
                quads.append((0, lops))
                maxrow = max(maxrow, 128)
            while (len(quads) - qs_t[-1]) % quad_align:
                quads.append((0, empty))
                maxrow = max(maxrow, 128)
            qs_t.append(len(quads))
        blocks.append((qs_t, quads))
        maxq = max(maxq, len(quads))
    if MAXQ is None:
        MAXQ = maxq
    _check_maxq(maxq, MAXQ)
    RLP = _lit_rows(lit_list, maxrow, RL)
    NG = -(-(MAXQ * 4) // 128)
    qs = np.zeros((B, NST + 1), np.int32)
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
            packed = (lops[:, 1] | (lops[:, 2] << 7) | (lops[:, 3] << 14)
                      | ((lops[:, 0] - base) << 21))
            pctrl[j, 32 * (bat >> 7) + (i & 31), bat & 127] = packed
            tq[j, q, i] = lops[:, 4]
        _fill_lit(lit8, j, lit)
    return qs, qbase, pctrl, tq, lit8


# -- v20, v22: segregated quads, double-width qs ----------------------------

def _chunk_v20(ssrc, stgt, sctl, sel):
    """v20's per-class chunks of the slots ``sel`` (source-sorted)."""
    src_c, tgt_c, ctl_c = ssrc[sel], stgt[sel], sctl[sel]
    return [(base, src_c[i:j], tgt_c[i:j], ctl_c[i:j])
            for base, i, j in serial.window_chunks(src_c)]


def _greedy_chunks(idx, src, run):
    """v22's chunking of slots ``idx`` with sources ``src`` (sorted): a run
    from i grows while the next source lies within 127 of the base and the
    run holds fewer than 128 slots; ``run(base, i, j)`` makes each quad."""
    out = []
    i, n = 0, len(idx)
    while i < n:
        base = int(src[i]) & ~15
        j = i + 1
        while j < n and j - i < 128 and src[j] - base <= 127:
            j += 1
        out.append(run(base, i, j))
        i = j
    return out


def _v22_quads(ssrc, stgt, sctl, n_subs):
    """v22's quads of one supertile: multi-op quads first in the list of
    runs, each absorbing up to its free slots of single-op slots inside its
    window; then the remaining singles. Returns (single quads, multi
    quads)."""
    quad = lambda base, sel: (base, ssrc[sel], stgt[sel], sctl[sel])
    order = np.argsort(ssrc, kind="stable")
    mul_o = (n_subs > 1)[order]
    mult_i = order[mul_o]
    sing_i = order[~mul_o]
    sing_src = ssrc[sing_i]
    sing_used = np.zeros(len(sing_i), bool)

    def multi(base, i, j):
        sel = list(mult_i[i:j])
        cap = 128 - (j - i)
        if cap > 0:
            a = np.searchsorted(sing_src, base)
            b = np.searchsorted(sing_src, base + 128)
            avail = np.nonzero(~sing_used[a:b])[0][:cap] + a
            if len(avail):
                sing_used[avail] = True
                sel.extend(sing_i[avail])
        return quad(base, np.asarray(sel, np.int64))

    multi_quads = _greedy_chunks(mult_i, ssrc[mult_i], multi)
    rest = sing_i[~sing_used]
    ro = np.argsort(ssrc[rest], kind="stable")
    rest = rest[ro]
    single_quads = _greedy_chunks(rest, ssrc[rest],
                                  lambda base, i, j: quad(base, rest[i:j]))
    return single_quads, multi_quads


def _pack_split(pieces_list, lit_list, totals, block: int, per, MAXQ, RL,
                K: int, name: str, absorb: bool):
    """The packing of v20 (``absorb=False``) and v22 (``absorb=True``)."""
    B = len(pieces_list)
    if per is None:
        per = serial.lane_ops_blocks(pieces_list, totals)
    NST = _need_supertiles(block, name)
    blocks = []
    maxq = 1
    maxrow = 0
    empty = (0, np.zeros(0, np.int64), np.zeros(0, np.int64),
             np.zeros((0, K, 3), np.int64))
    for (rows, rl, s, e, tile_start) in per:
        quads = []
        qs_t = [0]
        for st in range(NST):
            ssrc, stgt, sctl, n_subs = serial.group_slots(
                serial.supertile_ops(rows, rl, s, e, tile_start, st), K)
            if absorb:
                singles, multis = _v22_quads(ssrc, stgt, sctl, n_subs)
            else:
                # each class chunked on its own (a mixed-order quad could
                # pack a negative row)
                order = np.argsort(ssrc, kind="stable")
                mul_o = (n_subs > 1)[order]
                singles = _chunk_v20(ssrc, stgt, sctl, order[~mul_o])
                multis = _chunk_v20(ssrc, stgt, sctl, order[mul_o])
            st_quads = singles + multis
            nq = len(st_quads)
            qm = len(singles)
            if qm & 1:
                qm -= 1                 # one single quad to the K-plane side
            if (nq - qm) & 1:           # pad the K-plane side to even
                st_quads.append(empty)
                nq += 1
            quads.extend(st_quads)
            qs_t.append(qs_t[-1] + qm)          # midpoint (singles end)
            qs_t.append(qs_t[-2] + nq)          # supertile end
            maxrow = max(maxrow,
                         max((b + 128 for b, *_ in st_quads), default=128))
        blocks.append((qs_t, quads))
        maxq = max(maxq, len(quads))
    if MAXQ is None:
        MAXQ = maxq
    _check_maxq(maxq, MAXQ)
    RLP = _lit_rows(lit_list, maxrow, RL)
    NG32 = 32 * (-(-(MAXQ * 4) // 128))
    qs = np.zeros((B, 2 * NST + 1), np.int32)
    qbase = np.zeros((B, MAXQ), np.int32)
    pctrl = np.full((B, K * NG32, 128), 1 << 7, np.int32)
    tq = np.zeros((B, MAXQ, 128), np.int32)
    lit8 = np.zeros((B, RLP, 128), np.uint8)
    for j, ((qs_t, quads), lit) in enumerate(zip(blocks, lit_list)):
        qs[j, :len(qs_t)] = qs_t
        qs[j, len(qs_t):] = qs_t[-1]
        for q, (base, ssrc, stgt, sctl) in enumerate(quads):
            qbase[j, q] = base
            n = len(ssrc)
            if not n:
                continue
            if absorb and (ssrc < base).any():
                raise ValueError("v22 packed a source below its quad's base")
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
        _fill_lit(lit8, j, lit)
    return qs, qbase, pctrl, tq, lit8


def pack_blocks_v20(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, K: int = 2):
    """Pack the v20 dispatch batch, as the JAX package's
    ``kernel_attic.pack_blocks_v20``: v19's slots, single-op slots' quads
    before multi-op ones in each supertile, qs (B, 2*NST+1) with
    ``qs[2t]`` start, ``qs[2t+1]`` midpoint and ``qs[2t+2]`` end, int32
    ``tq``. Raises ValueError below 16 KiB blocks or for MAXQ below a block's
    quads."""
    return _pack_split(pieces_list, lit_list, totals, block, per, MAXQ, RL,
                       K, "v20", absorb=False)


def pack_blocks_v22(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, K: int = 2):
    """Pack v22's dispatch batch (v20's layout and kernel), as the JAX
    package's ``kernel_attic.pack_blocks_v22``: multi-op quads absorb the
    single-op slots inside their windows. Raises ValueError below 16 KiB
    blocks, for MAXQ below a block's quads, or where the JAX packer
    asserts a source at or above its quad's base."""
    return _pack_split(pieces_list, lit_list, totals, block, per, MAXQ, RL,
                       K, "v22", absorb=True)


def pack_blocks_v23(pieces_list, lit_list, totals, block: int,
                    per=None, MAXQ=None, RL=None, quad_align: int = 2,
                    K: int = 2):
    """v19's dispatch batch with the planes of ``pctrl`` interleaved, as the
    JAX package's ``kernel_attic.pack_blocks_v23``: plane j of 32-row
    group g at rows ``(g*K + j)*32 ..``. Pack at the group's own MAXQ / RL:
    ``serial.pad_v19_set`` reads ``pctrl`` plane-major and would scramble
    it. Raises ValueError below 16 KiB blocks."""
    _need_supertiles(block, "v23")
    qs, qbase, pctrl, tq, lit8 = serial.pack_blocks_v19(
        pieces_list, lit_list, totals, block, per=per, MAXQ=MAXQ, RL=RL,
        quad_align=quad_align, K=K)
    B, KG, _ = pctrl.shape
    old = pctrl.reshape(B, K, KG // K // 32, 32, 128)
    newp = np.ascontiguousarray(old.transpose(0, 2, 1, 3, 4)).reshape(
        B, KG, 128)
    return qs, qbase, newp, tq, lit8


# -- entries -------------------------------------------------------------------

def _v13_route(pieces, lits, totals, block, dev, dispatch, ph):
    """The v13 group route (``ops.decompress(use_serial=True)`` below
    16 KiB), which the JAX entries of v15-v17, v20 and v21 take there."""
    t0 = time.perf_counter()
    groups = serial.pack_groups(pieces, lits, totals, block, True, dispatch)
    t0 = _add(ph, "pack", t0)
    res = serial.decode_groups(groups, list(totals), block, True, dev)
    _add(ph, "device", t0)
    return res


def _pack_v24(p, lf, t, block):
    _need_supertiles(block, "v24")
    return serial.pack_blocks_v19(p, lf, t, block)


# variant -> (copy_engine.quad mode, packer of one dispatch group, whether
# blocks under 16 KiB take the v13 route as the JAX entry does)
VARIANTS = {
    12: (12, serial.pack_blocks_v12, False),
    14: (14, serial.pack_blocks_v12, False),
    15: (15, pack_blocks_v15, True),
    16: (16, functools.partial(pack_blocks_v15, quad_align=4), True),
    17: (17, functools.partial(pack_blocks_v15, base_align=32), True),
    20: (20, pack_blocks_v20, True),
    22: (20, pack_blocks_v22, False),
    21: (21, serial.pack_blocks_v19, True),
    23: (23, pack_blocks_v23, False),
    24: (24, _pack_v24, False),
}


def _run(pieces, lits, totals, block, device, dispatch, ph, variant):
    """Each dispatch group packed by the variant's packer and decoded by
    one ``copy_engine.quad`` launch in its mode (K = 2 where it reads K
    planes); blocks under 16 KiB take the v13 route or raise ValueError."""
    mode, pack, small = VARIANTS[variant]
    dev = _device(device, f"attic_quad.decode_blocks_v{variant}")
    if not len(pieces):
        return []
    if block < SUPERTILE and small:
        return _v13_route(pieces, lits, totals, block, dev, dispatch, ph)

    def group(p, lf, t):
        return pack(p, lf, t, block), lambda *a: copy_engine.quad(
            *a, mode=mode).view(len(p), -1)

    return _decode(pieces, lits, totals, dev, dispatch, ph, group)


def decode_blocks_v12(pieces, lits, totals, block: int, device=None,
                      dispatch: int | None = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode resolver plans through v12 (32-row tiles, every quad), on
    ``serial.pack_blocks_v12`` (the JAX package's
    ``kernel_attic.decode_blocks_v12``; ``dispatch=None``: one launch over
    all blocks, as that entry runs)."""
    return _run(pieces, lits, totals, block, device,
                dispatch or max(len(pieces), 1), _phases, 12)


def decode_blocks_v14(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v14 (v12's function, fours then ones; the JAX
    package's ``kernel_attic.decode_blocks_v14``)."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 14)


def decode_blocks_v15(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v15 (128-row supertiles, quad pairs; the JAX
    package's ``kernel_attic.decode_blocks_v15``); v13 below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 15)


def decode_blocks_v16(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v16 (v15 walked by fours on ``quad_align=4``; the
    JAX package's ``kernel_attic.decode_blocks_v16``); v13 below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 16)


def decode_blocks_v17(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v17 (v15's function on ``base_align=32``; the JAX
    package's ``kernel_attic.decode_blocks_v17``); v13 below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 17)


def decode_blocks_v20(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v20 (segregated quads, K = 2; the JAX package's
    ``kernel_attic.decode_blocks_v20``); v13 below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 20)


def decode_blocks_v22(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through the v20 kernel on ``pack_blocks_v22`` (K = 2; the
    pair of ``tools/tpu_ab_probe.py``); ValueError below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 22)


def decode_blocks_v21(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v21 (v19's function on ``pack_blocks_v19``, K = 2;
    the JAX package's ``kernel_attic.decode_blocks_v21``); v13 below
    16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 21)


def decode_blocks_v23(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v23 (plane-interleaved control on
    ``pack_blocks_v23``, K = 2; the pair of ``tools/tpu_ab_probe.py``);
    ValueError below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 23)


def decode_blocks_v24(pieces, lits, totals, block: int, device=None,
                      dispatch: int = 16, *,
                      _phases: dict | None = None) -> list[bytes]:
    """Decode through v24 (v19's function on ``pack_blocks_v19``, K = 2;
    the pair of ``tools/tpu_ab_probe.py``); ValueError below 16 KiB."""
    return _run(pieces, lits, totals, block, device, dispatch, _phases, 24)


ENTRIES = {12: decode_blocks_v12, 14: decode_blocks_v14,
           15: decode_blocks_v15, 16: decode_blocks_v16,
           17: decode_blocks_v17, 20: decode_blocks_v20,
           21: decode_blocks_v21, 22: decode_blocks_v22,
           23: decode_blocks_v23, 24: decode_blocks_v24}
