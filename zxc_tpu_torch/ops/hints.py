"""Encode-time piece-plan hints (the ``.zxh`` sidecar), the port of
``zxc_tpu.ops.hints``: the same version-3 bytes on disk.

The copy engine needs, per block, (a) the packed control (qs, qbase,
pctrl, tq: quad geometry, lane control words, target rows) and (b) the
literal window lit8 (dict ++ literals ++ bytes the resolver materialized).
Building (a) is nearly all of the cold path's host prep; (b) is a literal
decode and a memcpy replay. A hint file stores (a) verbatim in the
dispatch-group layout plus a replay plan for (b)'s materialized tail, so
a decode with a hint

* ships the control to the device once per (dispatch width, device) and
  keeps it there (``HintFile.device_ctrl``), and
* rebuilds lit8 from the ARCHIVE per decode (``zxch_v19_lit8_load``):
  every data byte still comes from the wire, the hint carries control
  records only.

A hint binds to one archive by length and rapidhash64 and carries a body
hash; the port's loader also checks every index array against the
geometry it was packed for, so a stale or corrupt hint raises ZxcError
and never decodes to wrong bytes.
"""
from __future__ import annotations

import os
import struct
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ZxcError, ERROR_CORRUPT_DATA
from ..codec import frame
from .. import runtime

MAGIC = b"ZXCHINT1"
VERSION = 3
HEADER_SIZE = 128
FLAG_BODY_ZXC = 1   # the body is itself a zxc frame (level 1)
FLAG_V26 = 2        # control carries the v26 self-referential geometry
# (sources from the block's own output at window row RLP + out_row)

# header layout (little-endian):
#   0  magic[8]
#   8  u32 version, u32 flags
#   16 u64 archive_len, u64 archive_hash (rapidhash64, seed 0)
#   32 u64 block_size, u64 nb
#   48 u32 K, u32 quad_align
#   56 u64 MAXQ, u64 NG32, u64 RLP, u64 NST
#   88 u64 body_hash (rapidhash64 of the leading 4 KiB of the on-disk
#      body xor the on-disk body length)
#   96 .. 128 reserved (zero)
_HDR = struct.Struct("<8sII QQ QQ II QQQQ Q 32x")


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _ng32(MAXQ: int) -> int:
    return 32 * _round_up(MAXQ * 4, 128) // 128


@dataclass
class HintGeometry:
    block_size: int
    nb: int
    K: int
    quad_align: int
    MAXQ: int
    NG32: int
    RLP: int
    NST: int
    variant: int = 19


class HintFile:
    """A validated ``.zxh`` hint of ``archive``: the body's arrays in host
    memory, and the control pages on a device once asked for."""

    def __init__(self, path: str, archive) -> None:
        self.path = path
        if os.path.getsize(path) < HEADER_SIZE:
            raise ZxcError(ERROR_CORRUPT_DATA, "hint file truncated")
        raw = np.memmap(path, np.uint8, mode="r")
        (magic, version, flags, alen, ahash, block_size, nb, K, qa,
         MAXQ, NG32, RLP, NST, body_hash) = _HDR.unpack(
            bytes(raw[:HEADER_SIZE]))
        if magic != MAGIC or version != VERSION:
            raise ZxcError(ERROR_CORRUPT_DATA, "hint magic/version mismatch")
        if alen != len(archive) or ahash != runtime.rapidhash64(archive):
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "hint does not match this archive")
        if body_hash != (runtime.rapidhash64(raw[HEADER_SIZE:
                                                 HEADER_SIZE + 4096])
                         ^ (len(raw) - HEADER_SIZE)):
            raise ZxcError(ERROR_CORRUPT_DATA, "hint body hash mismatch")
        self.geo = g = HintGeometry(int(block_size), int(nb), int(K),
                                    int(qa), int(MAXQ), int(NG32), int(RLP),
                                    int(NST), 26 if flags & FLAG_V26 else 19)
        if (g.block_size % 16384 or g.NST != g.block_size // 16384
                or g.K < 1 or g.MAXQ < 1 or g.NG32 < _ng32(g.MAXQ)
                or g.RLP < 1):
            raise ZxcError(ERROR_CORRUPT_DATA, "hint geometry invalid")
        if flags & FLAG_BODY_ZXC:
            comp = bytes(raw[HEADER_SIZE:])
            data = np.empty(frame.get_decompressed_size(comp), np.uint8)
            frame.decompress(comp, frame.DecodeOpts(checksum=True),
                             threads=min(os.cpu_count() or 1, 8), out=data)
        else:
            data = np.array(raw[HEADER_SIZE:])   # a copy: the map closes
        del raw
        off = 0

        def take(dtype, shape):
            nonlocal off
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            if off + n > len(data):
                raise ZxcError(ERROR_CORRUPT_DATA, "hint body truncated")
            a = data[off:off + n].view(dtype).reshape(shape)
            off += n
            return a

        self.totals = take(np.int64, (g.nb,))
        self.litlen = take(np.int64, (g.nb,))
        self.litrows = take(np.int64, (g.nb,))
        self.plan_off = take(np.int64, (g.nb + 1,))
        self.qs = take(np.int32, (g.nb, g.NST + 1))
        self.qbase = take(np.int32, (g.nb, g.MAXQ))
        self.tq = take(np.uint8, (g.nb, g.MAXQ, 128))
        self.pctrl = take(np.int32, (g.nb, g.K * g.NG32, 128))
        n_plan = int(self.plan_off[-1])
        if n_plan < 0:
            raise ZxcError(ERROR_CORRUPT_DATA, "hint plan_off corrupt")
        self.plans = take(np.int32, (n_plan, 4))
        self._validate()
        self._dev: dict = {}
        self._flat_geo: dict = {}

    def _validate(self) -> None:
        """Structural checks of the index arrays. The body hash covers its
        leading 4 KiB only, so a deep flip could leave indices that steer
        the replay or the kernel's windows elsewhere; each one must fit
        the geometry the control was packed for."""
        g = self.geo
        if not g.nb:
            return
        po = self.plan_off
        if po[0] != 0 or (np.diff(po) < 0).any():
            raise ZxcError(ERROR_CORRUPT_DATA, "hint plan_off not monotonic")
        lr, ll = self.litrows, self.litlen
        if (((ll < 0) | (ll > g.RLP * 128)).any()
                or (lr != (ll + 127) // 128).any()):
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "hint litrows/litlen out of range")
        if ((self.totals < 0) | (self.totals > g.block_size)).any():
            raise ZxcError(ERROR_CORRUPT_DATA, "hint totals out of range")
        qs = self.qs
        if ((qs[:, 0] != 0).any() or (np.diff(qs, axis=1) < 0).any()
                or (qs > g.MAXQ).any()):
            raise ZxcError(ERROR_CORRUPT_DATA, "hint qs not a quad prefix")
        # a window of 128 rows from qbase must fit lit8 (v19) or lit8 ++
        # the block's output rows (v26); no flag bit is masked off
        hi = g.RLP - 128 + (g.block_size // 128 if g.variant == 26 else 0)
        if ((self.qbase < 0) | (self.qbase > hi)).any():
            raise ZxcError(ERROR_CORRUPT_DATA, "hint qbase out of range")

    def plan_slice(self, i: int) -> np.ndarray:
        return self.plans[int(self.plan_off[i]):int(self.plan_off[i + 1])]

    # -- device-resident control pages -----------------------------------
    # The control is a pure function of the archive, pinned by this hint,
    # so repeat decodes need not ship it again: it goes to a device once
    # per (dispatch width, device) and stays. Per decode, only lit8 (the
    # data rebuilt from the wire) crosses. release_device() drops it.

    def device_ctrl(self, g: int, B: int, device):
        """(qs, qbase, pctrl, tq) of dispatch group ``g`` of width ``B`` on
        ``device``, cached on (B, device): fresh arrays, never views of
        the file's; a tail group pads with empty blocks (qs == 0 runs no
        quad)."""
        key = ("ctrl", B, str(torch.device(device)), g)
        ctrl = self._dev.get(key)
        if ctrl is None:
            i0, i1 = g * B, min((g + 1) * B, self.geo.nb)
            host = []
            for a, fill in ((self.qs, 0), (self.qbase, 0),
                            (self.pctrl, 1 << 7), (self.tq, 0)):
                h = np.full((B,) + a.shape[1:], fill, a.dtype)
                h[:i1 - i0] = a[i0:i1]
                host.append(torch.from_numpy(h).to(device))
            ctrl = self._dev[key] = tuple(host)
        return ctrl

    def flat_geometry(self, B: int):
        """v27's ragged shipping layout: per-block 32-row-aligned row
        offsets into each dispatch group's flat lit buffer (relative to
        the group), the aligned row counts, and the common row count all
        groups pad to (plus an RLP-row tail, so the fixed RLP-row window
        of the last block stays inside the buffer). Cached on B."""
        cached = self._flat_geo.get(B)
        if cached is not None:
            return cached
        lr32 = ((np.maximum(self.litrows, 1) + 31) // 32) * 32
        nb = self.geo.nb
        loff = np.zeros(nb, np.int32)
        rows_max = 1
        for g in range(-(-nb // B)):
            i0, i1 = g * B, min((g + 1) * B, nb)
            offs = np.zeros(i1 - i0, np.int64)
            offs[1:] = np.cumsum(lr32[i0:i1 - 1])
            loff[i0:i1] = offs
            rows_max = max(rows_max, int(offs[-1] + lr32[i1 - 1]))
        cached = (loff, lr32.astype(np.int32), rows_max + self.geo.RLP)
        self._flat_geo[B] = cached
        return cached

    def device_loff(self, g: int, B: int, device):
        """Group ``g``'s block row offsets on ``device`` (v27's ``loff``),
        cached like ``device_ctrl``."""
        key = ("loff", B, str(torch.device(device)), g)
        t = self._dev.get(key)
        if t is None:
            loff = self.flat_geometry(B)[0]
            i0, i1 = g * B, min((g + 1) * B, self.geo.nb)
            host = np.zeros(B, np.int32)
            host[:i1 - i0] = loff[i0:i1]
            t = self._dev[key] = torch.from_numpy(host).to(device)
        return t

    def release_device(self) -> None:
        """Drop every cached device control page (frees device memory)."""
        self._dev.clear()


def write_hints(archive, path: str, opts=None, K: int = 2,
                quad_align: int = 2, workers: int | None = None,
                variant: int = 26) -> str:
    """Prep every block of ``archive`` and write its ``.zxh`` hint.

    A pure function of the archive bytes: run at encode time, or as a
    first-decode cache. Two passes: a sizing prep into generous scratch
    picks exact MAXQ/RLP (a hint pins the decode geometry, so there is no
    margin), then the final prep writes the pinned-layout arrays. The
    native prep releases the GIL, so both passes run on a thread pool.
    The body is compressed as a level-1 frame with checksums, which the
    port's loader verifies."""
    from .device_pipeline import walk_frame
    if variant not in (19, 26):
        raise ValueError(f"hint variant must be 19 or 26, not {variant}")
    archive = bytes(archive)
    w = walk_frame(archive, opts)
    nb, bs = w.n_blocks, w.block_size
    if bs % 16384:
        raise ZxcError(ERROR_CORRUPT_DATA,
                       "hints need block_size % 16384 == 0")
    NST = bs // 16384
    src = np.frombuffer(archive, np.uint8)
    workers = workers or min(os.cpu_count() or 1, 8)
    self_ref = variant == 26

    # pass 1: size (generous scratch, per-thread buffers)
    MAXQ0 = bs // 128 + 256
    RLP0 = _round_up(3 * bs // 128 + (1 << 20) // 128 + 256, 128)
    NG320 = _ng32(MAXQ0)
    tl = threading.local()

    def scratch():
        if getattr(tl, "buf", None) is None:
            tl.buf = (np.zeros(NST + 1, np.int32), np.zeros(MAXQ0, np.int32),
                      np.full((K * NG320, 128), 1 << 7, np.int32),
                      np.zeros((MAXQ0, 128), np.uint8),
                      np.zeros((RLP0, 128), np.uint8))
        return tl.buf

    def plan_scratch(need: int):
        if getattr(tl, "plan", None) is None or len(tl.plan) < need:
            tl.plan = np.zeros((max(need, 1 << 18), 4), np.int32)
        return tl.plan

    geom = np.zeros((nb, 4), np.int64)  # nq, rows needed, litrows, n_plan

    def payload(i: int):
        p0 = int(w.pos[i])
        return src[p0:p0 + int(w.comp[i])]

    def size_one(i: int):
        plan = plan_scratch(1)
        while True:
            total, nq, maxrow, litrows, n_plan, _ = \
                runtime.v19_prep_block_plan(
                    payload(i), int(w.typ[i]), bs, *scratch(), MAXQ0, NG320,
                    RLP0, plan, K=K, quad_align=quad_align,
                    dict_buf=w.dict_buf, dict_cl=w.dict_cl, self_ref=self_ref)
            if total == -16:
                plan = plan_scratch(2 * len(plan))
                continue
            if total < 0:
                raise ZxcError(int(total), f"hint sizing block {i}")
            # v26 sizes RLP from litrows only: its windows may reach into
            # the block's output rows, which lit8 does not ship
            geom[i] = (nq, litrows if self_ref else max(maxrow, litrows),
                       litrows, n_plan)
            return

    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(size_one, range(nb)))

    MAXQ = _round_up(int(geom[:, 0].max(initial=1)) + 1, 32)
    RLP = _round_up(int(geom[:, 1].max(initial=1)) + 1,
                    32 if self_ref else 128)   # 32: v27's row alignment
    NG32 = _ng32(MAXQ)

    # pass 2: final prep into the pinned-layout arrays
    plan_off = np.zeros(nb + 1, np.int64)
    plan_off[1:] = np.cumsum(geom[:, 3])
    plans = np.zeros((int(plan_off[-1]), 4), np.int32)

    def prep_all(RLP: int):
        """The body arrays at ``RLP``, or the RLP the prep asks for: an
        empty or padding quad's window is rows [0, 128), so v26 control
        needs RLP >= 128 wherever a block has one. The JAX package sizes
        v26 from litrows alone and fails there with ERROR_OVERFLOW
        (ROADMAP queue 3); where its sizing works the files are equal."""
        arrays = (np.zeros(nb, np.int64), np.zeros(nb, np.int64),
                  np.zeros(nb, np.int64), np.zeros((nb, NST + 1), np.int32),
                  np.zeros((nb, MAXQ), np.int32),
                  np.zeros((nb, MAXQ, 128), np.uint8),
                  np.full((nb, K * NG32, 128), 1 << 7, np.int32))
        totals, litlen, litrows, qs_all, qb_all, tq_all, pc_all = arrays

        def prep_one(i: int):
            plan = plans[int(plan_off[i]):int(plan_off[i + 1])]
            if len(plan) == 0:
                plan = np.zeros((1, 4), np.int32)
            total, _, maxrow, lr, n_plan, ll = runtime.v19_prep_block_plan(
                payload(i), int(w.typ[i]), bs, qs_all[i], qb_all[i],
                pc_all[i], tq_all[i], scratch()[4], MAXQ, NG32, RLP, plan,
                K=K, quad_align=quad_align, dict_buf=w.dict_buf,
                dict_cl=w.dict_cl, self_ref=self_ref)
            if total == -10 and self_ref and maxrow > RLP:
                return maxrow
            if total < 0:
                raise ZxcError(int(total), f"hint prep block {i}")
            if n_plan != geom[i, 3]:
                raise ZxcError(ERROR_CORRUPT_DATA, "hint plan count drifted")
            totals[i], litlen[i], litrows[i] = total, ll, lr
            return 0

        with ThreadPoolExecutor(workers) as ex:
            need = max(ex.map(prep_one, range(nb)), default=0)
        return need, arrays

    need, arrays = prep_all(RLP)
    if need:
        RLP = _round_up(need, 32)
        need, arrays = prep_all(RLP)
        if need:
            raise ZxcError(ERROR_CORRUPT_DATA, "hint sizing did not converge")
    totals, litlen, litrows, qs_all, qb_all, tq_all, pc_all = arrays

    body = b"".join(np.ascontiguousarray(a).tobytes() for a in (
        totals, litlen, litrows, plan_off, qs_all, qb_all, tq_all, pc_all,
        plans))
    body = frame.compress(body, frame.EncodeOpts(
        level=1, block_size=1 << 20, checksum=True, threads=workers))
    flags = FLAG_BODY_ZXC | (FLAG_V26 if self_ref else 0)
    body_hash = runtime.rapidhash64(body[:4096]) ^ len(body)
    hdr = _HDR.pack(MAGIC, VERSION, flags, len(archive),
                    runtime.rapidhash64(archive), bs, nb, K, quad_align,
                    MAXQ, NG32, RLP, NST, body_hash)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(hdr)
        f.write(body)
    os.replace(tmp, path)
    return path
