"""End-to-end device decode: archive bytes -> decoded bytes, the port of
``zxc_tpu.ops.device_pipeline`` (cold path and hint path).

* **frame walk** (``walk_frame``): native header walk plus payload and
  global checksum validation;
* **cold path, one native call per block** (``runtime.v19_prep_block``):
  section parse, entropy literal decode, piece resolution and lane-op
  packing, written straight into a pooled dispatch group's pinned host
  buffers; a thread pool runs the calls (ctypes releases the GIL);
* **hint path** (``hint=``, a ``.zxh`` from ``hints.write_hints``): the
  control ships from the hint once and stays on the device; per decode the
  host only rebuilds the literal windows from the archive (the hint's
  lit8 replay). With v26 geometry the windows go into one ragged flat
  buffer per group, one native call per worker stripe, for the v27
  kernel; otherwise into the per-block lit8 of the hint's own kernel;
* **one CUDA stream**: each group's buffers go over with non-blocking H2D
  copies and the copy-engine kernel runs behind them on the same stream,
  while the host preps the next groups. A CUDA event recorded after a
  slot's copies gates the slot's reuse.

Cold shapes are sized from a sample of blocks with margin; a block that
overflows them raises ``ShapeOverflow`` and the decode retries with grown
shapes (a hint pins its shapes, so there an overflow is a ZxcError). The
prep buffers are byte-identical to the JAX package's.
"""
from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .. import constants as C
from ..errors import (ZxcError, ERROR_CORRUPT_DATA, ERROR_BAD_CHECKSUM,
                      ERROR_SRC_TOO_SMALL, ERROR_DICT_REQUIRED,
                      ERROR_DICT_MISMATCH)
from ..format import headers
from ..format.hashes import global_hash_update
from ..format.dictionary import dict_id as compute_dict_id
from ..codec import huffman
from ..codec.frame import DecodeOpts
from .. import runtime
from . import copy_engine
from .hints import HintFile


@dataclass
class FrameWalk:
    block_size: int
    pos: np.ndarray          # (nb,) u64 payload offsets
    typ: np.ndarray          # (nb,) u8 block types
    comp: np.ndarray         # (nb,) u64 comp sizes
    decompressed_size: int
    dict_buf: np.ndarray | None
    dict_cl: np.ndarray | None

    @property
    def n_blocks(self) -> int:
        return len(self.pos)


def walk_frame(archive: bytes, opts: DecodeOpts | None = None) -> FrameWalk:
    """Frame walk + header/checksum validation (no section parsing)."""
    if len(archive) < C.FILE_HEADER_SIZE + C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL)
    fh = headers.read_file_header(archive)
    src = np.frombuffer(archive, np.uint8)

    dict_buf = dict_cl = None
    provided_id = 0
    if opts is not None and opts.dict_content:
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_cl = huffman.unpack_lengths(bytes(opts.dict_huf))
        provided_id = compute_dict_id(opts.dict_content, opts.dict_huf)
    if fh.dict_id != 0:
        if dict_buf is None:
            raise ZxcError(ERROR_DICT_REQUIRED)
        if provided_id != fh.dict_id:
            raise ZxcError(ERROR_DICT_MISMATCH)

    pos, typ, comp = runtime.walk_frame(src, fh.has_checksum,
                                        fh.block_size)
    L = runtime.lib()
    P = runtime._ptr
    nb = len(pos)
    pos = pos + 8                                     # -> payload offsets

    stored_size, stored_hash = headers.read_file_footer(archive)
    verify = bool(opts and opts.checksum) and fh.has_checksum
    if verify and nb:
        ends = (pos + comp).astype(np.int64)
        stored = np.array([src[e:e + 4].view("<u4")[0] for e in ends],
                          np.uint32)
        hashes = np.empty(nb, np.uint32)
        L.zxch_rapidhash32_batch(P(src), P(np.ascontiguousarray(pos)),
                                 P(np.ascontiguousarray(comp)), P(hashes), nb)
        if not (hashes == stored).all():
            raise ZxcError(ERROR_BAD_CHECKSUM, "block payload checksum")
        g = 0
        for h in stored:
            g = global_hash_update(g, int(h))
        if g != stored_hash:
            raise ZxcError(ERROR_BAD_CHECKSUM, "global hash mismatch")

    return FrameWalk(block_size=fh.block_size, pos=pos, typ=typ, comp=comp,
                     decompressed_size=stored_size, dict_buf=dict_buf,
                     dict_cl=dict_cl)


class ShapeOverflow(Exception):
    def __init__(self, need_maxq: int, need_rlp: int):
        self.need_maxq = need_maxq
        self.need_rlp = need_rlp


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _ng32(MAXQ: int) -> int:
    return 32 * _round_up(MAXQ * 4, 128) // 128


class GroupBuffers:
    """One dispatch group's host buffers: torch tensors (pinned when the
    group ships to a card) and numpy views of the same memory, which the
    native prep writes."""

    def __init__(self, B, NST, MAXQ, NG32, RLP, K, pin: bool):
        def mk(shape, dtype, fill=0):
            t = torch.full(shape, fill, dtype=dtype, pin_memory=pin)
            return t, t.numpy()

        self.t_qs, self.qs = mk((B, NST + 1), torch.int32)
        self.t_qbase, self.qbase = mk((B, MAXQ), torch.int32)
        self.t_pctrl, self.pctrl = mk((B, K * NG32, 128), torch.int32, 1 << 7)
        self.t_tq, self.tq = mk((B, MAXQ, 128), torch.uint8)
        self.t_lit8, self.lit8 = mk((B, RLP, 128), torch.uint8)
        self.t_totals, self.totals = mk((B,), torch.int64)
        # per-slot high-water mark of written lit8 rows: rows [litrows, hi)
        # hold a previous block's bytes after pool reuse; prep zeroes them
        self.lit_hi = np.zeros(B, np.int64)

    @property
    def args(self):
        return (self.t_qs, self.t_qbase, self.t_pctrl, self.t_tq, self.t_lit8)


# -- group-buffer pool -------------------------------------------------------
# Pinned host allocations are slow (they map and lock pages), so groups are
# reused across decodes. Reuse is safe because the native prep overwrites
# every cell of every quad it flushes, quads >= nq are never read, and a
# buffer returns to the pool only after the H2D copies that read it have
# completed (DevicePipeline.run).
_pool_lock = threading.Lock()
_pool: dict = {}


def _pool_acquire(key, make=None):
    with _pool_lock:
        free = _pool.get(key)
        if free:
            return free.pop()
    return make() if make is not None else GroupBuffers(*key)


def _flat_buffer(rows: int, pin: bool) -> torch.Tensor:
    """v27's flat lit buffer of one dispatch group (pooled like groups)."""
    return _pool_acquire(("flat", rows, pin), lambda: torch.zeros(
        (rows, 128), dtype=torch.uint8, pin_memory=pin))


def _pool_release(buf, key, cap: int = 64) -> None:
    with _pool_lock:
        free = _pool.setdefault(key, [])
        if len(free) < cap:
            free.append(buf)


class DevicePipeline:
    """Archive -> device decode pipeline for one frame geometry: splits
    blocks into dispatch groups of ``dispatch`` blocks, preps each group
    with a native thread pool and hands it to the device as it completes.

    ``variant``: 26 or 19 for the cold path. With a ``hint``, None or 27
    selects v27 when the hint carries v26 geometry and RLP % 32 == 0, and
    the hint's own kernel otherwise; 19 or 26 must name the hint's own."""

    def __init__(self, walk: FrameWalk, archive: bytes, K: int = 2,
                 dispatch: int = 16, workers: int | None = None,
                 variant: int | None = 26, hint: HintFile | None = None):
        if walk.block_size % 16384:
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "e2e pipeline needs block_size % 16384 == 0")
        self.walk = walk
        self.src = np.frombuffer(archive, np.uint8)
        self.K = K
        self.B = dispatch
        self.NST = walk.block_size // 16384
        self.workers = workers or min(os.cpu_count() or 1, 8)
        self.MAXQ = 0
        self.RLP = 0
        self.NG32 = 0
        self.totals = None   # (n_groups*B,) decoded sizes, set by run()
        self.hint = hint
        if hint is None:
            # 26 = unified self-referential window (lit8 holds literals and
            # patterns only; matches from earlier supertiles read the
            # kernel's own decoded rows); 19 = the materializing contract
            if variant not in (19, 26):
                raise ValueError(f"variant must be 19 or 26, not {variant}")
            self.variant = variant
            return
        g = hint.geo
        if g.block_size != walk.block_size or g.nb != walk.n_blocks:
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "hint geometry does not match frame")
        if variant not in (None, 27, g.variant):
            raise ValueError(f"the hint carries v{g.variant} control; "
                             f"variant {variant} cannot run it")
        self.K, self.MAXQ, self.RLP, self.NG32 = g.K, g.MAXQ, g.RLP, g.NG32
        self.variant = (27 if variant in (None, 27) and g.variant == 26
                        and g.RLP % 32 == 0 else g.variant)
        if self.variant == 27:
            self.loff, self.lr32, self.rows_tot = hint.flat_geometry(dispatch)

    @property
    def n_groups(self) -> int:
        return -(-self.walk.n_blocks // self.B)

    def _key(self, B: int, pin: bool):
        if self.hint is not None:
            # the control ships from the hint: only lit8 (none for v27,
            # whose lit rows go to the flat buffer) and totals are host
            # buffers here
            return (B, self.NST, 0, 0, 0 if self.variant == 27 else self.RLP,
                    self.K, pin)
        return (B, self.NST, self.MAXQ, self.NG32, self.RLP, self.K, pin)

    # -- shape discovery ---------------------------------------------------
    def size_shapes(self, sample: int | None = None,
                    margin: float = 1.1) -> None:
        """Prep a sample of blocks, spread over the frame, into scratch to
        pick MAXQ/RLP (the overflow retry covers a miss)."""
        w = self.walk
        nb = w.n_blocks
        if nb == 0:
            self.MAXQ, self.RLP = 32, 128
            self.NG32 = _ng32(self.MAXQ)
            return
        if sample is None:
            sample = min(max(self.B, 96), nb)
        # generous scratch: the piece floor is ~8 bytes/op, so a block caps
        # out near block/8/128 quads plus chunk fragmentation
        MAXQ0 = w.block_size // 128 + 256
        RLP0 = _round_up(3 * w.block_size // 128 + (1 << 20) // 128 + 256,
                         128)
        NG320 = _ng32(MAXQ0)
        key = (1, self.NST, MAXQ0, NG320, RLP0, self.K, False)
        buf = _pool_acquire(key)
        idx = np.linspace(0, nb - 1, sample).astype(int)
        max_nq = max_need = 1
        try:
            for i in np.unique(idx):
                total, nq, maxrow, litrows = self._prep_into(
                    int(i), buf, 0, MAXQ0, NG320, RLP0)
                if total < 0:
                    raise ZxcError(int(total), "device prep (sizing)")
                max_nq = max(max_nq, nq)
                max_need = max(max_need, maxrow, litrows)
        finally:
            _pool_release(buf, key, cap=2)
        self.MAXQ = _round_up(int(max_nq * margin) + 8, 32)
        self.RLP = _round_up(int(max_need * margin) + 16, 128)
        self.NG32 = _ng32(self.MAXQ)

    def grow(self, o: ShapeOverflow) -> None:
        self.MAXQ = _round_up(int(o.need_maxq * 1.5) + 8, 32)
        self.RLP = _round_up(int(o.need_rlp * 1.5) + 144, 128)
        self.NG32 = _ng32(self.MAXQ)

    def _payload(self, i: int) -> np.ndarray:
        p0 = int(self.walk.pos[i])
        return self.src[p0:p0 + int(self.walk.comp[i])]

    def _prep_into(self, i: int, buf: GroupBuffers, j: int, MAXQ: int,
                   NG32: int, RLP: int):
        w = self.walk
        r = runtime.v19_prep_block(
            self._payload(i), int(w.typ[i]), w.block_size,
            buf.qs[j], buf.qbase[j], buf.pctrl[j], buf.tq[j], buf.lit8[j],
            MAXQ, NG32, RLP, K=self.K,
            dict_buf=w.dict_buf, dict_cl=w.dict_cl,
            self_ref=(self.variant == 26))
        total, nq, maxrow, litrows = r
        if total >= 0:
            buf.totals[j] = total
        return total, nq, maxrow, litrows

    def _zero_stale(self, buf: GroupBuffers, j: int, litrows: int) -> None:
        # rows [litrows, lit_hi) hold a previous block's bytes after pool
        # reuse: zero them so the group equals a fresh prep
        if buf.lit_hi[j] > litrows:
            buf.lit8[j, litrows:buf.lit_hi[j]] = 0
        buf.lit_hi[j] = litrows

    def _prep_block(self, buf: GroupBuffers, g: int, j: int) -> None:
        i = g * self.B + j
        if i >= self.walk.n_blocks:   # padding row: empty block
            buf.qs[j] = 0
            buf.totals[j] = 0
            self._zero_stale(buf, j, 0)
            return
        if self.hint is not None:
            self._replay_block(buf, i, j)
            return
        total, nq, maxrow, litrows = self._prep_into(
            i, buf, j, self.MAXQ, self.NG32, self.RLP)
        if total < 0:
            # a failed prep may have written any literal row
            buf.lit_hi[j] = buf.lit8.shape[1]
            if total == -10 and (nq > self.MAXQ or maxrow > self.RLP
                                 or litrows > self.RLP):
                raise ShapeOverflow(max(nq, self.MAXQ),
                                    max(maxrow, litrows, self.RLP))
            raise ZxcError(int(total), "device prep")
        self._zero_stale(buf, j, litrows)

    def _replay_block(self, buf: GroupBuffers, i: int, j: int) -> None:
        """Hint path, v19/v26: block i's literal window into lit8[j]."""
        w, h = self.walk, self.hint
        lr = runtime.v19_lit8_load(
            self._payload(i), int(w.typ[i]), w.block_size, h.plan_slice(i),
            int(h.plan_off[i + 1] - h.plan_off[i]), int(h.litlen[i]),
            buf.lit8[j], self.RLP, dict_buf=w.dict_buf, dict_cl=w.dict_cl)
        if lr < 0:
            buf.lit_hi[j] = buf.lit8.shape[1]   # it may have written any row
            raise ZxcError(lr, "hint lit8 replay")
        self._zero_stale(buf, j, lr)

    def _replay_stripe(self, flat: np.ndarray, g: int, k: int,
                       nw: int) -> None:
        """Hint path, v27: blocks g*B+k, g*B+k+nw, ... of group g into the
        group's flat buffer, one native call; each block's rows past its
        own are zeroed up to its 32-row alignment."""
        w, h = self.walk, self.hint
        i0, i1 = g * self.B, min((g + 1) * self.B, w.n_blocks)
        rc = runtime.v19_lit8_load_batch(
            self.src, w.pos, w.comp, w.typ, i0 + k, i1, nw, w.block_size,
            h.plans, h.plan_off, h.litlen, flat, self.loff, self.RLP,
            zrows=self.lr32, dict_buf=w.dict_buf, dict_cl=w.dict_cl)
        if rc < 0:
            raise ZxcError(rc, "hint lit8 batch replay")

    def prep_group(self, g: int):
        """Prep dispatch group ``g`` alone into fresh host buffers (kernel
        checks and tests); call ``size_shapes`` first on the cold path.
        Returns the group's GroupBuffers and, on the hint path, the
        kernel's arguments as CPU tensors."""
        buf = GroupBuffers(*self._key(self.B, False))
        if self.variant == 27:
            flat = torch.zeros((self.rows_tot, 128), dtype=torch.uint8)
            for k in range(self.workers):
                self._replay_stripe(flat.numpy(), g, k, self.workers)
            self._hint_totals(buf, g)
            return buf, self._group_args(buf, flat, g, torch.device("cpu"))
        for j in range(self.B):
            self._prep_block(buf, g, j)
        if self.hint is not None:
            self._hint_totals(buf, g)
            return buf, self._group_args(buf, None, g, torch.device("cpu"))
        return buf, buf.args

    def _hint_totals(self, buf: GroupBuffers, g: int) -> None:
        i0, i1 = g * self.B, min((g + 1) * self.B, self.walk.n_blocks)
        buf.totals[:i1 - i0] = self.hint.totals[i0:i1]
        buf.totals[i1 - i0:] = 0

    def _group_args(self, buf: GroupBuffers, flat, g: int,
                    device: torch.device):
        """The kernel's arguments for group g on ``device``: the host
        buffers' H2D copies (non-blocking from pinned memory) behind the
        hint's device-resident control where there is a hint."""
        cuda = device.type == "cuda"

        def ship(t):
            return t.to(device, non_blocking=True) if cuda else t

        if self.hint is None:
            return tuple(ship(t) for t in buf.args)
        qs, qbase, pctrl, tq = self.hint.device_ctrl(g, self.B, device)
        if self.variant == 27:
            return (qs, qbase, self.hint.device_loff(g, self.B, device),
                    pctrl, tq, ship(flat))
        return (qs, qbase, pctrl, tq, ship(buf.t_lit8))

    # -- pipeline ----------------------------------------------------------
    def run(self, consume, device: torch.device, pools: int = 8,
            carry=None):
        """Prep and dispatch every group. ``consume(dev_args, dev_totals,
        g, carry)`` is called per group in order with the group's tensors
        on ``device`` (on a card: issued on the current stream) and returns
        the new carry. Raises ShapeOverflow when a block exceeds the sized
        shapes (the caller grows them and retries)."""
        n_groups = self.n_groups
        self.totals = np.zeros(n_groups * self.B, np.int64)
        if n_groups == 0:
            return carry
        cuda = device.type == "cuda"
        key = self._key(self.B, cuda)
        v27 = self.variant == 27
        # two slots at least: group g+1 is prepped while group g is handed
        # to the device
        n_slots = min(max(pools, 2), n_groups)
        bufs = [_pool_acquire(key) for _ in range(n_slots)]
        flats = [_flat_buffer(self.rows_tot, cuda) for _ in range(n_slots)
                 ] if v27 else [None] * n_slots
        # slot s may be refilled only once the H2D copies that read its
        # pinned buffers have completed: prep would otherwise overwrite
        # bytes still in flight (silent corruption no CPU test can see)
        copied = [None] * n_slots
        try:
            with ThreadPoolExecutor(self.workers) as ex:
                futs = {}

                def submit(g):
                    if g < n_groups and g not in futs:
                        slot = g % n_slots
                        if copied[slot] is not None:
                            copied[slot].synchronize()
                            copied[slot] = None
                        if self.hint is not None:
                            self._hint_totals(bufs[slot], g)
                        if v27:
                            # rows past the group's last block hold an
                            # earlier group's bytes after pool reuse
                            flat = flats[slot].numpy()
                            last = min((g + 1) * self.B, self.walk.n_blocks) - 1
                            flat[self.loff[last] + self.lr32[last]:] = 0
                            nw = self.workers
                            futs[g] = [ex.submit(self._replay_stripe, flat,
                                                 g, k, nw) for k in range(nw)]
                        else:
                            futs[g] = [ex.submit(self._prep_block,
                                                 bufs[slot], g, j)
                                       for j in range(self.B)]

                try:
                    submit(0)
                    for g in range(n_groups):
                        submit(g + 1)
                        for f in futs.pop(g):
                            f.result()   # raises ShapeOverflow / ZxcError
                        slot = g % n_slots
                        buf = bufs[slot]
                        self.totals[g * self.B:(g + 1) * self.B] = buf.totals
                        dev_args = self._group_args(buf, flats[slot], g,
                                                    device)
                        if cuda:
                            tot = buf.t_totals.to(device, non_blocking=True)
                            ev = torch.cuda.Event()
                            ev.record()
                            copied[slot] = ev
                        else:
                            tot = buf.t_totals.clone()
                        carry = consume(dev_args, tot, g, carry)
                finally:
                    for fs in futs.values():   # stop preps still queued
                        for f in fs:
                            f.cancel()
        finally:
            for ev in copied:
                if ev is not None:
                    ev.synchronize()
            for b in bufs:
                _pool_release(b, key)
            if v27:
                for f in flats:
                    _pool_release(f, ("flat", self.rows_tot, cuda))
        return carry


@functools.lru_cache(maxsize=32)
def _group_fns(block: int, dispatch: int, K: int, variant: int, RLP: int,
               device: torch.device):
    """Per-group kernel+fingerprint and kernel-only callables for one
    geometry (``RLP`` is read by v27 only). The fingerprints are JAX's:
    f1 = sum of the valid bytes, f2 = sum of byte * (position % 8191) over
    each block, both mod 2^32; they accumulate in int64 on the device
    (16 x 64 KiB x 255 x 8190 per group is far inside it) and are masked
    once at the end."""
    kern = functools.partial(copy_engine.KERNELS[variant], K=K)
    if variant == 27:
        kern = functools.partial(kern, RLP=RLP)
    flatpos = torch.arange(block, device=device)
    wgt = flatpos % 8191

    def group_out(args):
        return kern(*args)

    def group_fp(args, tot, f1, f2):
        flat = kern(*args).view(dispatch, block).long()
        flat = flat * (flatpos < tot[:, None])
        return f1 + flat.sum(), f2 + (flat * wgt).sum()

    return group_fp, group_out


def _device(device, name: str = "decompress_e2e") -> torch.device:
    """``None`` means cuda, which must be available; cuda or cpu only."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: CUDA is not available (pass "
                           "device='cpu' for the plain CPU path)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    return dev


def _add(ph: dict | None, key: str, t0: float) -> float:
    """Adds the seconds since ``t0`` to ``ph[key]`` (when ``ph`` is a
    dict) and returns the clock."""
    t = time.perf_counter()
    if ph is not None:
        ph[key] = ph.get(key, 0.0) + t - t0
    return t


def decompress_e2e(archive: bytes, opts: DecodeOpts | None = None, *,
                   device=None, dispatch: int = 16, K: int = 2,
                   workers: int | None = None, variant: int | None = None,
                   hint=None, _collect: str = "bytes",
                   _phases: dict | None = None):
    """One-shot end-to-end device decode (every phase on the clock).

    ``device``: None means ``cuda`` (raises when CUDA is absent);
    ``"cpu"`` runs the kernels' plain versions. ``hint``: a ``.zxh`` path
    or a ``HintFile`` of this archive (``hints.write_hints``); a hint that
    does not match the archive, or is corrupt, raises ZxcError.
    ``variant``: without a hint 26 (the cold default; 27 means 26 there)
    or 19. With a hint, None or 27 runs v27 when the hint carries v26
    geometry with RLP % 32 == 0 and the hint's own kernel otherwise; 19 or
    26 must name the hint's own kernel. ``K`` is the hint's when there is
    one.

    ``_collect``:
      * ``"bytes"`` — return the decoded ``bytes``;
      * ``"fingerprint"`` — keep outputs on the device and return
        ``(f1, f2, n_blocks, decompressed_size)``.
    ``_phases``, when given, receives wall seconds per phase: ``walk_size``
    (hint load, frame walk, checksums, shape sizing), ``run`` (prep, H2D
    and kernels issued), ``collect`` (device sync and readback) and
    ``total``.
    """
    if _collect not in ("bytes", "fingerprint"):
        raise ValueError(f"_collect must be 'bytes' or 'fingerprint', "
                         f"not {_collect!r}")
    dev = _device(device)
    t0 = time.perf_counter()
    if isinstance(hint, (str, bytes, os.PathLike)):
        hint = HintFile(os.fspath(hint), archive)
    if hint is None and variant in (None, 27):
        variant = 26
    w = walk_frame(archive, opts)
    pipe = DevicePipeline(w, archive, K=K, dispatch=dispatch,
                          workers=workers, variant=variant, hint=hint)
    cuda = dev.type == "cuda"
    stream = torch.cuda.Stream(dev) if cuda else None
    with torch.cuda.stream(stream) if cuda else contextlib.nullcontext():
        for _ in range(4):
            try:
                if pipe.MAXQ == 0:
                    pipe.size_shapes()
                t1 = time.perf_counter()
                group_fp, group_out = _group_fns(w.block_size, dispatch,
                                                 pipe.K, pipe.variant,
                                                 pipe.RLP, dev)
                if _collect == "fingerprint":
                    def consume(args, tot, g, carry):
                        return group_fp(args, tot, *carry)

                    zero = torch.zeros((), dtype=torch.int64, device=dev)
                    res = pipe.run(consume, dev, carry=(zero, zero))
                else:
                    def consume(args, tot, g, carry):
                        carry.append(group_out(args))
                        return carry

                    res = pipe.run(consume, dev, carry=[])
                break
            except ShapeOverflow as o:
                if hint is not None:   # a hint pins its shapes
                    raise ZxcError(ERROR_CORRUPT_DATA,
                                   "hint geometry overflow") from None
                pipe.grow(o)
        else:
            raise ZxcError(ERROR_CORRUPT_DATA, "shape sizing did not converge")
        t2 = time.perf_counter()
        if _collect == "fingerprint":
            out = (int(res[0]) & 0xFFFFFFFF, int(res[1]) & 0xFFFFFFFF,
                   w.n_blocks, w.decompressed_size)
        else:
            out = _assemble(res, pipe, w)
    if _phases is not None:
        t3 = time.perf_counter()
        _phases.update(walk_size=t1 - t0, run=t2 - t1, collect=t3 - t2,
                       total=t3 - t0)
    return out


def _assemble(outs: list, pipe: DevicePipeline, w: FrameWalk) -> bytes:
    """Group outputs -> the frame's bytes: one readback, then each block's
    first ``total`` bytes (the totals the native prep reported)."""
    nb = w.n_blocks
    if not nb:
        data = b""
    else:
        host = torch.cat(outs).cpu().numpy().reshape(-1, w.block_size)
        totals = pipe.totals
        data = b"".join(host[i, :totals[i]].tobytes() for i in range(nb))
    if len(data) != w.decompressed_size:
        raise ZxcError(ERROR_CORRUPT_DATA, "footer size mismatch")
    return data
