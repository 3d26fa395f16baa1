"""Batched frame decode on the device, the port of ``zxc_tpu.ops.batch``
(``FramePlan``, ``plan_frame``, ``decode_plan_device`` and
``decompress``).

The host parses every block's sections (``plan_frame``: headers,
checksums, literal decode, varint extras). Then ``decompress`` takes one
of three routes, as the JAX package routes them:

* **pieces** (the default): the native resolver flattens each block's
  match chains into pieces ``out[p] = lit[c + (p - s) % k]`` on a thread
  pool (``FramePlan.resolve``), the blocks are padded into batches of up
  to ``batch`` and ``expand.pieces_kernel`` runs each batch on the card;
* **chase** (``use_pieces=False``, or any block over the resolver's piece
  budget): the padded sequences go through ``expand.expand_kernel``, the
  pointer-doubling expansion, with its error bits and a size check;
* **serial** (``use_serial=True``): the resolver's ``device_pure`` pieces
  go to a copy-engine kernel, one launch per dispatch group: v19 for
  blocks of 16 KiB and up and v13 below (``ops.serial``), or the attic's
  piece-serial kernel for ``variant`` 1, 2 or 3 at any block size
  (``ops.attic``). A frame with a block over the piece budget falls
  through to the chase route.

With ``device_entropy=True`` the PivCo literal sections stay as wire
bytes (``plan_frame(defer_entropy=True)``), decode on the device by
``pivco_device.route_sections`` and are written into each batch's literal
rows on the device before the chase expansion; as in the JAX package,
that forces the chase route, since the resolver needs literal values.

The pieces, chase and entropy routes are PyTorch tensor ops (the JAX
package's XLA code) and launch no hand-written kernel. The other attic
variants raise ``NotImplementedError``: as in the JAX package,
``decompress`` routes none of them; variants 4-7 and 9-11 have their own
entries (``attic.decode_blocks_v4/v9/v10/v11``), and so have 12, 14-17 and
20-24 (``attic_quad.decode_blocks_v12`` ... ``decode_blocks_v24``) and v25
(``serial.decode_blocks_v25``, on plans of ``resolve_serial(plan,
self_ref=True)``).
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import constants as C
from ..errors import (ZxcError, ERROR_CORRUPT_DATA, ERROR_OVERFLOW,
                      ERROR_BAD_OFFSET, ERROR_BAD_HEADER, ERROR_SRC_TOO_SMALL,
                      ERROR_BAD_CHECKSUM, ERROR_DICT_REQUIRED,
                      ERROR_DICT_MISMATCH)
from ..format import headers
from ..format.hashes import global_hash_update
from ..format.dictionary import dict_id as compute_dict_id
from ..codec import block_decode, huffman
from ..codec.frame import DecodeOpts
from .. import profiling, runtime
from ..codec.block_decode import DeferredSection
from . import attic, expand, pivco_device, serial
from .device_pipeline import _add, _device

# Blocks expanded per device batch (the JAX package's DEFAULT_BATCH).
DEFAULT_BATCH = 64


@dataclass
class FramePlan:
    """Host-side section parse of a whole frame, ready for device
    batching (the JAX package's fields, in its order)."""
    block_size: int
    ll: list = field(default_factory=list)       # per-block int32 (n_seq,)
    ml: list = field(default_factory=list)
    off: list = field(default_factory=list)
    lit: list = field(default_factory=list)      # uint8 or DeferredSection
    totals: list = field(default_factory=list)   # decoded size per block
    pieces: list = field(default_factory=list)   # (po,pc,ps,pk,lit) or None
    dict_buf: np.ndarray | None = None
    dict_len: int = 0
    decompressed_size: int = 0

    @property
    def n_blocks(self) -> int:
        return len(self.totals)

    @property
    def max_seq(self) -> int:
        return max((len(a) for a in self.ll), default=0)

    @property
    def max_lit(self) -> int:
        return max((len(a) for a in self.lit), default=0)

    @property
    def all_pieces(self) -> bool:
        return (self.n_blocks > 0 and len(self.pieces) == self.n_blocks
                and all(p is not None for p in self.pieces))

    @property
    def deferred(self) -> bool:
        return any(isinstance(l, DeferredSection) for l in self.lit)

    @property
    def max_pieces(self) -> int:
        return max((len(p[0]) for p in self.pieces if p is not None),
                   default=0)

    def resolve(self, workers: int | None = None) -> None:
        """Flatten match chains into piece plans (the native resolver, on
        a thread pool: ctypes releases the GIL). A block over the piece
        budget keeps ``None`` and the frame decodes through the chase
        route. A plan with deferred sections has no literal bytes to
        resolve from: every block keeps ``None``."""
        if self.deferred:
            self.pieces = [None] * self.n_blocks
            return

        def one(i):
            return runtime.resolve_pieces(self.ll[i], self.ml[i],
                                          self.off[i], self.lit[i],
                                          self.dict_buf)

        if workers is None:
            workers = min(os.cpu_count() or 1, 8)
        if workers <= 1 or self.n_blocks <= 1:
            self.pieces = [one(i) for i in range(self.n_blocks)]
        else:
            with ThreadPoolExecutor(workers) as ex:
                self.pieces = list(ex.map(one, range(self.n_blocks)))


def plan_frame(archive: bytes, opts: DecodeOpts | None = None,
               defer_entropy: bool = False) -> FramePlan:
    """Walk the frame and parse every block's sections on the host (the
    JAX package's ``plan_frame``: the same fields and the same error
    codes). ``defer_entropy`` keeps the PivCo literal sections as wire
    bytes (``DeferredSection``) for the device entropy decode."""
    if len(archive) < C.FILE_HEADER_SIZE + C.FILE_FOOTER_SIZE:
        raise ZxcError(ERROR_SRC_TOO_SMALL)
    fh = headers.read_file_header(archive)
    verify = bool(opts and opts.checksum) and fh.has_checksum

    dict_buf = dict_tree = None
    provided_id = 0
    if opts is not None and opts.dict_content:
        dict_buf = np.frombuffer(opts.dict_content, np.uint8)
        if opts.dict_huf is not None:
            dict_tree = huffman.build_tree_packed(bytes(opts.dict_huf))
        provided_id = compute_dict_id(opts.dict_content, opts.dict_huf)
    if fh.dict_id != 0:
        if dict_buf is None:
            raise ZxcError(ERROR_DICT_REQUIRED)
        if provided_id != fh.dict_id:
            raise ZxcError(ERROR_DICT_MISMATCH)

    buf = np.frombuffer(archive, np.uint8)
    plan = FramePlan(block_size=fh.block_size, dict_buf=dict_buf,
                     dict_len=0 if dict_buf is None else len(dict_buf))
    # pass 1: walk headers, collect payload spans, verify checksums
    spans: list[tuple[int, int, int]] = []   # (block_type, off, size)
    global_hash = 0
    pos = C.FILE_HEADER_SIZE
    saw_eof = False
    while pos + C.BLOCK_HEADER_SIZE <= len(archive):
        bh = headers.read_block_header(archive, pos)
        if bh.block_type == C.BLOCK_EOF:
            if bh.comp_size != 0:
                raise ZxcError(ERROR_BAD_HEADER, "EOF with non-zero comp_size")
            saw_eof = True
            break
        payload_off = pos + C.BLOCK_HEADER_SIZE
        tail = C.BLOCK_CHECKSUM_SIZE if fh.has_checksum else 0
        if payload_off + bh.comp_size + tail > len(archive):
            raise ZxcError(ERROR_SRC_TOO_SMALL, "block payload truncated")
        if bh.comp_size > C.compress_block_bound(fh.block_size):
            raise ZxcError(ERROR_CORRUPT_DATA, "comp_size exceeds block bound")
        if fh.has_checksum:
            end = payload_off + bh.comp_size
            stored = int(buf[end:end + 4].view("<u4")[0])
            if verify:
                if runtime.rapidhash32(buf[payload_off:end]) != stored:
                    raise ZxcError(ERROR_BAD_CHECKSUM, "block payload checksum")
                global_hash = global_hash_update(global_hash, stored)
        spans.append((bh.block_type, payload_off, bh.comp_size))
        pos = payload_off + bh.comp_size + tail
    if not saw_eof:
        raise ZxcError(ERROR_SRC_TOO_SMALL, "missing EOF block")

    # pass 2: parse block sections (native parsing releases the GIL)
    def parse_one(span):
        btype, p_off, p_size = span
        ll, ml, off, lit = block_decode.parse_block(
            btype, buf[p_off:p_off + p_size], fh.block_size, dict_tree,
            defer_entropy)
        lit_used = int(ll.sum())
        if lit_used > len(lit):
            raise ZxcError(ERROR_OVERFLOW, "literal stream exhausted")
        total = int((ll + ml).sum()) + len(lit) - lit_used
        if total > fh.block_size:
            raise ZxcError(ERROR_OVERFLOW, "decoded size exceeds capacity")
        if not isinstance(lit, DeferredSection):
            lit = np.ascontiguousarray(lit)
        return (ll.astype(np.int32), ml.astype(np.int32),
                off.astype(np.int32), lit, total)

    if len(spans) > 3:
        with ThreadPoolExecutor(min(os.cpu_count() or 1, 8)) as ex:
            parsed = list(ex.map(parse_one, spans))
    else:
        parsed = [parse_one(s) for s in spans]
    for ll, ml, off, lit, total in parsed:
        plan.ll.append(ll)
        plan.ml.append(ml)
        plan.off.append(off)
        plan.lit.append(lit)
        plan.totals.append(total)
        plan.decompressed_size += total

    stored_size, stored_hash = headers.read_file_footer(archive)
    if stored_size != plan.decompressed_size:
        raise ZxcError(ERROR_CORRUPT_DATA, "footer size mismatch")
    if verify and stored_hash != global_hash:
        raise ZxcError(ERROR_BAD_CHECKSUM, "global hash mismatch")
    return plan


def resolve_serial(plan: FramePlan, workers: int | None = None,
                   self_ref: bool = False):
    """Every block's pure pieces and literal buffer for the serial route
    (``max_frag=1``: the kernels pay per piece, so every multi-piece
    source is materialized), on a thread pool. Returns (pieces, lits), or
    (None, None) when a block exceeds the resolver's piece budget: the
    frame then takes the expansion route, as in the JAX package.
    ``self_ref``: v25's plans (``serial.decode_blocks_v25``), resolved as
    ``tools/tpu_v25_selfref.py`` resolves them: a match whose source
    completes before its destination's 16 KiB supertile is one KOUT piece
    in output coordinates. A plan with deferred sections raises
    ValueError: the resolver needs literal bytes."""
    if plan.deferred:
        raise ValueError("resolve_serial: the plan keeps entropy sections "
                         "as wire bytes (defer_entropy); they decode "
                         "through the chase route")

    def one(i):
        return runtime.resolve_pieces(plan.ll[i], plan.ml[i], plan.off[i],
                                      plan.lit[i], plan.dict_buf,
                                      device_pure=True, max_frag=1,
                                      self_ref=self_ref)

    with ThreadPoolExecutor(workers or min(os.cpu_count() or 1, 8)) as ex:
        res = list(ex.map(one, range(plan.n_blocks)))
    if any(r is None for r in res):
        return None, None
    return [r[:4] for r in res], [r[4] for r in res]


def _pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def _pad_batch(plan: FramePlan, idx: range, S: int, L: int,
               B: int | None = None):
    """Stack blocks idx into fixed (B, S)/(B, L) arrays (host numpy). Rows
    past len(idx) are empty blocks (n_seq=0, lit_len=0). A deferred
    section's row stays zero with its symbol count as lit_len: the device
    entropy decode fills it (``decode_plan_device``)."""
    if B is None:
        B = len(idx)
    ll = np.zeros((B, S), np.int32)
    ml = np.zeros((B, S), np.int32)
    off = np.ones((B, S), np.int32)
    lit = np.zeros((B, L), np.uint8)
    n_seq = np.zeros(B, np.int32)
    lit_len = np.zeros(B, np.int32)
    for j, i in enumerate(idx):
        s = len(plan.ll[i])
        n = len(plan.lit[i])
        ll[j, :s] = plan.ll[i]
        ml[j, :s] = plan.ml[i]
        off[j, :s] = plan.off[i]
        if not isinstance(plan.lit[i], DeferredSection):
            lit[j, :n] = plan.lit[i]
        n_seq[j] = s
        lit_len[j] = n
    return ll, ml, off, lit, n_seq, lit_len


_ERRBIT_CODES = {1: (ERROR_OVERFLOW, "literal stream exhausted"),
                 2: (ERROR_OVERFLOW, "decoded size exceeds capacity"),
                 4: (ERROR_BAD_OFFSET, "offset out of window")}


def _raise_errbits(bits: int):
    for bit, (code, msg) in _ERRBIT_CODES.items():
        if bits & bit:
            raise ZxcError(code, msg)
    raise ZxcError(ERROR_CORRUPT_DATA)


def _pad_piece_batch(plan: FramePlan, idx: range, P: int, L: int,
                     B: int | None = None):
    """Stack piece plans for blocks idx into fixed (B, P)/(B, L) arrays."""
    if B is None:
        B = len(idx)
    po = np.zeros((B, P), np.int32)
    pc = np.zeros((B, P), np.int32)
    ps = np.zeros((B, P), np.int32)
    pk = np.ones((B, P), np.int32)
    lit = np.zeros((B, L), np.uint8)
    n_pieces = np.zeros(B, np.int32)
    totals = np.zeros(B, np.int32)
    for j, i in enumerate(idx):
        p_o, p_c, p_s, p_k, lit_full = plan.pieces[i]
        n = len(p_o)
        po[j, :n] = p_o
        pc[j, :n] = p_c
        ps[j, :n] = p_s
        pk[j, :n] = p_k
        lit[j, :len(lit_full)] = lit_full
        n_pieces[j] = n
        totals[j] = plan.totals[i]
    return po, pc, ps, pk, lit, n_pieces, totals


def decode_plan_pieces_device(plan: FramePlan, batch: int = DEFAULT_BATCH,
                              device=None, *, _phases: dict | None = None
                              ) -> bytes:
    """Decode through the piece-plan expansion (no pointer chase): per
    batch one H2D, the tensor ops on ``device`` and one readback.
    ``_phases`` accumulates ``pad`` (host) and ``device`` seconds."""
    dev = _device(device, "decode_plan_device")
    nb = plan.n_blocks
    P = _pow2(plan.max_pieces)
    L = _pow2(max(len(p[4]) for p in plan.pieces))
    kern = expand.pieces_kernel(plan.block_size)
    Bsz = _pow2(min(batch, nb), lo=4)
    out_parts: list[np.ndarray] = []
    for base in range(0, nb, Bsz):
        t0 = time.perf_counter()
        idx = range(base, min(base + Bsz, nb))
        host = _pad_piece_batch(plan, idx, P, L, B=Bsz)
        t0 = _add(_phases, "pad", t0)
        out = kern(*(torch.from_numpy(a).to(dev) for a in host)).cpu().numpy()
        _add(_phases, "device", t0)
        out_parts += [out[j, :plan.totals[i]] for j, i in enumerate(idx)]
    return np.concatenate(out_parts).tobytes() if out_parts else b""


def decode_plan_device(plan: FramePlan, batch: int = DEFAULT_BATCH,
                       device=None, *, _phases: dict | None = None) -> bytes:
    """Run a FramePlan through the device expansion, batch by batch: the
    piece-plan route when every block has pieces, else the chase route
    (``expand.expand_kernel``), whose error bits raise ZxcError and whose
    totals must equal the plan's. ``device``: None means cuda (raises
    without it); "cpu" runs the same tensor ops on the CPU. A batch with
    deferred sections decodes them first (``_route_deferred``); then
    ``_phases`` also gets ``entropy`` seconds and ``entropy_sections`` /
    ``entropy_symbols`` counts."""
    dev = _device(device, "decode_plan_device")
    nb = plan.n_blocks
    if nb == 0:
        return b""
    if plan.all_pieces:
        return decode_plan_pieces_device(plan, batch, dev, _phases=_phases)
    S = _pow2(plan.max_seq)
    L = _pow2(plan.max_lit)
    has_dict = plan.dict_buf is not None
    kern = expand.expand_kernel(plan.block_size, has_dict)
    dict_args = ((expand.pad_dict(plan.dict_buf, dev), plan.dict_len)
                 if has_dict else ())
    # pow2 bucket: the JAX package's compiled shapes, kept for parity
    Bsz = _pow2(min(batch, nb), lo=4)
    out_parts: list[np.ndarray] = []
    for base in range(0, nb, Bsz):
        t0 = time.perf_counter()
        idx = range(base, min(base + Bsz, nb))
        host = _pad_batch(plan, idx, S, L, B=Bsz)
        t0 = _add(_phases, "pad", t0)
        args = [torch.from_numpy(a).to(dev) for a in host]
        rows = [j for j, i in enumerate(idx)
                if isinstance(plan.lit[i], DeferredSection)]
        if rows:
            t0 = _add(_phases, "device", t0)
            _route_deferred([plan.lit[idx[j]] for j in rows], rows, args[3],
                            _phases)
            t0 = time.perf_counter()
        out, total, err = kern(*args, *dict_args)
        err_np = err.cpu().numpy()[:len(idx)]
        total_np = total.cpu().numpy()[:len(idx)]
        out_np = out.cpu().numpy()
        _add(_phases, "device", t0)
        if err_np.any():
            _raise_errbits(int(err_np[err_np != 0][0]))
        if not (total_np == np.asarray(plan.totals[base:base + len(idx)])
                ).all():
            raise ZxcError(ERROR_CORRUPT_DATA, "device/plan size disagreement")
        out_parts += [out_np[j, :plan.totals[i]] for j, i in enumerate(idx)]
    return np.concatenate(out_parts).tobytes() if out_parts else b""


def _route_deferred(secs: list, rows: list, lit: torch.Tensor,
                    ph: dict | None) -> None:
    """The device entropy decode of one batch: the deferred sections
    ``secs`` planned and padded at the batch's L (host), shipped as wire
    bytes and routed on ``lit``'s device, their symbols written into rows
    ``rows`` of the device literal tensor ``lit`` (JAX: ``.at[rows].set``
    after the H2D of the zero rows). ``ph`` gets ``entropy`` seconds
    (planning, H2D and routing, synchronised) and the section and symbol
    counts."""
    t0 = time.perf_counter()
    L = lit.shape[1]
    plans = [pivco_device.plan_section(s.payload, s.n, s.tree) for s in secs]
    args, _, _, _, rounds = pivco_device.pad_plans(
        [s.payload for s in secs], plans, L=L)
    dec = pivco_device.route_padded(args, L, rounds, lit.device)
    lit.index_copy_(0, torch.tensor(rows, device=lit.device), dec)
    if lit.is_cuda:
        torch.cuda.synchronize(lit.device)
    _add(ph, "entropy", t0)
    if ph is not None:
        ph["entropy_sections"] = ph.get("entropy_sections", 0) + len(secs)
        ph["entropy_symbols"] = (ph.get("entropy_symbols", 0)
                                 + sum(s.n for s in secs))


def _record(col: profiling.Phases, ph: dict, resolved: bool) -> None:
    """One decode's seconds into the active phase collector under the JAX
    package's names: ``plan``, ``resolve`` (where a resolver ran) and
    ``device``, which in JAX spans the padding, so it holds the port's
    ``pad`` or ``pack``, ``entropy`` and ``device`` seconds."""
    secs = {"plan": ph["plan"],
            "device": sum(ph.get(k, 0.0)
                          for k in ("pad", "pack", "entropy", "device"))}
    if resolved:
        secs["resolve"] = ph["resolve"]
    for k, v in secs.items():
        col.seconds[k] = col.seconds.get(k, 0.0) + v
        col.counts[k] = col.counts.get(k, 0) + 1


def _decode_serial(plan: FramePlan, pieces, lits, variant: int,
                   dispatch: int, dev, ph: dict) -> bytes:
    """The serial route on resolved pieces, one kernel launch a dispatch
    group: v19/v13 (every group packed first, to one padded shape) or the
    attic kernel (each group packed and run in turn)."""
    if variant in attic.VARIANTS:
        return b"".join(attic.decode_blocks(
            pieces, lits, plan.totals, plan.block_size, dev, variant,
            dispatch, _phases=ph))
    t0 = time.perf_counter()
    v13 = variant == 13 or plan.block_size < 16384
    groups = serial.pack_groups(pieces, lits, plan.totals, plan.block_size,
                                v13, dispatch)
    t0 = _add(ph, "pack", t0)
    res = serial.decode_groups(groups, plan.totals, plan.block_size, v13,
                               dev)
    _add(ph, "device", t0)
    return b"".join(res)


def decompress(archive: bytes, opts: DecodeOpts | None = None,
               batch: int = DEFAULT_BATCH, device=None,
               use_pieces: bool = True, use_serial: bool = False,
               device_entropy: bool = False, *, variant: int = 19,
               dispatch: int = 16, _phases: dict | None = None) -> bytes:
    """One-shot frame decode with the hot path on the card, routed as the
    JAX package routes it (see the module docstring).

    ``device``: None means ``cuda`` (raises when CUDA is absent); ``"cpu"``
    runs the same route with the kernels' plain versions. ``batch``:
    blocks a device batch of the pieces and chase routes. ``use_serial``
    with ``variant`` 19 (v13 still serves blocks under 16 KiB), 13, or the
    attic's 1, 2 or 3; ``dispatch``: blocks a launch of the serial route.
    ``device_entropy``: the PivCo literal sections decode on the device
    from their wire bytes (``pivco_device``); it forces the chase route
    (``use_pieces`` and ``use_serial`` off), as in the JAX package.
    ``_phases``, when given, receives wall seconds ``plan`` (section
    parse), ``resolve`` (pieces), ``pad`` (batches; pieces and chase) or
    ``pack`` (control; serial), ``entropy`` (the device entropy decode,
    with counts ``entropy_sections`` and ``entropy_symbols``), ``device``
    (H2D, device work, readback) and ``total``, and ``route``:
    ``pieces``, ``chase`` or ``serial``. Inside
    ``profiling.collect_phases()`` the decode also records ``plan``,
    ``resolve`` and ``device`` there, as the JAX package's does."""
    if device_entropy:
        use_pieces = use_serial = False
    if use_serial and variant not in (13, 19, *attic.VARIANTS):
        raise NotImplementedError(
            f"serial variant {variant} has no ops.decompress route, as in "
            f"the JAX package (tools/kernel_attic.py): "
            f"{attic.OTHER_VARIANTS}")
    dev = _device(device, "ops.decompress")
    ph: dict = {}
    t_start = t0 = time.perf_counter()
    plan = plan_frame(archive, opts, defer_entropy=device_entropy)
    t0 = _add(ph, "plan", t0)
    out = None
    if use_serial and plan.n_blocks:
        pieces, lits = resolve_serial(plan)
        t0 = _add(ph, "resolve", t0)
        if pieces is not None:
            out = _decode_serial(plan, pieces, lits, variant, dispatch, dev,
                                 ph)
            ph["route"] = "serial"
    if out is None:
        if use_pieces:
            plan.resolve()
        else:
            plan.pieces = [None] * plan.n_blocks
        _add(ph, "resolve", t0)
        out = decode_plan_device(plan, batch, dev, _phases=ph)
        ph["route"] = "pieces" if plan.all_pieces else "chase"
    _add(ph, "total", t_start)
    if _phases is not None:
        _phases.update(ph)
    col = profiling.phases()
    if col is not None:
        _record(col, ph, use_serial or use_pieces)
    return out
