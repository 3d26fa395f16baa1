"""Device encoder kernels: the LCP match extender and the parse walk, with
their plain versions, launch counters and bytes bounds.

Replaces ``zxc_tpu/ops/pallas_encode.py``: ``_make_lcp_body`` /
``lcp_kernel`` (and its one-block entry ``lcp_pairs``) and
``parse_walk_kernel``. The kernels are ``csrc/encode.cu``; the functions:

* ``lcp(blk, pc, n)``: pair i of block b is one int32 word packed as the
  JAX kernel packs it, ``c | p << 16`` read as uint32 (``pack_pairs``);
  its result is the first i in [0, 256) where byte ``p+i`` and byte
  ``c+i`` of the zero-extended block differ, or 256 (``CAP``). The block
  is row b of ``blk`` cut to its first ``n`` bytes; every position at or
  past n reads 0, so any word, ``p <= c`` included, gives a value and
  reads nothing outside the buffers. The JAX kernel computes the same for
  the pairs its callers pack (ascending p, the zero-padded block) through
  one-hot MXU row fetches; the caller clamps to ``n - p`` either way.
* ``parse_walk(step)``: per block, a cursor walks ``p += step[p]`` from 0
  while below P and records p where ``step[p] > 1`` at
  ``pos[min(j, CAP-1)]``, CAP = P // 5 + 1; it returns ``nseq = j``
  unclamped. Only ``pos[:min(nseq, CAP)]`` is written; the kernel leaves
  the rest as the JAX kernel does (the plain version has 0 there). A step
  below 1 advances by 1 (the JAX kernel would loop for ever).

Bounds on the card: both kernels' bounds are bytes. The LCP kernel's
(``lcp_bytes_moved``) are the blocks once, a 4-byte word in and a 4-byte
result out per pair. Its CTAs (``lcp_plan`` a block, one wave) each stage
their block once in shared memory and take 4 pair words a thread a
round; a pair still equal after its first ``LCP_FIRST`` bytes goes to its
warp's queue, which the warp finishes (``lcp_shares`` reads how many;
``csrc/encode.cu`` says how). The walk's (``walk_bytes_moved``) are the
steps its chain reads and the entries it writes, a microsecond or two.
The chain of up to P dependent steps a block (``walk_chain``, a
statistic) is no floor: the kernel walks the chunks of ``walk_plan`` in
parallel and lets the walks synchronize themselves (two walks are one
from the first position both reach), in rounds until no chunk's exit
changes, with a serial finish where walks never meet (``WALK_MAX_ROUNDS``; ``walk_rounds`` reads the
rounds; ``csrc/encode.cu`` says how). What holds it above its bound is
its one SM a block, 16 of the card's 132 for a group.
On a CPU tensor a wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the kernel or raises. Each wrapper counts its kernel launches
in ``<wrapper>.launches``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as C
from .copy_engine import _on_card

CAP = 256            # 128 * ROUNDS of the JAX kernel
MAX_BLOCK = 65536    # the LCP kernel stages one block in shared memory
LCP_THREADS = 1024   # threads of an LCP CTA, 4 pair words each a round
LCP_CTAS_PER_SM = 1  # LCP CTAs an SM, each staging 64 KiB and a margin
LCP_FIRST = 32       # bytes of the LCP kernel's first round, in the lane
_WIN = 16            # bytes per compare window of the plain LCP
_CHUNK = 1 << 18     # pairs per gather of the plain LCP
# The parse walk's geometry: one chunk a thread of a 1024-thread CTA; rows
# of at most 65536 steps staged in shared memory as uint16; the serial
# finish after this many synchronizing rounds (or a round that changes
# more than half the chunks).
WALK_THREADS = 1024
WALK_SHARED_MAX = 65536
WALK_MAX_ROUNDS = 32


def _check(name: str, t, dtype, ndim: int, dev=None) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or t.dim() != ndim:
        raise TypeError(f"{name} must be a {ndim}-d {dtype} tensor")
    if dev is not None and t.device != dev:
        raise ValueError(f"{name} is on {t.device}, not {dev}")


def pack_pairs(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Pairs with p, c in [0, 65536) as the LCP kernel takes them: the
    int32 word whose uint32 value is ``c | p << 16``."""
    w = (p.long() << 16) | c.long()
    return torch.where(w >= 1 << 31, w - (1 << 32), w).int()


def unpack_pairs(pc: torch.Tensor):
    """(p, c) int64 of packed pair words: p = w >> 16 (logical), c = the
    low 16 bits."""
    w = pc.long() & 0xFFFFFFFF
    return w >> 16, w & 0xFFFF


def _lcp_args(blk, pc, n):
    _check("blk", blk, torch.uint8, 2)
    _check("pc", pc, torch.int32, 2, blk.device)
    B, L = blk.shape
    n = L if n is None else int(n)
    if pc.shape[0] != B or not 0 <= n <= L:
        raise ValueError(f"bad LCP shapes: blk {tuple(blk.shape)}, pc "
                         f"{tuple(pc.shape)}, n {n}")
    return B, n


def lcp_reference(blk, pc, n: int | None = None) -> torch.Tensor:
    """Plain PyTorch LCP on any device: (B, NP) int32, each in [0, CAP].

    Each block sits in a row followed by CAP + 16 zero bytes, and every
    position past n maps onto that zero margin; pairs then compare in
    16-byte windows, the pairs still equal going on to the next."""
    B, n = _lcp_args(blk, pc, n)
    dev = blk.device
    W = n + CAP + _WIN
    rows = torch.zeros((B, W), dtype=torch.uint8, device=dev)
    rows[:, :n] = blk[:, :n]
    win = rows.reshape(-1).unfold(0, _WIN, 1)             # (B*W - 15, 16)
    base = torch.arange(B, device=dev)[:, None] * W

    def index(x):
        return (base + torch.where(x <= n, x, n)).reshape(-1)

    ip, ic = (index(x) for x in unpack_pairs(pc))
    out = torch.full((ip.numel(),), CAP, dtype=torch.int32, device=dev)
    act = torch.arange(ip.numel(), device=dev)
    for off in range(0, CAP, _WIN):
        left = []
        for s in range(0, act.numel(), _CHUNK):
            a = act[s:s + _CHUNK]
            ne = win[ip[a] + off] != win[ic[a] + off]          # (k, 16)
            hit = ne.any(dim=1)
            out[a[hit]] = (off + ne[hit].int().argmax(dim=1)).int()
            left.append(a[~hit])
        act = torch.cat(left) if left else act[:0]
        if act.numel() == 0:
            break
    return out.view(B, -1)


def lcp_plan(B: int, NP: int, sms: int) -> int:
    """The LCP kernel's CTAs a block: one wave of ``LCP_CTAS_PER_SM`` CTAs
    an SM over the ``B`` blocks, and no more CTAs than a block has rounds
    of pair words (``LCP_THREADS`` groups of 4 a CTA round)."""
    rounds = -(-NP // (4 * LCP_THREADS))
    return max(1, min(LCP_CTAS_PER_SM * sms // max(B, 1), rounds, 65535))


def lcp_shares(lcp: torch.Tensor) -> tuple[float, float]:
    """Of a call's LCPs: the share of pairs that end in the kernel's first
    round (below ``LCP_FIRST``; the rest go through its warps' queues) and
    the share that reach ``CAP``."""
    return (float((lcp < LCP_FIRST).float().mean()),
            float((lcp == CAP).float().mean()))


def lcp(blk, pc, n: int | None = None) -> torch.Tensor:
    """LCP match extension over B blocks: ``blk`` (B, L) uint8 holding
    each block's n <= 65536 bytes (n defaults to L), packed pairs ``pc``
    (B, NP) int32 (``pack_pairs``). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (B, NP) int32 in [0, 256]."""
    if not _on_card("lcp", blk):
        return lcp_reference(blk, pc, n)
    B, n = _lcp_args(blk, pc, n)
    if n > MAX_BLOCK:
        raise ValueError(f"the LCP kernel takes blocks of at most "
                         f"{MAX_BLOCK} bytes, not {n}")
    if blk.shape[1] % 16:
        blk = torch.nn.functional.pad(blk, (0, -blk.shape[1] % 16))
    if blk.data_ptr() % 16 or not blk.is_contiguous():
        blk = blk.clone(memory_format=torch.contiguous_format)
    if pc.data_ptr() % 16 or not pc.is_contiguous():
        pc = pc.clone(memory_format=torch.contiguous_format)
    L, NP = blk.shape[1], pc.shape[1]
    out = torch.empty(pc.shape, dtype=torch.int32, device=blk.device)
    sms = torch.cuda.get_device_properties(blk.device).multi_processor_count
    _launch("zxc_lcp", blk, (blk, pc, out), (B, L, n, NP,
                                             lcp_plan(B, NP, sms)))
    lcp.launches += 1
    return out


def chain_marks(step: torch.Tensor) -> torch.Tensor:
    """Positions on the walk's chain from 0, (B, P) bool, by pointer
    doubling (the JAX package's ``parse_device``): ceil(log2 P) + 1
    rounds of a gather and a scatter."""
    B, P = step.shape
    dev = step.device
    jt = torch.minimum(torch.arange(P, device=dev)
                       + step.long().clamp(1, max(P, 1)),
                       torch.tensor(P, device=dev))
    jt = torch.cat([jt, torch.full((B, 1), P, device=dev)], dim=1)
    mark = torch.zeros((B, P + 1), dtype=torch.int32, device=dev)
    mark[:, 0] = 1
    for _ in range(max(1, math.ceil(math.log2(max(P, 2)))) + 1):
        hit = torch.zeros_like(mark).scatter_add_(1, jt[:, :P], mark[:, :P])
        mark = mark | (hit > 0).int()
        jt = torch.gather(jt, 1, jt)
    return mark[:, :P].bool()


def compact(keep: torch.Tensor, vals, cap: int):
    """The JAX package's compaction: kept entries in order into ``cap``
    slots, the ones past cap-1 all onto slot cap-1 (scatter-max), 0 in the
    slots no entry reaches. Returns (n, [compacted value tensors])."""
    idx = torch.cumsum(keep.long(), dim=1) - 1
    slot = torch.where(keep, idx.clamp(max=cap - 1), cap - 1)
    outs = []
    for v in vals:
        buf = torch.zeros((keep.shape[0], cap), dtype=torch.int32,
                          device=keep.device)
        outs.append(buf.scatter_reduce_(
            1, slot, torch.where(keep, v.int(), 0), "amax"))
    return keep.sum(dim=1).int(), outs


def parse_walk_reference(step, cap: int | None = None):
    """Plain PyTorch parse walk on any device: the pointer-doubling parse
    and compaction of the JAX package's ``parse_compact_device``. Returns
    (nseq (B,) int32, pos (B, cap) int32), pos 0 from min(nseq, cap) on."""
    _check("step", step, torch.int32, 2)
    B, P = step.shape
    cap = P // C.MIN_MATCH + 1 if cap is None else cap
    keep = chain_marks(step) & (step > 1)
    pos = torch.arange(P, device=step.device).expand(B, P)
    nseq, (pos_buf,) = compact(keep, [pos], cap)
    return nseq, pos_buf


class WalkPlan(NamedTuple):
    """The launch geometry of the parse walk over rows of P steps:
    ``chunks`` chunks of ``chunk`` positions (a multiple of 32; chunk k is
    [k * chunk, min((k + 1) * chunk, P)), thread k's); two bitmaps of
    ``words`` words, the visit marks and the records (positions whose
    step is over 1); ``shared``: the row staged in ``smem`` bytes of
    shared memory (uint16 steps, then the bitmaps), else read from global
    memory with the bitmaps in a scratch of 2 * ``words`` words a
    block."""
    P: int
    chunk: int
    chunks: int
    shared: bool
    words: int
    smem: int


def walk_plan(P: int) -> WalkPlan:
    """The walk's geometry for rows of P steps (``csrc/encode.cu``
    ``zxc_parse_walk`` checks it)."""
    per_thread = -(-P // WALK_THREADS)
    chunk = max(32, -(-per_thread // 32) * 32)
    words = -(-P // 32)
    shared = P <= WALK_SHARED_MAX
    smem = -(-2 * P // 16) * 16 + 8 * words if shared else 0
    return WalkPlan(P, chunk, -(-P // chunk), shared, words, smem)


def _walk(step, cap, stats: bool):
    _check("step", step, torch.int32, 2)
    B, P = step.shape
    cap = P // C.MIN_MATCH + 1 if cap is None else cap
    if cap < 1:
        raise ValueError(f"parse_walk needs cap >= 1, not {cap}")
    step = step.contiguous()
    dev = step.device
    plan = walk_plan(P)
    nseq = torch.empty(B, dtype=torch.int32, device=dev)
    pos = torch.empty((B, cap), dtype=torch.int32, device=dev)
    bits = (None if plan.shared else
            torch.empty((B, 2 * plan.words), dtype=torch.int32, device=dev))
    st = torch.empty((B, 2), dtype=torch.int32, device=dev) if stats else None
    from . import _build
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _build.encode_kernels().zxc_parse_walk(
            step.data_ptr(), nseq.data_ptr(), pos.data_ptr(),
            *(None if t is None else t.data_ptr() for t in (bits, st)),
            B, P, cap, plan.chunk, int(plan.shared), plan.smem,
            WALK_MAX_ROUNDS, stream)
    if rc:
        raise RuntimeError(f"zxc_parse_walk launch failed: cudaError {rc}")
    parse_walk.launches += 1
    return nseq, pos, st


def parse_walk(step, cap: int | None = None):
    """Parse walk over B blocks' steps (B, P) int32: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Returns (nseq (B,)
    int32, pos (B, cap) int32), cap = P // 5 + 1 by default; only
    ``pos[b, :min(nseq[b], cap)]`` is defined."""
    if not _on_card("parse_walk", step):
        return parse_walk_reference(step, cap)
    return _walk(step, cap, False)[:2]


def walk_rounds(step, cap: int | None = None) -> torch.Tensor:
    """The kernel's synchronization on CUDA steps: (B, 2) int32, each
    block's rounds and the first chunk it walked serially (-1: none). One
    ``parse_walk`` launch (counted there); for CUDA tensors only."""
    if not _on_card("walk_rounds", step):
        raise ValueError("walk_rounds reads the kernel's rounds: it needs "
                         "a CUDA tensor")
    return _walk(step, cap, True)[2]


def walk_defined(nseq: torch.Tensor, cap: int) -> torch.Tensor:
    """Where ``parse_walk``'s pos is defined: (B, cap) bool, the first
    min(nseq, cap) entries of each row."""
    return torch.arange(cap, device=nseq.device) < nseq[:, None]


lcp.launches = 0
parse_walk.launches = 0
KERNELS = {"lcp": lcp, "parse_walk": parse_walk}


def _launch(entry: str, t, tensors, ints) -> None:
    """Launch ``entry`` on the tensors' pointers, the ints and the current
    stream of ``t``'s device; raise if the launch was refused."""
    from . import _build
    fn = getattr(_build.encode_kernels(), entry)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = fn(*(x.data_ptr() for x in tensors), *ints, stream)
    if rc:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")


def lcp_bytes_moved(B: int, n: int, NP: int) -> int:
    """Bytes one LCP call must move: each block's n bytes read once, the
    packed pair word read once and the int32 result written once per
    pair."""
    return B * n + 8 * B * NP


def _chain(step):
    step = (step if isinstance(step, torch.Tensor)
            else torch.from_numpy(np.asarray(step, np.int32)))
    return step, chain_marks(step)


def walk_chain(step) -> np.ndarray:
    """Steps the walk takes in each block (positions on its chain)."""
    return _chain(step)[1].sum(dim=1).cpu().numpy()


def walk_bytes_moved(step, cap: int | None = None) -> int:
    """Bytes one parse-walk call must move for this data: the int32 step
    at each position on each block's chain read once, nseq written once
    and the min(nseq, cap) entries of pos the walk defines written once."""
    step, marks = _chain(step)
    B, P = step.shape
    cap = P // C.MIN_MATCH + 1 if cap is None else cap
    nseq = (marks & (step > 1)).sum(dim=1).clamp(max=cap)
    return 4 * int(marks.sum()) + 4 * B + 4 * int(nseq.sum())


def lcp_pairs(data: np.ndarray, p: np.ndarray, c: np.ndarray,
              device=None) -> np.ndarray:
    """One-block entry: the LCP (capped at 256) of each (p, c) pair over
    ``data`` (positions in [0, 65536)), clamped to n - p; numpy in and
    out. ``device`` None means cuda."""
    from .device_pipeline import _device
    dev = _device(device, "lcp_pairs")
    data = np.asarray(data, np.uint8)
    p, c = np.asarray(p, np.int64), np.asarray(c, np.int64)
    if p.shape != c.shape or ((p < 0) | (p > 0xFFFF)
                              | (c < 0) | (c > 0xFFFF)).any():
        raise ValueError("lcp_pairs takes pairs of positions in [0, 65536)")
    blk = torch.from_numpy(data.copy()).to(dev)[None]
    pc = pack_pairs(torch.from_numpy(p), torch.from_numpy(c)).to(dev)[None]
    out = lcp(blk, pc).cpu().numpy()[0]
    return np.minimum(out, len(data) - p)
