"""Device LZ sequence expansion, the port of ``zxc_tpu.ops.expand``: the
default ``ops.decompress`` route (``batch.decode_plan_device``).

The JAX package writes this as XLA code, not as a Pallas kernel, so the
port writes it as PyTorch tensor ops on the tensors' device, batched over
the leading axis (JAX's ``vmap``):

* ``expand_kernel``: prefix sums of (ll, ll+ml) give every sequence's
  literal-source and output positions; a segment-id map (scatter ones at
  segment starts, cumsum) assigns each output byte its sequence; literal
  bytes resolve by one gather; match bytes get a back-pointer with the
  match's own overlap collapsed (``rel % off``); the remaining chains
  resolve by pointer doubling;
* ``pieces_kernel``: the host resolver's piece plan
  ``out[p] = lit[c + (p - s) % k]``, one rank map and two gathers.

The arithmetic is int32 and wraps as JAX's does (cumulative sums and sums
take ``dtype=torch.int32``; ``%`` floors in both). Where JAX clamps a
gather or drops an out-of-range scatter (``mode="drop"``, after the
negative index wraps once by the axis length), the port clamps and masks
the same way, so a corrupt plan gives JAX's bytes and error bits instead
of an index error or a device-side assert.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Right-aligned dictionary pad for the dict variant: [dict | output] coords.
DICT_PAD = 1 << 16

_I32 = torch.int32


def _exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x, 1, dtype=_I32) - x


def _segment_ids(starts: torch.Tensor, n_valid: torch.Tensor,
                 block: int) -> torch.Tensor:
    """JAX's ``zeros(block + 1).at[starts].add(1, mode="drop")``, then
    ``cumsum(seg[:block]) - 1`` clipped to [0, max(n_valid - 1, 0)], per
    row: (B, block) int32. A negative start counts from the end, as JAX
    normalises it; a start still outside [0, block] is dropped."""
    idx = torch.where(starts < 0, starts + (block + 1), starts)
    keep = (idx >= 0) & (idx <= block)
    seg = torch.zeros((starts.shape[0], block + 1), dtype=_I32,
                      device=starts.device)
    seg.scatter_add_(1, torch.where(keep, idx, block).long(),
                     keep.to(_I32))
    sid = torch.cumsum(seg[:, :block], 1, dtype=_I32) - 1
    return torch.minimum(sid.clamp_min(0),
                         (n_valid - 1).clamp_min(0)[:, None])


def _expand(ll, ml, off, lit, n_seq, lit_len, dict_buf=None, dict_len=None,
            *, block: int):
    """Expand a batch of blocks (``_expand_one`` under ``vmap``).

    ll/ml/off: (B, S) int32 (ml includes MIN_MATCH, off unbiased >= 1);
    lit: (B, L) uint8; n_seq, lit_len: (B,) int32; dict_buf: (DICT_PAD,)
    uint8 right-aligned dictionary or None, dict_len: its length.
    Returns (out (B, block) uint8, total (B,) int32, err (B,) int32) with
    err bits 1 = literal stream exhausted, 2 = capacity overflow, 4 =
    offset out of window."""
    B, S = ll.shape
    L = lit.shape[1]
    dev = ll.device
    D = DICT_PAD if dict_buf is not None else 0
    Q = D + block

    valid = torch.arange(S, dtype=_I32, device=dev) < n_seq[:, None]
    ll = torch.where(valid, ll, 0)
    ml = torch.where(valid, ml, 0)
    off = torch.where(valid, off.clamp_min(1), 1)

    seq_out = ll + ml
    out_start = _exclusive_cumsum(seq_out)
    match_start = out_start + ll
    cum_ll = _exclusive_cumsum(ll)
    total_seq = seq_out.sum(1, dtype=_I32)
    lit_used = ll.sum(1, dtype=_I32)
    total = total_seq + (lit_len - lit_used).clamp_min(0)

    dlen = int(dict_len) if D else 0
    err = ((lit_used > lit_len).to(_I32)
           | ((total > block).to(_I32) << 1)
           | ((valid & (off > match_start + dlen)).any(1).to(_I32) << 2))

    # every valid sequence emits >= MIN_MATCH bytes, so the segment map is
    # exact on a well-formed plan; padding parks at `block`
    sid = _segment_ids(torch.where(valid, out_start, block), n_seq,
                       block).long()
    p = torch.arange(block, dtype=_I32, device=dev)[None]
    in_seq = (p < total_seq[:, None]) & (n_seq[:, None] > 0)
    ms = match_start.gather(1, sid)
    osr = out_start.gather(1, sid)
    is_match = in_seq & (p >= ms)

    # literal source index: in-sequence literals, then the trailing tail
    lit_idx = torch.where(in_seq, cum_ll.gather(1, sid) + (p - osr),
                          lit_used[:, None] + (p - total_seq[:, None]))
    lit_byte = lit.gather(1, lit_idx.clamp(0, L - 1).long()).to(_I32)

    # match back-pointer in q-space with self-overlap collapsed
    offv = off.gather(1, sid)
    rel = p - ms
    collapsed = torch.where(rel >= offv, rel % offv, rel) - offv
    node = torch.where(is_match, (D + ms + collapsed).clamp_min(0),
                       -(lit_byte + 1))
    # free the (B, block) temporaries before the doubling loop's own
    del sid, ms, osr, is_match, lit_idx, lit_byte, offv, rel, collapsed
    if D:
        dnode = -(dict_buf.to(_I32) + 1)
        node = torch.cat([dnode.expand(B, D), node], 1)

    # pointer doubling: chains strictly decrease, so at most
    # ceil(log2 Q) + 1 rounds, with JAX's batch-wide early exit (one host
    # sync a round; a resolved node is a fixed point of the round)
    max_iters = int(math.ceil(math.log2(Q))) + 1
    i = 0
    while i < max_iters and bool((node >= 0).any()):
        node = torch.where(node >= 0,
                           node.gather(1, node.clamp(0, Q - 1).long()), node)
        i += 1
    out = (-node[:, D:] - 1).to(torch.uint8)
    return torch.where(p < total[:, None], out, 0), total, err


def expand_kernel(block: int, has_dict: bool):
    """The batched expansion for a static (block, has_dict), called as the
    JAX package's: ``(ll, ml, off, lit, n_seq, lit_len)``, with
    ``(dict_buf, dict_len)`` after them when ``has_dict``. Returns
    (out (B, block) uint8, total (B,) int32, err (B,) int32)."""
    if has_dict:
        def fn(ll, ml, off, lit, n_seq, lit_len, dict_buf, dict_len):
            return _expand(ll, ml, off, lit, n_seq, lit_len, dict_buf,
                           dict_len, block=block)
        return fn

    def fn(ll, ml, off, lit, n_seq, lit_len):
        return _expand(ll, ml, off, lit, n_seq, lit_len, block=block)
    return fn


def _expand_pieces(po, pc, ps, pk, lit, n_pieces, total, *, block: int):
    """Piece-plan expansion (``_expand_pieces_one`` under ``vmap``).

    po/pc/ps/pk: (B, P) int32 piece tables (po strictly increasing);
    lit: (B, L) uint8 = dict ++ literals; n_pieces, total: (B,) int32.
    Returns (B, block) uint8."""
    P = po.shape[1]
    L = lit.shape[1]
    dev = po.device
    valid = torch.arange(P, dtype=_I32, device=dev) < n_pieces[:, None]
    rank = _segment_ids(torch.where(valid, po, block), n_pieces,
                        block).long()
    p = torch.arange(block, dtype=_I32, device=dev)[None]
    c = pc.gather(1, rank)
    s = ps.gather(1, rank)
    k = pk.gather(1, rank).clamp_min(1)
    out = lit.gather(1, (c + (p - s) % k).clamp(0, L - 1).long())
    return torch.where(p < total[:, None], out, 0)


def pieces_kernel(block: int):
    """The batched piece-plan expansion for a static block size, called
    as the JAX package's ``(po, pc, ps, pk, lit, n_pieces, total)``.
    Returns (B, block) uint8."""
    def fn(po, pc, ps, pk, lit, n_pieces, total):
        return _expand_pieces(po, pc, ps, pk, lit, n_pieces, total,
                              block=block)
    return fn


def pad_dict(dict_buf, device="cpu") -> torch.Tensor:
    """Right-align a dictionary into the static DICT_PAD coordinate space:
    a (DICT_PAD,) uint8 tensor on ``device``."""
    d = np.zeros(DICT_PAD, np.uint8)
    if dict_buf is not None and len(dict_buf):
        d[DICT_PAD - len(dict_buf):] = dict_buf
    return torch.from_numpy(d).to(device)
