"""Device PivCo-Huffman section decode, the port of
``zxc_tpu.ops.pivco_device``: the literal sections of a frame decode on
the device from their wire bytes (``ops.decompress(device_entropy=True)``),
so a batch ships the node runs instead of the decoded symbols.

Every output position walks the code trie from the root to its leaf on
its own, so the decode is ``max_depth + 1`` data-parallel rounds over the
lanes of a (B, L) tensor:

* an exclusive popcount prefix ``P`` over a section's bytes gives any
  lane at ``(node, p)`` the ones before bit ``p`` of the node's run,
  ``P[run_off + p // 8] - P[run_off] + popcount(partial byte)``;
* the lane reads bit ``p`` and descends: bit 1 to the right child at
  position ``ones``, bit 0 to the left child at ``p - ones``;
* a flat subtree root ends a lane with ``D`` packed bits (``p * D``,
  LSB first) and one lookup in its path-to-symbol table; a leaf ends it
  with its symbol.

``plan_section`` (the run sizing and validation of the reference's first
pass, host numpy) and ``pad_plans`` are the JAX package's, verbatim.
``route_sections`` is the JAX package's ``routing_kernel`` as PyTorch
tensor ops on the tensors' device. The JAX package writes the routing as
XLA gathers, not as a Pallas kernel, so it has no hand-written kernel
here either. JAX packs the node tables and the section bytes into 32-bit
words with a 24-bit wrapped popcount prefix, because TPU gathers are slow
and x64 is off; the port gathers the unpacked tables along dim 1. The
bytes out equal the JAX kernel's, 0 past ``n``. Where the JAX kernel
clamps an index, the port clamps it the same way, and every other index
(a node id, masked to 9 bits as JAX's packed word does) stays in range.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..codec.huffman import PivcoTree, MAX_LEN
from ..errors import ZxcError, ERROR_CORRUPT_DATA
from .device_pipeline import _device

NN = 512          # >= PIVCO_MAX_NODES (2*256 - 1)

_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(1).astype(np.int32)

_I32 = torch.int32


@dataclass
class SectionPlan:
    """Per-section device routing tables (host numpy, pre-padding)."""
    nxt0: np.ndarray       # (NN,) i32 left-child node id (0 when absent)
    nxt1: np.ndarray       # (NN,) i32 right-child node id
    run_off: np.ndarray    # (NN,) i32 byte offset of the node's run
    typ: np.ndarray        # (NN,) i32 0=bitmap 1=leaf 2=flat-root
    sym: np.ndarray        # (NN,) i32 leaf symbol
    flat_base: np.ndarray  # (NN,) i32 offset into c2s
    flat_d: np.ndarray     # (NN,) i32 flat depth D
    c2s: np.ndarray        # (n_flat_entries,) u8 concatenated path tables
    n: int                 # symbol count
    rounds: int            # routing rounds needed (max_depth + 1)
    sec_len: int           # wire bytes consumed


def plan_section(payload: np.ndarray, n: int, tree: PivcoTree) -> SectionPlan:
    """Pass 1 (run sizing + validation) -> device routing tables.

    Mirrors zxc_pivco_decode_core's first loop (zxc_huffman.c:2146-2192):
    walk nodes in BFS wire order, size each run from the node's symbol
    count, popcount it to split counts between children. Rejects the same
    malformed streams the host decoder rejects.
    """
    t = tree
    payload = np.asarray(payload, np.uint8)
    if n <= 0:
        raise ZxcError(ERROR_CORRUPT_DATA, "empty section")
    n_nodes = len(t.sym)
    if n_nodes > NN:
        raise ZxcError(ERROR_CORRUPT_DATA, "node overflow")
    pop = _POP8[payload]
    count = np.zeros(n_nodes, np.int64)
    count[0] = n
    run_off = np.zeros(NN, np.int32)
    pos = 0
    plen = len(payload)
    for i in range(n_nodes):
        nid = int(t.bfs[i])
        if t.covered[nid] or t.sym[nid] >= 0:
            continue
        c = int(count[nid])
        fd = int(t.flat_d[nid])
        nbytes = (c * fd + 7) // 8 if fd else (c + 7) // 8
        if plen - pos < nbytes:
            raise ZxcError(ERROR_CORRUPT_DATA, "node run out of bounds")
        run_off[nid] = pos
        pos += nbytes
        if fd:
            continue
        full = c // 8
        ones = int(pop[run_off[nid]:run_off[nid] + full].sum())
        rem = c & 7
        if rem:
            ones += int(_POP8[payload[run_off[nid] + full]
                              & ((1 << rem) - 1)])
        ch0, ch1 = int(t.child[nid, 0]), int(t.child[nid, 1])
        if ch1 >= 0:
            count[ch1] = ones
        elif ones:
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "symbols routed to absent right child")
        if ch0 >= 0:
            count[ch0] = c - ones
        elif c - ones:
            raise ZxcError(ERROR_CORRUPT_DATA,
                           "symbols routed to absent left child")

    nxt0 = np.zeros(NN, np.int32)
    nxt1 = np.zeros(NN, np.int32)
    typ = np.zeros(NN, np.int32)
    sym = np.zeros(NN, np.int32)
    flat_base = np.zeros(NN, np.int32)
    flat_d32 = np.ones(NN, np.int32)    # 1 keeps p*D harmless on non-flats
    c2s_parts: list[np.ndarray] = []
    fpos = 0
    for nid in range(n_nodes):
        if t.sym[nid] >= 0:
            typ[nid] = 1
            sym[nid] = int(t.sym[nid])
            continue
        if t.flat_d[nid] > 0 and not t.covered[nid]:
            D = int(t.flat_d[nid])
            typ[nid] = 2
            flat_d32[nid] = D
            flat_base[nid] = fpos
            c2s_parts.append(_flat_table(t, nid, D))
            fpos += 1 << D
            continue
        ch0, ch1 = int(t.child[nid, 0]), int(t.child[nid, 1])
        nxt0[nid] = max(ch0, 0)
        nxt1[nid] = max(ch1, 0)
    c2s = (np.concatenate(c2s_parts) if c2s_parts
           else np.zeros(1, np.uint8))
    return SectionPlan(nxt0, nxt1, run_off, typ, sym, flat_base, flat_d32,
                       c2s, n, t.max_depth + 1, pos)


def _flat_table(t: PivcoTree, nid: int, D: int) -> np.ndarray:
    """Path-index -> symbol for a flat root (bit j = branch at depth j)."""
    c2s = np.zeros(1 << D, np.uint8)
    stack = [(nid, 0, 0)]
    while stack:
        cn, cp, cl_ = stack.pop()
        if t.sym[cn] >= 0:
            c2s[cp] = t.sym[cn]
            continue
        stack.append((int(t.child[cn, 0]), cp, cl_ + 1))
        stack.append((int(t.child[cn, 1]), cp | (1 << cl_), cl_ + 1))
    return c2s


# ---------------------------------------------------------------------------
# The routing, as tensor ops
# ---------------------------------------------------------------------------

def _popcount_u8(v: torch.Tensor) -> torch.Tensor:
    """Branch-free popcount of values < 256 held in int32 lanes."""
    v = v - ((v >> 1) & 0x55)
    v = (v & 0x33) + ((v >> 2) & 0x33)
    return (v + (v >> 4)) & 0x0F


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[b, idx[b, i]]`` along dim 1 with JAX's gather semantics: a
    negative index counts from the end once, and the result is clamped
    into the row (a valid plan never needs either)."""
    size = table.shape[1]
    idx = torch.where(idx < 0, idx + size, idx).clamp_(0, size - 1)
    return torch.gather(table, 1, idx.long())


def route_sections(sec, nxt0, nxt1, run_off, typ, sym, flat_base, flat_d,
                   c2s, n, *, L: int, rounds: int) -> torch.Tensor:
    """Batched section decode on the tensors' device (JAX's
    ``routing_kernel(L, RSEC, FLAT, rounds)`` under ``vmap``).

    Args: sec (B, RSEC) uint8 node-run bytes, the seven (B, NN) int32
    tables of ``pad_plans``, c2s (B, FLAT) uint8, n (B,) int32; ``L`` the
    lanes a row, ``rounds`` the routing rounds (at least every section's
    max depth + 1). Returns (B, L) uint8 decoded symbols, 0 past ``n``.
    """
    B, RSEC = sec.shape
    FLAT = c2s.shape[1]
    sec32 = sec.to(_I32)
    pop = _popcount_u8(sec32)
    P = torch.cumsum(pop, 1, dtype=_I32) - pop    # exclusive, (B, RSEC)
    # a node id lives in 9 bits of JAX's packed word: node stays in [0, NN)
    nxt0 = nxt0 & (NN - 1)
    nxt1 = nxt1 & (NN - 1)
    ones_b = _take(P, run_off.clamp_max(RSEC - 1))

    p = torch.arange(L, dtype=_I32, device=sec.device).expand(B, L)
    live = p < n[:, None]
    p = p.contiguous()
    node = torch.zeros((B, L), dtype=torch.int64, device=sec.device)
    for _ in range(rounds):
        step = live & (torch.gather(typ, 1, node) == 0)
        bidx = (torch.gather(run_off, 1, node) + (p >> 3)).clamp_max(RSEC - 1)
        byte = _take(sec32, bidx)
        r = p & 7
        ones = (_take(P, bidx) - torch.gather(ones_b, 1, node)
                + _popcount_u8(byte & ((1 << r) - 1)))
        one = ((byte >> r) & 1) == 1
        nb = torch.where(one, torch.gather(nxt1, 1, node),
                         torch.gather(nxt0, 1, node))
        node = torch.where(step, nb.long(), node)
        p = torch.where(step, torch.where(one, ones, p - ones), p)
    # every live lane now sits on a terminal (leaf or flat root): one
    # flat-bit fetch and one table lookup resolve its symbol
    D = torch.gather(flat_d, 1, node)
    bp = p * D
    fb = torch.gather(run_off, 1, node) + (bp >> 3)
    wfl = (_take(sec32, fb.clamp_max(RSEC - 1))
           | (_take(sec32, (fb + 1).clamp_max(RSEC - 1)) << 8)
           | (_take(sec32, (fb + 2).clamp_max(RSEC - 1)) << 16))
    path = (wfl >> (bp & 7)) & ((1 << D) - 1)
    oflat = _take(c2s, (torch.gather(flat_base, 1, node) + path)
                  .clamp_max(FLAT - 1))
    out = torch.where(torch.gather(typ, 1, node) == 1,
                      torch.gather(sym, 1, node).to(torch.uint8), oflat)
    return torch.where(live, out, torch.zeros((), dtype=torch.uint8,
                                              device=sec.device))


def _pow2(n: int, lo: int = 8) -> int:
    return max(lo, 1 << (max(n, 1) - 1).bit_length())


def pad_plans(payloads: list[np.ndarray], plans: list[SectionPlan],
              L: int | None = None, RSEC: int | None = None,
              FLAT: int | None = None):
    """Stack sections + plans into fixed-shape batch arrays (host numpy)."""
    B = len(plans)
    if L is None:
        L = _pow2(max(p.n for p in plans))
    if RSEC is None:
        RSEC = _pow2(max(max(p.sec_len for p in plans), 4))
    if FLAT is None:
        FLAT = _pow2(max(len(p.c2s) for p in plans))
    sec = np.zeros((B, RSEC), np.uint8)
    c2s = np.zeros((B, FLAT), np.uint8)
    tabs = {k: np.zeros((B, NN), np.int32)
            for k in ("nxt0", "nxt1", "run_off", "typ", "sym", "flat_base")}
    flat_d = np.ones((B, NN), np.int32)
    n = np.zeros(B, np.int32)
    for j, (pay, p) in enumerate(zip(payloads, plans)):
        sec[j, :p.sec_len] = pay[:p.sec_len]
        c2s[j, :len(p.c2s)] = p.c2s
        tabs["nxt0"][j] = p.nxt0
        tabs["nxt1"][j] = p.nxt1
        tabs["run_off"][j] = p.run_off
        tabs["typ"][j] = p.typ
        tabs["sym"][j] = p.sym
        tabs["flat_base"][j] = p.flat_base
        flat_d[j] = p.flat_d
        n[j] = p.n
    rounds = max(p.rounds for p in plans)
    return (sec, tabs["nxt0"], tabs["nxt1"], tabs["run_off"], tabs["typ"],
            tabs["sym"], tabs["flat_base"], flat_d, c2s, n), L, RSEC, FLAT, rounds


def route_padded(args, L: int, rounds: int, dev) -> torch.Tensor:
    """``pad_plans``'s host arrays to ``dev`` and through
    ``route_sections`` with at least MAX_LEN + 1 rounds (the JAX
    package's floor, so one rounds count serves every tree)."""
    t = [torch.from_numpy(a).to(dev) for a in args]
    return route_sections(*t, L=L, rounds=max(rounds, MAX_LEN + 1))


def decode_sections_device(payloads: list[np.ndarray], ns: list[int],
                           trees: list[PivcoTree], device=None,
                           L: int | None = None) -> list[np.ndarray]:
    """Decode many PivCo sections on the device; returns per-section
    uint8. Payloads are the node-run bytes (no 128-byte lengths header).
    ``device``: None means cuda (raises without it); "cpu" runs the same
    tensor ops on the CPU."""
    dev = _device(device, "decode_sections_device")
    if not payloads:
        return []
    plans = [plan_section(pay, n, t)
             for pay, n, t in zip(payloads, ns, trees)]
    args, L, _, _, rounds = pad_plans(payloads, plans, L=L)
    out = route_padded(args, L, rounds, dev).cpu().numpy()
    return [out[j, :p.n] for j, p in enumerate(plans)]
