"""The schedule of the piece-serial attic kernel (v1-v3) on the card, as a
numpy model run on the CPU.

``piece_model`` follows ``csrc/attic.cu``'s ``piece_serial_kernel`` for
each (block, 1024-byte window): the CTA-wide search that narrows the
window's first piece (the last with o <= w0) to ``THREADS`` candidates or
fewer (rounds in which each of the CTA's threads reads one probe and the
count of true probes narrows the range), the stage rounds of ``STAGE``
pieces from the first candidate on until one starts past the window,
each piece marking ``owner[max(o - w0, 0)]`` with its index by a max
(the last of equal starts wins) and staging its literal base
(``piece_base``: the remainder taken once a piece), the inclusive
max-scan of ``owner``, and the resolve: each byte's piece read from the
last round's stage or from the pieces array (its base computed there),
its literal index the base plus the byte's position with int32
arithmetic that wraps, v2/v3's fill of ``s & 255``, 0 before the first
piece, from ``totals`` on and outside the literal row.

It is held against the port's plain version
(``attic.piece_serial_reference``) and against the JAX kernel
(``kernel_attic.decode_blocks`` in interpret mode, variants 1-3, as
``tests/test_torch_attic.py`` runs it) on packed archives and hand-made
plans: equal piece starts, windows with more pieces than a stage round
(one-byte pieces), fills, literal indices outside the row, totals inside a
window, and against the plain version on ``test_torch_cuda.random_pieces``
garbage (any s, k below 1, counts past the pieces array) with small
search and stage rounds so that a window takes several. Tolerance: exact
equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_piece_schedule.py
"""
import os
import sys

import numpy as np
import pytest
import torch

from zxc_tpu_torch.ops import attic as A

from test_torch_cuda import random_pieces

WINDOW = 1024
THREADS = 256            # csrc/attic.cu kThreads: probes a search round
STAGE = 256              # csrc/attic.cu kPieceStage


def first_candidate(o, n: int, x: int, threads: int = THREADS):
    """(a piece at or before the last with o[j] <= x, 0 for none; rounds)
    by the kernel's search: while more than ``threads`` candidates are
    left, ``threads`` probes one step apart, and the count of true probes
    narrows [lo, hi] (the count of pieces with o <= x lies in it) to one
    step."""
    lo, hi, rounds = 0, n, 0
    t = np.arange(threads)
    while hi - lo > threads:
        rounds += 1
        step = -(-(hi - lo) // threads)
        q = lo + (t + 1) * step - 1
        c = int((o[q[q < hi]] <= x).sum())
        hi = min(hi, lo + (c + 1) * step - 1)
        lo += c * step
    return max(lo - 1, 0), rounds


def wrap(v):
    return np.asarray(v, np.int64).astype(np.int32).astype(np.int64)


def piece_base(pc, w0: int):
    """Each piece's literal index less the byte's position: c + rem(max(o,
    w0) - s, k) - max(o, w0), int32 arithmetic that wraps, a truncating
    remainder and k below 1 as 1."""
    p0 = np.maximum(pc[:, 0], w0)
    k = np.maximum(pc[:, 3], 1)
    return wrap(wrap(pc[:, 1] + np.fmod(wrap(p0 - pc[:, 2]), k)) - p0)


def piece_model(npieces, totals, pcs, lit8, block: int, fill_from_s: bool,
                threads: int = THREADS, stage: int = STAGE,
                stats: dict | None = None):
    """(B, block) uint8 of the kernel's schedule. ``stats`` (optional)
    receives the search and stage rounds."""
    B = pcs.shape[0]
    cap = pcs.shape[1] * 32
    f = pcs.reshape(B, cap, 4).astype(np.int64)
    L = lit8.shape[1] * 128
    out = np.zeros((B, block), np.uint8)
    pos = np.arange(WINDOW)
    for b in range(B):
        n = min(max(int(npieces[b]), 0), cap)
        T = min(max(int(totals[b]), 0), block)
        o = f[b, :, 0]
        lit = lit8[b].reshape(-1)
        for w0 in range(0, block, WINDOW):
            owner = np.full(WINDOW, -1, np.int64)
            base = np.zeros(stage, np.int64)       # the stage's bases
            r0, rounds = first_candidate(o, n, w0, threads)
            while True:                            # stage rounds
                j = r0 + np.arange(stage)
                live = j < n
                oj = np.where(live, o[np.minimum(j, cap - 1)], 0)
                inn = live & (oj <= w0 + WINDOW - 1)
                st = f[b, np.minimum(j, cap - 1)]
                base[j[live] - r0] = piece_base(st[live], w0)
                np.maximum.at(owner, np.where(oj <= w0, 0, oj - w0)[inn],
                              j[inn])
                if stats is not None:
                    stats["stage"] = stats.get("stage", 0) + 1
                if not inn.all():
                    break
                r0 += stage
            if stats is not None:
                stats["search"] = stats.get("search", 0) + rounds
                stats["windows"] = stats.get("windows", 0) + 1
            jp = np.maximum.accumulate(owner)     # the max-scan
            pq = w0 + pos
            live = (jp >= 0) & (pq < T)
            jl = np.where(live, jp, 0)
            assert (jl[live & (jl >= r0)] < r0 + stage).all()
            pc = np.where(live[:, None], f[b, jl], [0, 0, 0, 1])
            staged = live & (jl >= r0)
            bj = piece_base(pc, w0)                # earlier rounds: global
            bj[staged] = base[jl[staged] - r0]
            idx = wrap(bj + pq)
            ok = live & (idx >= 0) & (idx < L)
            v = np.where(ok, lit[np.clip(idx, 0, max(L - 1, 0))], 0)
            if fill_from_s:
                v = np.where(live & (pc[:, 3] == 1), pc[:, 2] & 255, v)
            out[b, w0:w0 + WINDOW] = v
    return out


def plain(args, block, fill):
    return A.piece_serial_reference(*(torch.from_numpy(a) for a in args),
                                    block=block, fill_from_s=fill).numpy()


def jax_bytes(pieces, lits, totals, block, variant):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    import kernel_attic
    return kernel_attic.decode_blocks(pieces, lits, totals, block,
                                      interpret=True, variant=variant)


def edge_plans(seed: int, block: int = 4096, before_row: bool = False):
    """Two blocks of pieces: block 0 has 300 one-byte pieces inside its
    second window (more than a stage round), a run of equal starts (only
    the last of them covers its bytes), fills (k = 1) and sources past
    the end of a 1,000-byte lit (with ``before_row`` also before its
    start, which the JAX bodies leave undefined); block 1 a single piece
    from 0 spanning the block and a total inside its third window."""
    rng = np.random.default_rng(seed)
    po = np.r_[0, 700, 1024 + np.arange(300), 1400, 1400, 1400, 1401,
               2047, 2048, 3000, 3000, 3500].astype(np.int32)
    n = len(po)
    pk = rng.choice([1, 2, 3, 7, 100], n).astype(np.int32)
    pc = rng.integers(0, 900, n).astype(np.int32)
    ps = (po + rng.integers(-50, 50, n)).astype(np.int32)
    pc[-1], pc[-2] = 990, 980          # lit indices past the row's end
    pk[-1], pk[-2], pk[-4] = 64, 64, 64
    if before_row:                     # indices -50 .. -1 from 2048 on
        pc[-4], ps[-4] = -40, 2058
    lit0 = rng.integers(0, 256, 1000, dtype=np.uint8)
    one = (np.array([0], np.int32), np.array([5], np.int32),
           np.array([-3], np.int32), np.array([9], np.int32))
    lit1 = rng.integers(0, 256, 64, dtype=np.uint8)
    return [(po, pc, ps, pk), one], [lit0, lit1], [block, 2 * 1024 + 333]


@pytest.mark.parametrize("variant", [1, 2, 3])
@pytest.mark.parametrize("seed", range(2))
def test_piece_model_equals_jax_on_edge_plans(seed, variant):
    block = 4096
    pieces, lits, totals = edge_plans(seed, block)
    args, _ = A.pack_blocks(pieces, lits, totals, block)
    fill = A.VARIANTS[variant]
    stats = {}
    got = piece_model(*args, block, fill, stats=stats)
    assert np.array_equal(got, plain(args, block, fill))
    want = jax_bytes(pieces, lits, totals, block, variant)
    assert [got[j, :totals[j]].tobytes() for j in range(2)] == want
    assert stats["stage"] > stats["windows"]     # a window of two rounds
    assert not got[1, totals[1]:].any()


@pytest.mark.parametrize("fill", [False, True])
def test_piece_model_reads_zero_before_the_row(fill):
    pieces, lits, totals = edge_plans(2, 4096, before_row=True)
    args, _ = A.pack_blocks(pieces, lits, totals, 4096)
    got = piece_model(*args, 4096, fill)
    assert np.array_equal(got, plain(args, 4096, fill))
    assert not got[0, 2048:2098].any() and got[0, 2098:2148].any()


@pytest.mark.parametrize("stage", [STAGE, 7])
@pytest.mark.parametrize("threads", [THREADS, 4])
@pytest.mark.parametrize("fill", [False, True])
@pytest.mark.parametrize("garbage", [False, True])
def test_piece_model_equals_plain_version(garbage, fill, threads, stage):
    """``random_pieces`` plans (garbage: any s, k below 1 and huge, c past
    both ends of the row, counts past pcs and totals past the block),
    with the search at 4 probes a round and stage rounds of 7, so a
    window takes several of each."""
    for seed, (B, block) in enumerate(((1, 1024), (3, 4096), (2, 16384))):
        args = random_pieces(seed, B, block, garbage)
        stats = {}
        got = piece_model(*args, block, fill, threads, stage, stats)
        assert np.array_equal(got, plain(args, block, fill))
        if threads < THREADS:
            assert stats["search"] > stats["windows"]


@pytest.mark.parametrize("variant", [1, 2, 3])
@pytest.mark.parametrize("name,block", [("l3", 4096), ("fills", 4096),
                                        ("cross", 16384)])
def test_piece_model_equals_jax_on_packed_archive(name, block, variant):
    from test_torch_attic import _archive, _resolved
    from test_torch_jax_native import jax_native
    jax_native()      # the archive is resolved by the JAX runtime
    data, arc, do = _archive(name, block)
    plan, pieces, lits = _resolved(arc, do)
    args, _ = A.pack_blocks(pieces, lits, plan.totals, block)
    fill = A.VARIANTS[variant]
    stats = {}
    got = piece_model(*args, block, fill, stats=stats)
    assert np.array_equal(got, plain(args, block, fill))
    want = jax_bytes(pieces, lits, list(plan.totals), block, variant)
    assert [got[j, :t].tobytes() for j, t in enumerate(plan.totals)] == want
    assert b"".join(want) == data
    # these blocks' few hundred pieces: at most one search round a window
    assert stats["search"] <= stats["windows"]


def test_first_candidate_brackets_the_first_piece():
    """The candidate is at or before the last piece with o <= x, at most
    ``threads`` before it; 9,216 pieces take one round, 256 none."""
    rng = np.random.default_rng(6)
    for n in (0, 1, 5, 256, 257, 9216, 70000):
        o = np.sort(rng.integers(0, 65536, max(n, 1)))
        for x in (-1, 0, 1023, 4096, 65535):
            for threads in (4, THREADS):
                got, rounds = first_candidate(o, n, x, threads)
                i0 = max(int((o[:n] <= x).sum()) - 1, 0)
                assert got <= i0 <= got + threads
                assert (o[got:i0] <= x).all()
        if n in (256, 9216):
            assert first_candidate(o, n, 4096)[1] == (n > THREADS)
