"""The schedules of the parse walk and the grid gather on the card, as
numpy models run on the CPU.

``walk_model`` follows ``csrc/encode.cu``'s parse walk phase by phase:
the chunks of ``encode_kernels.walk_plan``, the speculative walk of each
chunk from its first position with its marks, the synchronizing rounds
(a chunk whose entry changed walks until it meets a mark or leaves the
chunk; a new path's marks replace the old ones; a chunk whose entry lies
past it keeps its entry as its exit), the serial finish after
``WALK_MAX_ROUNDS`` rounds or a round that changes more than half the
chunks (taking a chunk's exit where its entry lies on its marked path),
then the count,
scan and write from the true entries (each chunk walks to its first
marked position, and takes the marked path's records from there). It is held against the JAX
``parse_walk_kernel`` (interpret mode, as ``tests/test_torch_encode.py``
runs it) and a plain cursor walk on the pinned corpus's steps at levels
1, 3 and 5, steps on which walks never meet (all 5, all 3), all 2 (more
records than ``pos`` holds), steps that jump over whole chunks, steps of
0 or below (cursor walk only: the JAX kernel never ends on them), P = 1,
P off the chunk size and P = 200,000 (the kernel's global-memory form).

``grid_model`` follows ``csrc/gather.cu``'s grid gather over
``probes.grid_plan``: in the cluster form each CTA's slice of the table
row and its cluster's index columns, thread by thread, every output
written exactly once, by the CTA whose slice holds its element; in the L2
form each CTA's columns; held against ``pallas_gather_grid`` in interpret
mode. Tolerance: exact equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_walk_schedule.py
"""
import functools
import os
import sys

import numpy as np
import pytest
import torch

from zxc_tpu_torch.codec import frame
from zxc_tpu_torch.ops import encode as PE, encode_kernels as EK
from zxc_tpu_torch.ops import probes as P

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")


# -- the walk ----------------------------------------------------------------

def walk_model(step: np.ndarray, cap: int | None = None):
    """One row through the kernel's phases. Returns (nseq, pos (cap,)
    int64 with 0 where the walk writes nothing, rounds, first chunk walked
    serially or -1)."""
    step = np.asarray(step, np.int64)
    Pn = len(step)
    cap = Pn // 5 + 1 if cap is None else cap
    plan = EK.walk_plan(Pn)
    adv = np.clip(step, 1, max(Pn, 2))     # over 1 where the step is
    ch, nch = plan.chunk, plan.chunks
    c0 = [k * ch for k in range(nch)]
    c1 = [min(c + ch, Pn) for c in c0]
    marks = np.zeros(Pn, bool)

    def nxt(p):
        return min(p + int(adv[p]), Pn)

    def walk_marking(p, k):
        while p < c1[k]:
            marks[p] = True
            p = nxt(p)
        return p

    exits = [walk_marking(c0[k], k) for k in range(nch)]
    entry = list(c0)
    rounds, serial_from = 0, -1
    while True:
        ent = [0] + exits[:-1]
        changed = []
        for k in range(nch):
            if ent[k] == entry[k]:
                continue
            entry[k] = e = ent[k]
            nx = e
            if e < c1[k]:
                p = e
                while p < c1[k] and not marks[p]:
                    p = nxt(p)
                if p < c1[k]:
                    nx = exits[k]              # met the marked path
                else:
                    marks[c0[k]:c1[k]] = False
                    nx = walk_marking(e, k)
            else:
                marks[c0[k]:c1[k]] = False
            if nx != exits[k]:
                exits[k] = nx
                changed.append(k)
        rounds += 1
        if not changed:
            break
        if rounds >= EK.WALK_MAX_ROUNDS or 2 * len(changed) > nch:
            c = changed[0]
            p = exits[c]
            serial_from = c + 1
            for c in range(c + 1, nch):
                if p < c1[c] and marks[p]:
                    p = exits[c]          # an entry on the marked path
                else:
                    while p < c1[c]:
                        p = nxt(p)
                exits[c] = p
            break
    # each chunk walks from its true entry to its first marked position
    # q; from q on, its records are the marked positions whose step is over
    # 1 (the marks are one path's, so q's suffix of it)
    ent = [0] + exits[:-1]
    records = []
    for k in range(nch):
        p = ent[k]
        while p < c1[k] and not marks[p]:
            if adv[p] > 1:
                records.append(p)
            p = nxt(p)
        records += [q for q in range(p, c1[k]) if marks[q] and adv[q] > 1]
    # the scan's first j of each chunk, then the writes in any order
    pos = np.zeros(cap, np.int64)
    n = len(records)
    for j, p in enumerate(records):
        if j < cap - 1 or j == n - 1:
            pos[min(j, cap - 1)] = p
    return n, pos, rounds, serial_from


def cursor_walk(step: np.ndarray, cap: int):
    """The walk as one cursor (``tests/test_torch_encode._walk_oracle``)."""
    Pn = len(step)
    pos = np.zeros(cap, np.int64)
    p = j = 0
    while p < Pn:
        s = int(step[p])
        if s > 1:
            pos[min(j, cap - 1)] = p
            j += 1
        p += min(max(s, 1), Pn)
    return j, pos


def jax_walk(step: np.ndarray, cap: int):
    """``zxc_tpu.ops.pallas_encode.parse_walk_kernel`` in interpret mode
    (steps of at least 1): (nseq, pos with 0 past min(nseq, cap))."""
    import jax.numpy as jnp
    from zxc_tpu.ops import pallas_encode as JPE
    n, pos = JPE.parse_walk_kernel(len(step), cap, interpret=True)(
        jnp.asarray(step.astype(np.int32)))
    n = int(n[0])
    pos = np.asarray(pos).astype(np.int64)
    pos[min(n, cap):] = 0
    return n, pos


@functools.lru_cache(maxsize=None)
def corpus_steps(level: int) -> np.ndarray:
    """The steps of the pinned corpus's first 64 KiB block at ``level``,
    as ``compress_device`` feeds the walk."""
    sys.path.insert(0, TOOLS)
    from gen_corpus import gen_corpus
    params = frame.level_params(level)
    blk = torch.from_numpy(np.frombuffer(gen_corpus(32 << 20), np.uint8,
                                         65536).copy())[None]
    lens = PE.find_matches_device_lcp_batch(blk, params.n_candidates)[0]
    return PE.walk_steps(lens, params.lazy, params.min_emit)[0].numpy()


def chunk_jumps(Pn: int) -> np.ndarray:
    """Steps of 1 with a few long jumps: one past two whole chunks, one
    onto a chunk's last position, one past the row's end."""
    ch = EK.walk_plan(Pn).chunk
    step = np.ones(Pn, np.int64)
    step[3] = 2 * ch + 5
    step[5 * ch - 1] = ch + 1
    step[7 * ch + 2] = 3 * ch
    step[Pn - ch // 2] = Pn
    return step


def inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(len(name))
    if name.startswith("corpus"):
        return corpus_steps(int(name[-1]))
    return {
        "all5": lambda: np.full(65536, 5),
        "all3": lambda: np.full(65536, 3),
        "all2": lambda: np.full(65536, 2),
        # walks that never meet in one part of the row: the rounds run
        # out, then the serial finish
        "half5": lambda: np.concatenate([np.full(32768, 5),
                                         np.ones(32768)]),
        "ones_then3": lambda: np.concatenate([np.ones(32768),
                                              np.full(32768, 3)]),
        "jumps": lambda: chunk_jumps(65536),
        "p1": lambda: np.array([7]),
        "p1_miss": lambda: np.array([1]),
        "odd_p": lambda: np.where(rng.random(40_001) < 0.15,
                                  rng.integers(5, 60, 40_001), 1),
        "p200k": lambda: np.where(rng.random(200_000) < 0.1,
                                  rng.integers(5, 300, 200_000), 1),
        "p200k_all5": lambda: np.full(200_000, 5),
        "p200k_jumps": lambda: chunk_jumps(200_000),
    }[name]().astype(np.int64)


POSITIVE = ["corpus1", "corpus3", "corpus5", "all5", "all3", "all2",
            "half5", "ones_then3", "jumps", "p1", "p1_miss", "odd_p", "p200k", "p200k_all5",
            "p200k_jumps"]


@pytest.mark.parametrize("name", POSITIVE)
def test_walk_model_equals_jax_kernel_and_cursor_walk(name):
    step = inputs(name)
    cap = len(step) // 5 + 1
    n, pos, _, _ = walk_model(step, cap)
    want_n, want_pos = cursor_walk(step, cap)
    assert n == want_n and np.array_equal(pos, want_pos)
    jn, jpos = jax_walk(step, cap)
    assert n == jn and np.array_equal(pos, jpos)


@pytest.mark.parametrize("seed", range(4))
def test_walk_model_on_steps_of_zero_and_below(seed):
    rng = np.random.default_rng(seed)
    Pn = [3000, 65536, 70_001, 200_000][seed]
    step = rng.integers(-4, 9, Pn)
    step[rng.random(Pn) < 0.01] = rng.integers(-2**31, 2**31 - 1, 1)[0]
    for cap in (Pn // 5 + 1, 7, 1):
        n, pos, _, _ = walk_model(step, cap)
        want_n, want_pos = cursor_walk(step, cap)
        assert n == want_n and np.array_equal(pos, want_pos)


@pytest.mark.parametrize("name,rounds,serial", [
    ("corpus1", (1, 2), False), ("corpus3", (1, 2), False),
    ("corpus5", (1, 2), False), ("all2", (1, 1), False),
    ("all5", (1, 1), True), ("all3", (1, 1), True),
    ("half5", (EK.WALK_MAX_ROUNDS,) * 2, True),
    ("ones_then3", (EK.WALK_MAX_ROUNDS,) * 2, True),
    ("p200k_all5", (1, 1), True)])
def test_walk_model_rounds(name, rounds, serial):
    """Real parses settle in a round or two; walks that never meet hand
    over to the serial finish after the first round, which changes most
    chunks, or after ``WALK_MAX_ROUNDS`` rounds where they never meet in
    part of the row; all 2 needs no round to change anything (every chunk
    starts on an even position)."""
    step = inputs(name)
    n, _, r, serial_from = walk_model(step)
    assert rounds[0] <= r <= rounds[1]
    assert (serial_from >= 0) == serial
    if name.startswith("all") or name.endswith("all5"):
        assert n == len(step) // int(step[0]) + (len(step) % int(step[0]) > 0)


def test_walk_cap_overflow_keeps_the_last_record():
    step = inputs("all2")
    cap = len(step) // 5 + 1
    n, pos, _, _ = walk_model(step, cap)
    assert n == 32768 > cap
    assert pos[cap - 1] == 2 * (n - 1) and pos[cap - 2] == 2 * (cap - 2)


@pytest.mark.parametrize("Pn", [0, 1, 31, 32, 33, 2048, 40_001, 65535,
                                65536, 65537, 200_000, 2**31 - 1])
def test_walk_plan(Pn):
    plan = EK.walk_plan(Pn)
    assert plan.chunk >= 32 and plan.chunk % 32 == 0
    assert plan.chunks == -(-Pn // plan.chunk) <= EK.WALK_THREADS
    assert (plan.chunks - 1) * plan.chunk < Pn or Pn == 0
    assert plan.words == -(-Pn // 32)
    # each chunk owns whole bitmap words: no two threads write one word
    assert all((k * plan.chunk) % 32 == 0 for k in range(min(plan.chunks,
                                                             4)))
    assert plan.shared == (Pn <= EK.WALK_SHARED_MAX)
    if plan.shared:
        assert plan.smem == -(-2 * Pn // 16) * 16 + 8 * plan.words
        # with the kernel's static exits, sums and flag: within 227 KB
        assert plan.smem + 4 * EK.WALK_THREADS + 4 * 32 + 4 <= 232_448
    else:
        assert plan.smem == 0


# -- the grid gather -----------------------------------------------------------

def thread_columns(plan, threads: int, cols: int = 16) -> np.ndarray:
    """Each pass's columns as the kernel's threads take them, relative to
    the pass's first column, (threads, cols): the L2 form's vector pass
    (int32: cols / 4 groups of 4 adjacent, uint8: cols / 16 groups of 16,
    the groups strided by the CTA's width), else cols strided by the
    CTA's width."""
    t = np.arange(threads)[:, None, None]
    if plan.vec:
        run = 4 if plan.esize == 4 else 16
        g = np.arange(cols // run)[None, :, None]
        return ((g * threads + t) * run + np.arange(run)).reshape(
            threads, cols)
    return np.arange(cols)[None, :] * threads + t[:, :, 0]


def grid_model(x: np.ndarray, idx: np.ndarray, plan) -> np.ndarray:
    """The grid gather by ``plan``'s schedule, checking that every output
    is written exactly once: in the cluster form by the CTA whose slice
    holds its element (rank 0 for an index outside the row), each CTA
    reading only its own slice; in the L2 form by the CTA of its columns,
    in passes of its threads."""
    M, N = x.shape
    NI = idx.shape[1]
    out = np.zeros(idx.shape, x.dtype)
    written = np.zeros(idx.shape, np.int64)
    cluster = plan.form == "cluster"
    threads = plan.threads
    width = P.GRID_COLS if cluster else P.GRID_L2_COLS
    if cluster:
        assert threads == P.GRID_THREADS
    else:
        assert threads in P.GRID_L2_THREADS
        assert plan.cols % (threads * width) == 0
    cols = thread_columns(plan, threads, width).reshape(-1)
    assert sorted(cols.tolist()) == list(range(width * threads))
    if plan.vec:     # 16-byte loads and stores start on 16 bytes
        assert not cluster and NI % (16 // plan.esize) == 0
    for i in range(M):
        # (rank, first element, slice) of each CTA of a cluster
        ranks = ([(r, r * plan.slice, x[i, r * plan.slice:
                                          (r + 1) * plan.slice])
                  for r in range(plan.K)] if cluster
                 else [(0, 0, x[i])])
        assert np.array_equal(np.concatenate([s for _, _, s in ranks]),
                              x[i])
        for g in range(plan.clusters):
            j0 = g * plan.cols
            j1 = min(j0 + plan.cols, NI)
            for r, lo, part in ranks:
                for cb in range(j0, j1, width * threads):
                    c = cb + cols
                    c = c[c < j1]
                    k = idx[i, c].astype(np.int64)
                    mine = (k >= lo) & (k < lo + len(part))
                    zero = ((k < 0) | (k >= N)) & (r == 0)
                    out[i, c[mine]] = part[k[mine] - lo]
                    out[i, c[zero]] = 0
                    written[i, c[mine | zero]] += 1
    assert (written == 1).all()
    return out


GRID_CASES = [  # M, N, NI, esize, aligned, sms, form, K
    (8, 65536, 1 << 19, 4, True, 132, "cluster", 2),
    (8, 65536, 1 << 19, 4, False, 132, "cluster", 2),
    (3, 1000, 8192, 4, True, 132, "cluster", 1),
    (4, 65536, 1 << 19, 1, True, 132, "cluster", 1),
    (2, 420_000, 3_360_000, 1, True, 132, "cluster", 4),
    (2, 7000, 56_008, 1, True, 132, "cluster", 1),
    (8, 65536, 1 << 15, 4, True, 132, "l2", 1),
    (3, 1000, 3000, 4, True, 132, "l2", 1),
    (200, 10_000, 20_000, 4, True, 132, "l2", 1),
    (2, 1 << 19, 4096, 4, True, 16, "l2", 1),
    (3, 1 << 19, 4100, 4, False, 132, "l2", 1),
    (2, 2_000_000, 4104, 1, True, 132, "l2", 1),
    (3, 0, 100, 4, True, 132, "l2", 1),
]


@pytest.mark.parametrize("M,N,NI,esize,aligned,sms,form,K", GRID_CASES)
def test_grid_plan_covers_rows_and_columns(M, N, NI, esize, aligned, sms,
                                           form, K):
    plan = P.grid_plan(M, N, NI, esize, aligned, sms)
    assert (plan.form, plan.K) == (form, K)
    if form == "cluster":
        assert plan.K * plan.slice >= N > (plan.K - 1) * plan.slice
        assert plan.slice * esize % 16 == 0
        assert plan.smem == plan.slice * esize <= P.GRID_MAX_SLICE
        assert plan.clusters * plan.cols >= NI and not plan.vec
        assert M * plan.K * plan.clusters <= max(sms, M * plan.K)
    else:
        assert plan.threads in P.GRID_L2_THREADS
        assert plan.cols % (plan.threads * P.GRID_L2_COLS) == 0
        assert plan.clusters == max(1, -(-NI // plan.cols))
        assert M * plan.clusters <= max(sms, M) and plan.smem == 0
        assert plan.vec == (aligned and NI % (16 // esize) == 0)
        assert (NI < P.GRID_CLUSTER_READS * N or N == 0
                or N * esize > P.GRID_MAX_CLUSTER * P.GRID_MAX_SLICE)
    rng = np.random.default_rng(M * N + NI)
    dt = np.int32 if esize == 4 else np.uint8
    x = rng.integers(0, 256, (M, N)).astype(dt)
    idx = rng.integers(-3, N + 3, (M, NI)).astype(np.int32)
    idx[:, ::13] = rng.integers(-2**31, 2**31 - 1, idx[:, ::13].shape)
    got = grid_model(x, idx, plan)
    ok = (idx >= 0) & (idx < N)
    want = (np.where(ok, np.take_along_axis(x, np.where(ok, idx, 0), 1), 0)
            if N else np.zeros(idx.shape, dt))
    assert np.array_equal(got, want)


def test_grid_plan_of_the_probe_shape():
    """x (8, 64K) int32, idx (8, 512K): clusters of 2 CTAs of 128 KiB, 8
    clusters a row (128 CTAs on 132 SMs), 64K columns a cluster, whatever
    the index view's alignment; x (2, 1M) with a square index takes the
    L2 form, 64 CTAs of 512 threads a row, 2 passes each."""
    want = P.GridPlan(8, 1 << 16, 1 << 19, 4, "cluster", 2, 8, 1 << 15,
                      1 << 16, False, 128 << 10, 1024)
    assert P.grid_plan(8, 1 << 16, 1 << 19, 4) == want
    assert P.grid_plan(8, 1 << 16, 1 << 19, 4, aligned=False) == want
    assert P.grid_plan(2, 1 << 20, 1 << 20, 4) == P.GridPlan(
        2, 1 << 20, 1 << 20, 4, "l2", 1, 64, 0, 16384, True, 0, 512)


@pytest.mark.parametrize("M,N,tile,dtype,sms", [
    (8, 1024, 512, np.int32, 132), (8, 2048, 1024, np.uint8, 132),
    (4, 1000, 256, np.int32, 4)])
def test_grid_model_equals_jax_grid_gather(monkeypatch, M, N, tile, dtype,
                                           sms):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    sys.path.insert(0, TOOLS)
    import tpu_pallas_gather_probe as gather_probe
    monkeypatch.setattr(pl, "pallas_call", functools.partial(
        pl.pallas_call, interpret=True))
    rng = np.random.default_rng(N)
    x = rng.integers(0, 256 if dtype == np.uint8 else 100,
                     (M, N)).astype(dtype)
    NI = -(-P.GRID_CLUSTER_READS * N // tile) * tile   # the cluster form
    idx = rng.integers(0, N, (M, NI)).astype(np.int32)
    want = np.asarray(gather_probe.pallas_gather_grid(
        jnp.asarray(x), jnp.asarray(idx), tile))
    plan = P.grid_plan(M, N, NI, x.itemsize, True, sms)
    assert plan.form == "cluster"
    assert np.array_equal(grid_model(x, idx, plan), want)
    for vec in (True, False):     # the L2 form's passes on the same input
        for threads, passes in ((256, 1), (64, 3)):
            l2 = P.l2_plan(M, N, NI, x.itemsize, vec, threads, passes)
            assert np.array_equal(grid_model(x, idx, l2), want)
