"""The schedule of the window merge (v4-v7) on the card, as a numpy model
run on the CPU.

``window_model`` follows ``csrc/attic.cu``'s ``window_merge_kernel`` for
each (block, window): the op range [t0, t1) (floored to the unroll,
clamped to [0, cap)), the rounds of at most ``STAGE`` staged ops, each
op's clipped length, the block-wide exclusive scan as the kernel takes it
(4 ops a thread, a scan inside each warp, then over the warps' sums), the
covered bytes from the round's last op that covers the whole window on
(a contiguous share a warp, its lanes on consecutive bytes), each given
the op whose scan entry is the last at or below it and max-ed into
``last[pos]`` (phase 1, cover), then phase 2
(resolve): each position's op, read from the stage when it lies in the
last round and from the ops array otherwise, and its byte.

It is held against the port's plain version
(``attic.window_merge_reference``) and against the JAX kernel
(``kernel_attic.v4_kernel`` in interpret mode, as
``tests/test_torch_attic_ops.py`` runs it) on packed archives, on
``test_torch_cuda.window_plan``'s hand-made plans (overlapping and
out-of-order ops, dlo >= dhi, dhi past 1,024, f3 > 0, negative srow,
v6/v7 ranges floored to the unroll) and garbage, with small stage rounds
so that a window takes several, and on plans whose every op covers the
whole window with more ops than one round of the card's stage. Tolerance:
exact equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_window_schedule.py
"""
import numpy as np
import pytest
import torch

from zxc_tpu_torch.ops import attic as A

from test_torch_cuda import window_plan

WINDOW = 1024
THREADS = 256
WARPS = THREADS // 32
STAGE = 1024            # csrc/attic.cu kMergeStage


def block_scan(lens: np.ndarray, threads: int = THREADS) -> np.ndarray:
    """The kernel's exclusive scan of a round's lengths: thread k sums ops
    4k .. 4k+3, a warp scans its threads' sums, warp 0 scans the warps'
    totals, and each thread writes its ops' first covered bytes."""
    per = np.zeros(4 * threads, np.int64)
    per[:len(lens)] = lens
    s = per.reshape(threads, 4).sum(axis=1)
    warps = s.reshape(-1, 32)
    inc = np.cumsum(warps, axis=1)
    sums = np.cumsum(inc[:, -1])
    before = np.concatenate([[0], sums[:-1]])
    excl = (before[:, None] + inc - warps).reshape(-1)      # per thread
    first = excl[:, None] + np.concatenate(
        [np.zeros((threads, 1), np.int64),
         np.cumsum(per.reshape(threads, 4), axis=1)[:, :3]], axis=1)
    return first.reshape(-1)[:len(lens)], int(sums[-1])


def window_model(wstart, ops, lit8, block: int, mode: int,
                 stage: int = STAGE, stats: dict | None = None):
    """(B, block) uint8 of the kernel's schedule. ``stats`` (optional)
    receives the windows' rounds and covered bytes."""
    wrows, unroll = A.WINDOW_MODES[mode]
    B, RL = ops.shape[0], lit8.shape[1]
    cap = ops.shape[1] * 32
    ops4 = ops.reshape(B, cap, 4).astype(np.int64)
    out = np.zeros((B, block), np.uint8)
    pos = np.arange(WINDOW)
    for b in range(B):
        for wi in range(block // WINDOW):
            t0, t1 = (min(max(int(v) // unroll * unroll, 0), cap)
                      for v in wstart[b, wi:wi + 2])
            last = np.full(WINDOW, -1, np.int64)
            lr, st = t1, ops4[b, :0]
            for c0 in range(t0, t1, stage):            # (1) cover
                n = min(stage, t1 - c0)
                lr, st = c0, ops4[b, c0:c0 + n]
                z = st[:, 2] & 0xFFFFFFFF
                lo = np.minimum(z & 0xFFFF, WINDOW)
                lens = np.maximum(0, np.minimum(z >> 16, WINDOW) - lo)
                first, total = block_scan(lens)
                # the bytes from the last whole-window op on; warp w takes
                # [j0 + w * share, j0 + (w + 1) * share), lane l every 32nd
                # from its l-th; a lane's op is the last whose first
                # covered byte is at or below its byte (a binary search
                # for its first byte, then steps)
                whole = np.flatnonzero(lens == WINDOW)
                j0 = int(first[whole[-1]]) if len(whole) else 0
                share = -(-(total - j0) // WARPS)
                j = np.concatenate([
                    np.arange(j0 + w * share + lane,
                              min(total, j0 + (w + 1) * share), 32)
                    for w in range(WARPS) for lane in range(32)]).astype(
                        np.int64)
                assert np.array_equal(np.sort(j), np.arange(j0, total))
                i = np.searchsorted(first, j, side="right") - 1
                np.maximum.at(last, lo[i] + j - first[i], c0 - t0 + i)
                if stats is not None:
                    stats["rounds"] = stats.get("rounds", 0) + 1
                    stats["covered"] = stats.get("covered", 0) + total
                    stats["taken"] = stats.get("taken", 0) + len(j)
            t = last                                     # (2) resolve
            g = t0 + t
            op = np.zeros((WINDOW, 4), np.int64)
            live = t >= 0
            in_stage = live & (g >= lr)
            op[in_stage] = st[g[in_stage] - lr]
            op[live & ~in_stage] = ops4[b, g[live & ~in_stage]]
            assert np.array_equal(op[live], ops4[b, g[live]])
            r = np.where(op[:, 0] < 0, op[:, 0] + RL, op[:, 0])
            r = np.clip(r, 0, RL - wrows)
            col = (pos + op[:, 1]) & (wrows * 128 - 1)
            lit = lit8[b].reshape(-1)[r * 128 + col].astype(np.int64)
            val = np.where(op[:, 3] > 0, op[:, 3] - 1, lit)
            out[b, wi * WINDOW:(wi + 1) * WINDOW] = np.where(live, val & 255,
                                                             0)
    return out


def cover_plan(seed: int, B: int, block: int, mode: int, per_window: int,
               RL: int = 40):
    """(wstart, ops, lit8) with ``per_window`` ops a window, each covering
    the whole window (dlo 0, dhi 1,024 or past it) but those past the
    first ``STAGE`` of a window, which cover its first half: those
    positions take an op of the window's last stage round, the others one
    of an earlier round. srow, net and f3 drawn as ``window_plan`` draws
    them."""
    rng = np.random.default_rng(seed)
    NW = block // WINDOW
    n = NW * per_window
    op_rows = -(-n * 4 // 128) + 24
    cap = op_rows * 32
    W = 2048 if mode == 4 else 1024
    ops = np.zeros((B, op_rows, 128), np.int32)
    f = ops.reshape(B, cap, 4)
    f[:, :n, 0] = rng.choice([0, 8, RL - 16, -1, -37, RL + 50], (B, n))
    f[:, :n, 1] = rng.choice([0, W - 1, W, -1, 2**30, 517], (B, n))
    dhi = rng.choice([1024, 1025, 65535], (B, n))
    dhi[:, np.arange(n) % per_window >= STAGE] = 512
    f[:, :n, 2] = dhi << 16
    f[:, :n, 3] = np.where(rng.random((B, n)) < 0.3,
                           rng.choice([1, 2, 300], (B, n)), 0)
    wstart = np.minimum(np.arange(NW + 1) * per_window, n)
    wstart = np.broadcast_to(wstart, (B, NW + 1)).astype(np.int32).copy()
    lit8 = rng.integers(0, 256, (B, RL, 128), dtype=np.uint8)
    return wstart, ops, lit8


def plain(args, block, mode):
    return A.window_merge_reference(*(torch.from_numpy(a) for a in args),
                                    block, mode).numpy()


def jax_window(args, block, mode):
    from test_torch_attic_ops import _jax_window
    return _jax_window(args, args[1].shape[1], args[2].shape[1], block, mode)


@pytest.mark.parametrize("mode", [4, 5, 6, 7])
@pytest.mark.parametrize("seed,stage", [(0, STAGE), (1, 16), (2, 7)])
def test_window_model_equals_jax_on_hand_made_plans(seed, stage, mode):
    """Overlapping and out-of-order ops, empty ops, ops past the window,
    fills, negative srow, windows not on the unroll; stage rounds of 16
    and 7 ops, so a window takes several and phase 2 reads ops of earlier
    rounds from the ops array."""
    args = window_plan(seed, 2, 4096, mode)
    stats = {}
    got = window_model(*args, 4096, mode, stage=stage, stats=stats)
    assert np.array_equal(got, plain(args, 4096, mode))
    assert np.array_equal(got, jax_window(args, 4096, mode))
    if stage < STAGE:
        assert stats["rounds"] > 2 * 4      # several rounds a window
    if mode >= 6:
        assert (args[0] % A.WINDOW_MODES[mode][1]).any()


@pytest.mark.parametrize("mode", [4, 5, 6, 7])
@pytest.mark.parametrize("seed", range(2))
def test_window_model_equals_plain_version_on_garbage(seed, mode):
    args = window_plan(seed, 2, 4096, mode, garbage=True)
    assert np.array_equal(window_model(*args, 4096, mode),
                          plain(args, 4096, mode))


@pytest.mark.parametrize("mode", [4, 5, 6, 7])
def test_window_model_equals_jax_on_packed_archive(mode):
    from test_torch_attic_ops import WINDOW_BLOCK, PAD, _plans
    from test_torch_jax_native import jax_native
    jax_native()      # the archive is resolved by the JAX runtime
    _, totals, pieces, lits = _plans("cross", WINDOW_BLOCK)
    args, _ = A.pack_blocks_v4(pieces, lits, totals, WINDOW_BLOCK,
                               split_src=mode >= 5, pad_unroll=PAD[mode])
    stats = {}
    got = window_model(*args, WINDOW_BLOCK, mode, stats=stats)
    assert np.array_equal(got, plain(args, WINDOW_BLOCK, mode))
    assert np.array_equal(got, jax_window(args, WINDOW_BLOCK, mode))
    # a packed plan covers each byte about once
    nw = len(pieces) * WINDOW_BLOCK // WINDOW
    assert stats["covered"] < 2 * WINDOW * nw


@pytest.mark.parametrize("mode", [4, 5, 6, 7])
@pytest.mark.parametrize("per_window", [40, 1300])
def test_window_model_whole_window_ops(mode, per_window):
    """Every op covers the whole window: a round takes only the bytes of
    its last op. 1,300 ops take two rounds of the card's stage, the
    second's ops covering the first half only: the second half's bytes
    come from the first round's last op, read from the ops array."""
    args = cover_plan(per_window, 2, 2048, mode, per_window)
    stats = {}
    got = window_model(*args, 2048, mode, stats=stats)
    assert np.array_equal(got, plain(args, 2048, mode))
    windows = 2 * 2
    assert stats["taken"] < stats["covered"] / 4
    if per_window > STAGE:
        assert stats["rounds"] == 2 * windows
        if mode < 6:       # windows on the unroll: 1,024 + 276 ops
            assert stats["taken"] == windows * (WINDOW + 276 * 512)
    else:
        assert stats["taken"] == windows * WINDOW
        assert np.array_equal(got, jax_window(args, 2048, mode))


def test_block_scan_is_an_exclusive_scan():
    rng = np.random.default_rng(4)
    for n in (1, 5, 256, 1000, 1024):
        lens = rng.integers(0, 1025, n)
        first, total = block_scan(lens)
        assert np.array_equal(first, np.cumsum(lens) - lens)
        assert total == lens.sum()
