"""The schedule of the port's v26/v27 kernel, held on the CPU.

The card kernel runs one CTA per (supertile, block): pass 1 adds every
slot whose source row is a lit row (below RLP) at once; pass 2, after the
block's earlier supertiles are stored, adds the slots whose source row is
RLP + r, reading output row r only below t*128 (0 at t*128 and past). A
numpy model of that order (pass 1 over all supertiles, then pass 2 in
supertile order) must equal the JAX kernels v26/v27 in interpret mode and
the port's plain versions ``v26_reference`` / ``v27_reference``, which
walk the supertiles in order. Plans: ``test_torch_cuda.plan_group``
(collision-free, so the JAX kernel's bf16 window is exact: the longest
dependency chain, reads on both sides of the stored-row boundary, and
mixed windows with out-of-range rows and targets) and random garbage
control (``random_group(garbage=True)``; the JAX kernels clamp such
windows, so only the plain versions judge it). Tolerance: exact bytes.
"""
import numpy as np
import pytest

from zxc_tpu.ops import pallas_decode as PD

from zxc_tpu_torch.ops import copy_engine as CE

from test_torch_cuda import flat_group, plan_group, random_group


def _slots(qs, qbase, pctrl, tq, K: int, b: int, t: int):
    """The slots supertile t of block b runs that can add (window row,
    target row, per-lane source bytes, per-lane cover): quads of the
    pair-floored range clipped to [0, MAXQ), rowrel < 128, target < 128."""
    MAXQ, G32 = qbase.shape[1], pctrl.shape[1] // K
    lanes = np.arange(128)
    q0 = int(qs[b, t])
    for q in range(q0, q0 + 2 * max(0, (int(qs[b, t + 1]) - q0) >> 1)):
        if not 0 <= q < MAXQ:
            continue
        for i in range(128):
            bat = 4 * q + (i >> 5)
            w = [int(pctrl[b, j * G32 + 32 * (bat >> 7) + (i & 31),
                           bat & 127]) & 0xFFFFFFFF for j in range(K)]
            tgt = int(tq[b, q, i])
            if w[0] >> 21 >= 128 or not 0 <= tgt < 128:
                continue
            roll = np.full(128, -1)
            for x in w:                       # the highest plane wins
                cov = (((x >> 7) & 127) <= lanes) & (lanes <= ((x >> 14)
                                                               & 127))
                roll[cov] = x & 127
            cov = roll >= 0
            if cov.any():
                yield (int(qbase[b, q]) + (w[0] >> 21), tgt,
                       (lanes + roll) & 127, cov)


def two_pass_model(qs, qbase, pctrl, tq, win, K: int) -> np.ndarray:
    """The kernel's order: pass 1 (window rows < RLP: ``win``, the
    block's (RLP, 128) lit window) over every supertile first, then pass 2
    (window rows RLP + r: output row r if r < t*128, else nothing) and the
    store, supertile by supertile. Returns (B, NST*128, 128) uint8."""
    B, NST = qs.shape[0], qs.shape[1] - 1
    RLP = win.shape[1]
    acc = np.zeros((B, NST, 128, 128), np.int64)
    out = np.zeros((B, NST * 128, 128), np.uint8)
    slots = {(b, t): list(_slots(qs, qbase, pctrl, tq, K, b, t))
             for b in range(B) for t in range(NST)}
    for (b, t), ss in slots.items():                       # pass 1
        for src, tgt, idx, cov in ss:
            if 0 <= src < RLP:
                acc[b, t, tgt, cov] += win[b, src, idx[cov]]
    for t in range(NST):                                    # pass 2
        for b in range(B):
            for src, tgt, idx, cov in slots[(b, t)]:
                if RLP <= src < RLP + t * 128:
                    acc[b, t, tgt, cov] += out[b, src - RLP, idx[cov]]
        out[:, t * 128:(t + 1) * 128] = acc[:, t] & 255
    return out


def flat_windows_np(loff, flat, RLP: int) -> np.ndarray:
    """v27's per-block windows from the flat buffer: row r of block b is
    flat[loff[b] + r], 0 where that lies outside it or loff[b] < 0."""
    win = np.zeros((len(loff), RLP, 128), np.uint8)
    for b, off in enumerate(int(x) for x in loff):
        if off < 0:
            continue
        rows = off + np.arange(RLP)
        ok = (rows >= 0) & (rows < len(flat))
        win[b, ok] = flat[rows[ok]]
    return win


def _check_v26(group, K: int, jax: bool) -> np.ndarray:
    qs, qbase, pctrl, tq, lit8 = group
    model = two_pass_model(qs, qbase, pctrl, tq, lit8, K)
    port = CE.v26_reference(*CE.group_from_numpy(*group), K=K).numpy()
    assert np.array_equal(model, port)
    if jax:
        NST, MAXQ, RLP = qs.shape[1] - 1, qbase.shape[1], lit8.shape[1]
        jout = np.asarray(PD.v26_kernel(NST * 16384, MAXQ, RLP, K, True)(
            *group))
        assert jout.max() <= 255          # the bf16 window held exact sums
        assert np.array_equal(model, jout.astype(np.uint8))
    return model


def _check_v27(group, K: int, jax: bool, garbage: bool = False):
    (qs, qbase, loff, pctrl, tq, flat), RLP = flat_group(3, group, garbage)
    model = two_pass_model(qs, qbase, pctrl, tq,
                           flat_windows_np(loff, flat, RLP), K)
    args = CE.group_from_numpy(qs, qbase, loff, pctrl, tq, flat)
    assert np.array_equal(model, CE.v27_reference(*args, RLP=RLP,
                                                  K=K).numpy())
    if jax:
        NST, MAXQ = qs.shape[1] - 1, qbase.shape[1]
        jout = np.asarray(PD.v27_kernel(NST * 16384, MAXQ, RLP, len(flat),
                                        K, True)(qs, qbase, loff, pctrl, tq,
                                                 flat))
        assert jout.max() <= 255
        assert np.array_equal(model, jout.astype(np.uint8))
    return model


@pytest.mark.parametrize("NST", [4, 8])
@pytest.mark.parametrize("kind", ["chain", "boundary", "mixed"])
@pytest.mark.parametrize("variant", [26, 27])
def test_two_pass_model_equals_jax_and_plain(variant, kind, NST):
    group = plan_group(NST + len(kind), 2, NST, 256, 2, kind)
    out = (_check_v26 if variant == 26 else _check_v27)(group, 2, True)
    assert out[:, 128:].any()      # later supertiles hold bytes


@pytest.mark.parametrize("NST", [4, 8])
@pytest.mark.parametrize("variant", [26, 27])
def test_two_pass_model_equals_plain_on_garbage(variant, NST):
    group = random_group(50 + NST, 2, NST, 16, 256, 2, True, garbage=True)
    if variant == 26:
        out = _check_v26(group, 2, False)
    else:
        out = _check_v27(group, 2, False, garbage=True)
    assert out.any()


def test_chain_plan_reads_the_previous_supertile():
    """Every live quad of supertile t >= 1 reads window rows RLP +
    (t-1)*128 .. RLP + t*128 - 1, so pass 1 adds nothing there and every
    byte of those supertiles comes through pass 2."""
    qs, qbase = (group := plan_group(1, 2, 4, 256, 2, "chain"))[:2]
    for b in range(2):
        for t in range(1, 4):
            for q in range(qs[b, t], qs[b, t + 1]):
                assert qbase[b, q] == 256 + (t - 1) * 128
    out = _check_v26(group, 2, True)
    assert all(out[:, t * 128:(t + 1) * 128].any() for t in range(4))


def test_boundary_plan_reads_zero_at_t128():
    """Slot row 64 of the boundary quad is output row t*128: the model
    (and both references) read 0 there although the full output holds
    bytes at that row; slot row 63 reads the stored row t*128 - 1."""
    qs, qbase, pctrl, tq, lit8 = group = plan_group(
        2, 2, 4, 256, 2, "boundary")
    out = _check_v26(group, 2, True)
    # the same plan read against the finished output (a stale buffer)
    # would differ: row t*128 of supertile t is nonzero somewhere
    assert out[:, 128::128].any()
    stale = np.concatenate([lit8, out], axis=1)
    wrong = np.zeros_like(out)
    for b in range(2):
        for t in range(4):
            tile = np.zeros((128, 128), np.int64)
            for src, tgt, idx, cov in _slots(qs, qbase, pctrl, tq, 2, b, t):
                if 0 <= src < stale.shape[1]:
                    tile[tgt, cov] += stale[b, src, idx[cov]]
            wrong[b, t * 128:(t + 1) * 128] = tile & 255
    assert not np.array_equal(wrong, out)


def test_k3_plans_equal_jax_and_plain():
    group = plan_group(5, 2, 4, 256, 3, "mixed")
    _check_v26(group, 3, True)
    _check_v27(group, 3, True)
