"""The schedule of the lane sum (v9-v11 and the lane probes) on the card,
as a numpy model run on the CPU.

``lane_model`` follows ``csrc/attic.cu``'s ``lane_sum_kernel`` for each
(block, tile, sublane), a warp on the card: the batch range [lo, hi) (v9
and v10 from ``ts`` floored to a multiple of 4, v11 from ``layers``,
clamped to the control and for v9 to the rows), chunks of at most 32
batches a batch a lane, each slot's lanes as its mode transforms them
(``first`` and a length: masked modes the clipped [s, e1], nothing for a
v10/v11 row at or past the lit rows, every lane for nomask and floor), the
warp's inclusive scan of the lengths, then one of two loops, as the
kernel picks it from the chunk's covered bytes: cover (48 lanes a slot or
fewer on average), the covered bytes taken ``UNROLL`` at a time a lane,
each finding its slot by the kernel's 5-step search of the scan and adding
its literal byte (plus the mode's added byte) into the row's int32 sums;
or slots, each lane's 4 bytes summed over the chunk's slots with per-byte
adds under a lane mask. The output is the sums' low bytes.

It is held against the port's plain version (``attic.lane_sum_reference``,
every probe included) and against the JAX kernels
(``kernel_attic.v9_kernel``, ``v10_kernel``, ``v11_kernel`` in interpret
mode, as ``tests/test_torch_attic_ops.py`` runs them) on packed archives
and on ``test_torch_cuda.lane_plan``'s hand-made plans (empty slots
``s > e1``, v10/v11 rows at or past the lit rows, negative v9 rows, tile
ranges that are not a multiple of 4, v11 layers not a multiple of 4),
garbage (batches past the control's cap), plans with more than one
chunk of 32 batches a tile and plans whose every slot spans all 128
lanes, with each loop forced and with the kernel's choice. Tolerance:
exact equality.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_lane_schedule.py
"""
import numpy as np
import pytest
import torch

from zxc_tpu_torch.ops import attic as A

from test_torch_cuda import lane_plan

TILE_ROWS = 32
CHUNK = 32               # batches a warp takes at a time, a batch a lane
UNROLL = 4               # csrc/attic.cu kLaneUnroll
SLOT_LANES = 48          # csrc/attic.cu kSlotLanes
PROBES = [None] + sorted(A.LANE_PROBES)


def warp_search(incl: np.ndarray, j: np.ndarray) -> np.ndarray:
    """The kernel's search of a warp's inclusive scan for bytes ``j``:
    five halving steps, each reading the scan at one lane."""
    i = np.zeros(len(j), np.int64)
    for st in (16, 8, 4, 2, 1):
        i += st * (incl[i + st - 1] <= j)
    return i


def decode(c, vrow, mode, rl):
    """(rot, s, e1, row) of each lane's control word (v9's row
    normalised and clamped into the lit rows)."""
    c = c.astype(np.int64) & 0xFFFFFFFF
    if mode == 9:
        row = np.where(vrow < 0, vrow + rl, vrow).clip(0, rl - 1)
        return c & 255, (c >> 8) & 255, (c >> 16) & 255, row
    return c & 127, (c >> 7) & 127, (c >> 14) & 127, c >> 21


def chunk_slots(c, vrow, nc, ph, k, mode, rl, probe):
    """A chunk's slots as the kernel's lanes hold them: (first, len, src,
    rotation, added byte)."""
    rot, s, e1, row = decode(c, vrow, mode, rl)
    lane = np.arange(CHUNK)
    masked = probe not in ("nomask", "floor")
    src = 32 * ((ph + lane) & 3) + k if probe in ("nomatmul",
                                                  "noonehot") else row
    first = s if masked else np.zeros(CHUNK, np.int64)
    last = np.minimum(e1, 127) if masked else np.full(CHUNK, 127)
    n = np.maximum(last - first + 1, 0)
    n[(lane >= nc) | ((probe is None) & (src >= rl))] = 0
    roll = np.zeros_like(rot) if probe in ("norotate",
                                           "norotate_add") else rot
    add = {"nomatmul": row, "norotate_add": rot,
           "floor": c.astype(np.int64)}.get(probe, np.zeros(CHUNK, np.int64))
    return first, n, src, roll, add & 255


def slot_bytes(low, first, ln, src, has, roll, add, nc):
    """The slot loop's adds into a row: each lane's 4 bytes summed over
    the chunk's slots with per-byte adds (mod 256), the lane mask applied
    after the added byte."""
    lane = np.arange(128)
    acc = np.zeros(128, np.int64)
    for i in range(nc):
        mask = (lane >= first[i]) & (lane < first[i] + ln[i])
        v = (low[src[i], (lane + roll[i]) & 127] if has[i]
             else np.zeros(128, np.int64))
        acc = (acc + np.where(mask, (v + add[i]) & 255, 0)) & 255
    return acc


def lane_model(pctrl, lit, block, mode, ts=None, rows=None, layers=0,
               probe=None, unroll=UNROLL, slot_lanes=SLOT_LANES, stats=None):
    """(B, block) uint8 of the kernel's schedule, each chunk by cover or,
    where its slots cover more than ``slot_lanes`` lanes on average, by
    the slot loop. ``stats`` (optional) receives the chunks of each kind
    and the covered bytes."""
    B, G32 = pctrl.shape[:2]
    RL, NT = lit.shape[1], block // 4096
    low = lit.astype(np.int64)
    cap = G32 // TILE_ROWS * 128
    if mode == 9:
        cap = min(cap, rows.shape[1] // TILE_ROWS)
    out = np.zeros((B, NT * TILE_ROWS, 128), np.uint8)
    for b in range(B):
        for t in range(NT):
            if mode == 11:
                b0, n = t * layers, 4 * (layers // 4)
            else:
                b0 = int(ts[b, t])
                n = 4 * ((int(ts[b, t + 1]) - b0) // 4)
            lo = min(max(b0, 0), cap)
            hi = min(max(b0 + n, lo), cap)
            for k in range(TILE_ROWS):
                sums = np.zeros(128, np.int64)
                for c0 in range(lo, hi, CHUNK):
                    nc = min(CHUNK, hi - c0)
                    bat = np.minimum(c0 + np.arange(CHUNK), hi - 1)
                    c = pctrl[b, TILE_ROWS * (bat >> 7) + k, bat & 127]
                    if probe == "nobcast":
                        c = np.full(CHUNK, A.BCAST_WORD, np.int32)
                    vrow = (rows[b, TILE_ROWS * bat + k].astype(np.int64)
                            if mode == 9 else None)
                    first, ln, src, roll, add = chunk_slots(
                        c, vrow, nc, (c0 - b0) & 3, k, mode, RL, probe)
                    incl = np.cumsum(ln)
                    total = int(incl[-1])
                    has = (probe != "floor") & (src < RL)
                    kind = "slots" if total > slot_lanes * nc else "cover"
                    if kind == "slots":
                        sums += slot_bytes(low[b], first, ln, src, has,
                                           roll, add, nc)
                    else:
                        # the order the lanes take the bytes: kLaneUnroll
                        # rounds of 32 a step
                        j = (np.arange(0, total, 32 * unroll)[:, None]
                             + np.arange(32 * unroll)[None, :])
                        j = j[j < total]
                        i = warp_search(incl, j)
                        lanes = j + first[i] - (incl[i] - ln[i])
                        assert ((lanes >= 0) & (lanes < 128)).all()
                        r = np.where(has[i], src[i], 0)
                        v = np.where(has[i],
                                     low[b, r, (lanes + roll[i]) & 127], 0)
                        np.add.at(sums, lanes, v + add[i])
                    if stats is not None:
                        stats["chunks"] = stats.get("chunks", 0) + 1
                        stats[kind] = stats.get(kind, 0) + 1
                        stats["covered"] = stats.get("covered", 0) + total
                out[b, t * TILE_ROWS + k] = sums & 255
    return out.reshape(B, block)


def plain(plan, block, mode, probe=None):
    ts, rows, pctrl, lit, layers = plan
    return A.lane_sum_reference(
        torch.from_numpy(pctrl), torch.from_numpy(lit), block, mode,
        ts=None if ts is None else torch.from_numpy(ts),
        rows=None if rows is None else torch.from_numpy(rows),
        layers=layers, probe=probe).numpy()


def jax_lane(plan, block, mode):
    from test_torch_attic_ops import _jax_lane
    ts, rows, pctrl, lit, layers = plan
    return _jax_lane(ts, rows, pctrl, lit, layers, block, mode)


def model(plan, block, mode, **kw):
    ts, rows, pctrl, lit, layers = plan
    return lane_model(pctrl, lit, block, mode, ts=ts, rows=rows,
                      layers=layers, **kw)


def long_plan(seed: int, B: int, block: int, mode: int, per_tile: int):
    """A ``lane_plan`` whose tiles each hold ``per_tile`` batches (v11:
    ``layers``), more than one chunk of 32 (ts ranges off a multiple of 4
    where ``per_tile`` is)."""
    ts, rows, _, lit, _ = lane_plan(seed, B, block, mode)
    rng = np.random.default_rng(seed + 100)
    NT = block // 4096
    NB = NT * per_tile
    MAXB = -(-NB // 8) * 8
    G32 = 32 * -(-MAXB // 128)
    shape = (B, G32, 128)
    rl = rng.integers(0, 256 if mode == 9 else 128, shape)
    s = rng.integers(0, 128, shape)
    e1 = np.clip(s + rng.integers(-3, 12, shape), 0, 127)
    RL = lit.shape[1]
    if mode == 9:
        w = rl | (s << 8) | (e1 << 16)
        rows = rng.integers(-RL - 10, RL + 10, (B, MAXB * 32)).astype(
            np.int32)
    else:
        w = rl | (s << 7) | (e1 << 14) | (rng.integers(0, RL + 8, shape)
                                          << 21)
    if mode != 11:
        ts = np.broadcast_to(np.arange(NT + 1) * per_tile,
                             (B, NT + 1)).astype(np.int32).copy()
    return (ts, rows, w.astype(np.uint32).view(np.int32), lit,
            per_tile if mode == 11 else 0)


@pytest.mark.parametrize("mode", [9, 10, 11])
@pytest.mark.parametrize("seed", range(3))
def test_lane_model_equals_jax_on_hand_made_plans(seed, mode):
    """Empty slots, lane overlaps whose sums pass 255, v9 rows negative or
    past the lit rows, v10/v11 rows at or past them, tile ranges off a
    multiple of 4, v11's 6 layers (floored to 4)."""
    block = 8192 if seed else 4096
    plan = lane_plan(seed, 2, block, mode)
    got = model(plan, block, mode)
    assert np.array_equal(got, plain(plan, block, mode))
    assert np.array_equal(got, jax_lane(plan, block, mode))
    _, _, pctrl, _, layers = plan
    c = pctrl.astype(np.int64)
    sh = 8 if mode == 9 else 7
    assert ((c >> sh & 127) > (c >> 2 * sh & 127)).any()    # s > e1
    if mode == 11:
        assert layers % 4


@pytest.mark.parametrize("mode", [9, 10, 11])
@pytest.mark.parametrize("seed", range(2))
def test_lane_model_equals_plain_version_on_garbage(seed, mode):
    """Any control word, ts and v9 rows; v11 layers up to 300, tiles past
    the control's cap."""
    plan = lane_plan(seed, 2, 8192, mode, garbage=True)
    assert np.array_equal(model(plan, 8192, mode), plain(plan, 8192, mode))


@pytest.mark.parametrize("mode", [9, 10, 11])
@pytest.mark.parametrize("per_tile", [33, 70])
def test_lane_model_over_several_chunks(mode, per_tile):
    """Tiles of 33 and 70 batches (v11 layers): two and three chunks a
    warp, against the plain version and the JAX kernel."""
    plan = long_plan(per_tile, 2, 8192, mode, per_tile)
    stats = {}
    got = model(plan, 8192, mode, stats=stats)
    assert stats["chunks"] == 2 * 2 * 32 * -(-(per_tile // 4 * 4) // CHUNK)
    assert np.array_equal(got, plain(plan, 8192, mode))
    assert np.array_equal(got, jax_lane(plan, 8192, mode))


@pytest.mark.parametrize("probe", PROBES)
@pytest.mark.parametrize("garbage", [False, True])
def test_lane_model_runs_every_probe(probe, garbage):
    """The probes as transforms of a slot, through the same loop: each
    against the plain version's ``probe=`` on v10-packed plans with 256
    lit rows (nomatmul reads rows 0-127)."""
    plan = lane_plan(3, 2, 8192, 10, garbage, RL=256)
    assert np.array_equal(model(plan, 8192, 10, probe=probe),
                          plain(plan, 8192, 10, probe))


@pytest.mark.parametrize("mode,probe", [
    (9, None), (10, None), (10, "nomask"), (10, "floor"), (10, "nomatmul")])
def test_lane_model_slot_loop_equals_cover(mode, probe):
    """Each loop forced on every chunk (``slot_lanes`` -1: slots; 2**20:
    cover) gives the same bytes as the plain version, and the kernel's
    choice takes slots where every slot spans all 128 lanes (nomask and
    floor on any plan)."""
    plan = lane_plan(5, 2, 8192, mode, RL=256)
    want = plain(plan, 8192, mode, probe)
    for forced in (-1, 1 << 20):
        assert np.array_equal(model(plan, 8192, mode, probe=probe,
                                    slot_lanes=forced), want)
    ts, rows, pctrl, lit, layers = plan
    sh = 8 if mode == 9 else 7
    c = pctrl.astype(np.int64) & 0xFFFFFFFF
    every = (c & ~(0x7FFF << sh)) | (127 << 2 * sh)     # s 0, e1 127
    full = (ts, rows, every.astype(np.uint32).view(np.int32), lit, layers)
    stats = {}
    assert np.array_equal(model(full, 8192, mode, probe=probe, stats=stats),
                          plain(full, 8192, mode, probe))
    assert stats["slots"] == stats["chunks"]
    if probe in ("nomask", "floor"):
        stats = {}
        model(plan, 8192, mode, probe=probe, stats=stats)
        assert stats["slots"] == stats["chunks"]


@pytest.mark.parametrize("unroll", [1, 8])
def test_lane_model_order_does_not_matter(unroll):
    """The bytes a lane takes at once (1, 4 or 8) change only the order
    of the atomic adds."""
    plan = lane_plan(4, 2, 8192, 10)
    assert np.array_equal(model(plan, 8192, 10, unroll=unroll),
                          model(plan, 8192, 10))


@pytest.mark.parametrize("mode", [9, 10, 11])
def test_lane_model_equals_jax_on_packed_archive(mode):
    from test_torch_attic_ops import LANE_BLOCK, _plans
    from test_torch_jax_native import jax_native
    jax_native()      # the archive is resolved by the JAX runtime
    _, totals, pieces, lits = _plans("cross", LANE_BLOCK)
    if mode == 9:
        _, ts, rows, pctrl, lit = A.pack_blocks_v9(pieces, lits, totals,
                                                   LANE_BLOCK)
        plan = (ts, rows, pctrl, lit, 0)
    elif mode == 10:
        _, ts, pctrl, lit = A.pack_blocks_v10(pieces, lits, totals,
                                              LANE_BLOCK)
        plan = (ts, None, pctrl, lit, 0)
    else:
        from zxc_tpu_torch.ops import serial
        layers = A.v11_layers(serial.lane_ops_blocks(pieces, totals))
        pctrl, lit = A.pack_blocks_v11(pieces, lits, totals, LANE_BLOCK,
                                       LAYERS=layers)
        plan = (None, None, pctrl, lit, layers)
    stats = {}
    got = model(plan, LANE_BLOCK, mode, stats=stats)
    assert np.array_equal(got, plain(plan, LANE_BLOCK, mode))
    assert np.array_equal(got, jax_lane(plan, LANE_BLOCK, mode))
    # a packed plan covers each byte about once, every chunk by cover
    assert stats["covered"] <= 2 * LANE_BLOCK * len(pctrl)
    assert stats["cover"] == stats["chunks"]


def test_warp_search_finds_each_bytes_slot():
    rng = np.random.default_rng(5)
    for _ in range(50):
        ln = rng.integers(0, 6, CHUNK) * (rng.random(CHUNK) < 0.7)
        incl = np.cumsum(ln)
        j = np.arange(incl[-1])
        assert np.array_equal(warp_search(incl, j),
                              np.searchsorted(incl, j, side="right"))
