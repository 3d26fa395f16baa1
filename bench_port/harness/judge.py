"""The comparison that decides ``correct``.

Every number compared has its limit; a run is correct when it checked
at least one request and every number is within its limit.

* Decode cells: every kept output of the window (all of them, or the
  mix's ``check_share`` drawn from the seed) against the plaintext that
  the benchmark made (``wrong_outputs``, ``wrong_bytes``).
* Compress cells: every archive of the window walked by the NumPy
  reference (headers, block checks, the footer's size, the checksums the
  configuration states: ``bad_frames``); every archive decoded by the
  frozen native decoder with its checksums verified
  (``native_wrong_outputs``); and, decoded by the NumPy reference with
  their checksums (``ref_wrong_blocks``), every block of each client's
  first archive, ``SAMPLE_BLOCKS`` blocks of the others drawn from the
  seed, and the last block of the longest archive.
* Both: requests that raised (``failed``) and clients that never
  returned (``stuck``).
"""
from __future__ import annotations

import numpy as np

from ..reference import zxc_numpy as R
from . import frozen

SAMPLE_BLOCKS = 512


def _wrong_bytes(out, want: bytes) -> int:
    if not isinstance(out, (bytes, bytearray)):
        return len(want)
    a = np.frombuffer(out, np.uint8)
    b = np.frombuffer(want, np.uint8)
    n = min(len(a), len(b))
    return int((a[:n] != b[:n]).sum()) + abs(len(a) - len(b))


def judge_decode(reqs: list, items: list) -> dict:
    wrong = wrong_bytes = 0
    for r in reqs:
        if r.error is not None or not r.kept:
            continue
        want = items[r.item].plain
        if r.output != want:
            wrong += 1
            wrong_bytes += _wrong_bytes(r.output, want)
    return {"wrong_outputs": wrong, "wrong_bytes": wrong_bytes}


def judge_compress(reqs: list, items: list, config: dict, seed: int,
                   threads: int) -> tuple[dict, int]:
    """The numbers compared, and the count of blocks that the NumPy
    reference decoded."""
    bad = native_wrong = 0
    frames = []
    for r in reqs:
        if r.error is not None or not r.kept:
            continue
        want = items[r.item].plain
        arc = r.output
        try:
            fr = R.walk_frame(arc)
            if (fr.plain_size != len(want)
                    or fr.has_checksum != bool(config["checksum"])
                    or fr.block_size != config["block_size"]):
                raise R.FrameError("frame against the configuration")
            frames.append((r, fr))
        except (R.FrameError, TypeError, ValueError):
            bad += 1
            continue
        if frozen.decompress(arc, len(want), threads) != want:
            native_wrong += 1
    sample: set = set()
    if frames:
        first: dict = {}
        for k, (r, _) in enumerate(frames):
            first.setdefault(r.client, k)
        whole = set(first.values())
        sample = {(k, b) for k in whole
                  for b in range(len(frames[k][1].blocks))}
        rest = [(k, b) for k, (_, fr) in enumerate(frames)
                if k not in whole for b in range(len(fr.blocks))]
        if rest:
            rng = np.random.default_rng([seed % (1 << 64), 2])
            sample |= {rest[int(i)] for i in rng.choice(
                len(rest), min(SAMPLE_BLOCKS, len(rest)), replace=False)}
        longest = max(range(len(frames)),
                      key=lambda k: frames[k][0].plain_bytes)
        sample.add((longest, len(frames[longest][1].blocks) - 1))
    ref_wrong = 0
    for k, b in sorted(sample):
        r, fr = frames[k]
        bs = fr.block_size
        want = items[r.item].plain[b * bs:(b + 1) * bs]
        try:
            got = R.decode_block(r.output, fr.blocks[b], bs)
            ok = got.tobytes() == want
        except R.FrameError:
            ok = False
        ref_wrong += not ok
    return ({"bad_frames": bad, "native_wrong_outputs": native_wrong,
             "ref_wrong_blocks": ref_wrong}, len(sample))


def verdict(numbers: dict, checked: int) -> tuple[bool, dict]:
    """Every number against its limit (all 0: the comparison is exact);
    ``checked``: the outputs compared, at least one."""
    checks = {k: {"value": v, "limit": 0} for k, v in numbers.items()}
    ok = checked > 0 and all(c["value"] <= c["limit"]
                               for c in checks.values())
    return ok, checks
