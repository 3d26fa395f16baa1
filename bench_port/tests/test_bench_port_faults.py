"""The comparison fails what it has to fail. The control (the reference
in the program's place, with one guarantee broken) comes out not correct
at a test size, and so does a run whose timed path is broken underneath,
once for each fault a cell of this benchmark can have. A cell on one chip
has no exchange between chips to leave out."""
import pytest

import zxc_tpu_torch
from zxc_tpu_torch import ops

from conftest import PARKED, bench, run_tiny

CELLS = [w["name"] for w in bench()["workloads"]] + PARKED
DECODE_TARGETS = {"silesia-512k.default": (ops, "decompress"),
                  "silesia-64k.hint": (zxc_tpu_torch, "decompress_e2e"),
                  "silesia-512k.cold": (zxc_tpu_torch, "decompress_e2e"),
                  "silesia-64k.compress": (ops, "compress_device")}


def _path(cell, parked_bench):
    return parked_bench if cell in PARKED else None


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, parked_bench):
    res = run_tiny(cell, control=True, bench_path=_path(cell, parked_bench))
    assert not res["correct"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def _altered(out: bytes) -> bytes:
    """One byte changed where the answer is produced."""
    b = bytearray(out)
    b[len(b) // 2] ^= 0x01
    return bytes(b)


def _half(out: bytes) -> bytes:
    """Half of the work left out."""
    return out[:len(out) // 2]


FAULTS = {"altered": _altered, "half": _half,
          "unchanged": None}   # the step hands back its input


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch,
                                         parked_bench):
    """The program's call is broken inside the measured window only: the
    set-up and its warm-up pass stay sound."""
    from bench_port.harness import window
    mod, name = DECODE_TARGETS[cell]
    real, real_run = getattr(mod, name), window.run
    in_window = {"on": False}

    def broken(data, *a, **kw):
        out = real(data, *a, **kw)
        if not in_window["on"]:
            return out
        return data if FAULTS[fault] is None else FAULTS[fault](out)

    def run(*a, **kw):
        in_window["on"] = True
        return real_run(*a, **kw)

    monkeypatch.setattr(mod, name, broken)
    monkeypatch.setattr(window, "run", run)
    res = run_tiny(cell, bench_path=_path(cell, parked_bench))
    assert in_window["on"]
    assert not res["correct"], (fault, res["checks"])


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_reference_decodes_every_block_of_the_first_archive(where,
                                                            monkeypatch):
    """A block fault in a client's first archive that the frozen decoder
    would share with the encoder (here: a frozen decoder that hands back
    the plaintext) is caught by the NumPy reference, wherever the block
    lies, with no seeded sample to find it."""
    from bench_port.harness import corpus, frozen, judge, window
    from bench_port.reference import zxc_numpy as R
    plain = corpus.gen_chunk(1 << 20, (2**31 + 7, 0, 0))
    arc = frozen.compress(plain, 3, 65536, True, 2)
    fr = R.walk_frame(arc)
    k = {"first": 0, "middle": len(fr.blocks) // 2,
         "last": len(fr.blocks) - 1}[where]
    bad = bytearray(arc)
    bad[fr.blocks[k].start + fr.blocks[k].size // 2] ^= 0x01
    item = window.Item(0, "member", plain, arc)
    reqs = [window.Request(0, 0, 0.0, 1.0, len(plain), len(bad),
                           output=bytes(bad)),
            window.Request(0, 0, 1.0, 2.0, len(plain), len(arc),
                           output=arc)]
    monkeypatch.setattr(frozen, "decompress", lambda a, n, t: plain)
    monkeypatch.setattr(judge, "SAMPLE_BLOCKS", 0)   # no seeded share
    numbers, n_ref = judge.judge_compress(
        reqs, [item], {"checksum": True, "block_size": 65536},
        seed=2**31 + 3, threads=2)
    assert numbers == {"bad_frames": 0, "native_wrong_outputs": 0,
                       "ref_wrong_blocks": 1}
    assert n_ref == len(fr.blocks)
