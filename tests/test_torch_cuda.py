"""Card tests of the PyTorch port: each CUDA kernel against its plain
PyTorch version on the card, on valid and on garbage control, and the
end-to-end decode through the kernels. They need an NVIDIA card with
nvcc, are marked ``cuda`` and skip without one. On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest pins JAX, which the card's
machine does not have; this file imports no JAX.) Tolerance: exact byte
equality.
"""
import numpy as np
import pytest
import torch

import zxc_tpu_torch as Z
from zxc_tpu_torch.ops import copy_engine as CE

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_group(seed: int, B: int, NST: int, MAXQ: int, RLP: int, K: int,
                 self_ref: bool, lit_max: int = 256, garbage: bool = False):
    """One dispatch group of random control made with numpy. Valid control
    keeps quads in range, 16-aligned windows inside the window rows and
    target rows < 128; ``garbage`` breaks all of that."""
    rng = np.random.default_rng(seed)
    NR = NST * 128
    NG32 = 32 * -(-4 * MAXQ // 128)
    win_rows = RLP + NR if self_ref else RLP
    shape = (B, K * NG32, 128)
    if garbage:
        qs = rng.integers(-4, MAXQ + 5, (B, NST + 1)).astype(np.int32)
        qbase = rng.integers(-64, win_rows + 64, (B, MAXQ)).astype(np.int32)
        rowrel = rng.integers(0, 2048, shape)
        tq = rng.integers(0, 256, (B, MAXQ, 128)).astype(np.uint8)
    else:
        qs = np.zeros((B, NST + 1), np.int32)
        for b in range(B):
            # odd per-supertile quad counts included: the trailing quad of
            # an odd count is skipped
            counts = rng.integers(0, MAXQ // NST + 1, NST)
            qs[b, 1:] = np.minimum(np.cumsum(counts), MAXQ)
        qbase = (rng.integers(0, (win_rows - 128) // 16 + 1, (B, MAXQ)) * 16
                 ).astype(np.int32)
        rowrel = rng.integers(0, 128, shape)
        rowrel[:, NG32:] = 0
        tq = rng.integers(0, 128, (B, MAXQ, 128)).astype(np.uint8)
    roll = rng.integers(0, 128, shape)
    s = rng.integers(0, 128, shape)
    e = np.minimum(s + rng.integers(0, 70, shape), 127)
    w = (roll | (s << 7) | (e << 14) | (rowrel << 21)).astype(np.uint32)
    w[rng.random(shape) < 0.2] = 1 << 7             # the packer's filler
    lit8 = rng.integers(0, lit_max, (B, RLP, 128)).astype(np.uint8)
    return qs, qbase, w.view(np.int32), tq, lit8


@pytest.mark.parametrize("garbage", [False, True])
@pytest.mark.parametrize("variant", [19, 26])
def test_kernel_equals_plain_version_on_card(card, variant, garbage):
    for seed, (B, NST, MAXQ, RLP) in enumerate(((3, 2, 24, 256),
                                                (16, 4, 96, 640))):
        args = CE.group_from_numpy(*random_group(
            seed, B, NST, MAXQ, RLP, 2, variant == 26, garbage=garbage),
            device=card)
        before = CE.KERNELS[variant].launches
        out = CE.KERNELS[variant](*args)
        torch.cuda.synchronize()
        assert CE.KERNELS[variant].launches == before + 1
        assert torch.equal(out, CE.REFERENCES[variant](*args))


@pytest.mark.parametrize("variant", [19, 26])
def test_e2e_on_card(card, variant):
    rng = np.random.default_rng(variant)
    data = (b"card test " * 9000
            + rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()) * 3
    arc = Z.compress(data, Z.EncodeOpts(level=3, block_size=16384))
    kern = CE.KERNELS[variant]
    before = kern.launches
    assert Z.decompress_e2e(arc, dispatch=4, variant=variant) == data
    assert kern.launches - before == -(-(-(-len(data) // 16384)) // 4)
    assert Z.decompress_e2e(arc, device=card, dispatch=4, variant=variant,
                            _collect="fingerprint") == \
        Z.decompress_e2e(arc, device="cpu", dispatch=4, variant=variant,
                         _collect="fingerprint")
