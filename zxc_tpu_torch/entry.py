"""A compile-and-run check of the port's flagship expansion, the
counterpart of ``__graft_entry__.entry``: one padded batch of eight 4 KiB
blocks through the batched LZ sequence expansion
(``ops.expand.expand_kernel``), the device form of the reference's hot
decode loop (zxc_decompress.c:890-1034).

    fn, args = entry()          # args on the card ("cpu" for the tests)
    out, total, err = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from .codec import frame
from .codec.frame import EncodeOpts
from .ops import expand
from .ops.batch import _pad_batch, _pow2, plan_frame
from .ops.device_pipeline import _device

BLOCK = 4096


def example_plan(block_size: int, n_blocks: int, seed: int = 0):
    """A deterministic mini-frame (a random 611-byte segment repeated, then
    ``abc`` runs), encoded at level 3 by the native encoder and planned:
    (plan, the padded batch's host arrays ``ll, ml, off, lit, n_seq,
    lit_len``)."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 256, 611, dtype=np.uint8).tobytes()
    data = (seg * ((block_size * n_blocks) // len(seg) // 2)
            + b"abc" * (block_size * n_blocks // 6))[:block_size * n_blocks]
    archive = frame.compress(data, EncodeOpts(level=3, block_size=block_size))
    plan = plan_frame(archive)
    S = _pow2(plan.max_seq)
    L = _pow2(plan.max_lit)
    return plan, _pad_batch(plan, range(plan.n_blocks), S, L)


def entry(device=None):
    """(fn, args): ``fn`` is the expansion of 4 KiB blocks, ``args`` the
    example batch of eight blocks as tensors on ``device`` (None means
    cuda and raises without it; "cpu" runs the plain tensor ops)."""
    dev = _device(device, "entry")
    _, host = example_plan(BLOCK, 8)
    return (expand.expand_kernel(BLOCK, False),
            tuple(torch.from_numpy(a).to(dev) for a in host))
