"""Entry checks of the port, the counterparts of ``__graft_entry__``'s.

``entry()`` is a compile-and-run check of the flagship expansion: one
padded batch of eight 4 KiB blocks through the batched LZ sequence
expansion (``ops.expand.expand_kernel``), the device form of the
reference's hot decode loop (zxc_decompress.c:890-1034).

    fn, args = entry()          # args on the card ("cpu" for the tests)
    out, total, err = fn(*args)

``dryrun_multichip(n)`` runs one fully sharded decode (dp x sp) and one
dp-sharded encode over ``n`` ranks (``parallel.launch``): NCCL, one card
a rank, by default; gloo ranks with ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from .codec import frame
from .codec.frame import EncodeOpts
from .ops import expand
from .ops.batch import _pad_batch, _pow2, plan_frame
from .ops.device_pipeline import _device
from .parallel import launch

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


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One fully sharded decode step and one sharded encode over
    ``n_devices`` ranks, each checked against the data (AssertionError in
    a rank fails the launch, ``launch.LaunchError``). ``device`` None
    means cuda: NCCL ranks, one card each, and raises when there are
    fewer cards than ranks; ``"cpu"`` runs gloo ranks."""
    dev = _device(device, "dryrun_multichip")
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} ranks need "
                           f"{n_devices} cards, this machine has "
                           f"{torch.cuda.device_count()}")
    launch.launch("zxc_tpu_torch.entry:dryrun_rank", n_devices,
                  args=(dev.type,), device=dev.type, timeout=600)


def dryrun_rank(device: str) -> None:
    """A rank of ``dryrun_multichip``: the JAX dryrun's data (4 KiB
    blocks, seed 7, a 401-byte segment, two blocks a dp row) decoded by
    ``decode_plan_dp_sp`` on a (n/2, 2) mesh, or (n, 1) for odd n, and
    encoded by ``compress_sharded`` on a dp mesh, decoded back by the
    host decoder."""
    import torch.distributed as dist
    from . import parallel

    n = dist.get_world_size()
    shape = (n // 2, 2) if n % 2 == 0 else (n, 1)
    mesh = parallel.make_mesh(device, axes=("dp", "sp"), shape=shape)
    rng = np.random.default_rng(7)
    seg = rng.integers(0, 256, 401, dtype=np.uint8).tobytes()
    n_blocks = 2 * shape[0]
    data = (seg * (BLOCK * n_blocks // len(seg) + 1))[:BLOCK * n_blocks]
    archive = frame.compress(data, EncodeOpts(level=3, block_size=BLOCK))
    out = parallel.decode_plan_dp_sp(plan_frame(archive), mesh)
    assert out == data, "multichip decode mismatch"

    dp_mesh = parallel.make_mesh(device, axes=("dp",))
    arc2 = parallel.compress_sharded(data, dp_mesh, level=3,
                                     block_size=BLOCK)
    assert frame.decompress(arc2) == data, "multichip encode mismatch"
