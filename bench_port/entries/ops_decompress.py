"""Entry: ``zxc_tpu_torch.ops.decompress(archive, opts)``, the default
route (section parse, piece resolver, padded batches, the expansion's
tensor ops on the card, readback). Phases: plan, resolve, pad, device,
total.

The control in the program's place is the NumPy reference decoding with
overlapping matches copied as one move (``overlap=False``)."""
from __future__ import annotations

KIND = "decode"


def prepare(ctx):
    from zxc_tpu_torch import DecodeOpts
    return {"opts": DecodeOpts(checksum=bool(ctx.config["checksum"])),
            "device": ctx.device}


def call(state, item, phases):
    from zxc_tpu_torch import ops
    return ops.decompress(item.archive, state["opts"],
                          device=state["device"], _phases=phases)


def control(state, item, phases):
    from bench_port.reference import zxc_numpy
    return zxc_numpy.decode_frame(item.archive, overlap=False)


def close(state):
    state.clear()
