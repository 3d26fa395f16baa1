"""Entry: ``zxc_tpu_torch.decompress_e2e(archive, opts, hint=...)``, the
copy-engine path: frame walk and checksums, shape sizing, native prep on
threads (v26) or the ``.zxh`` hint's literal replay (v27), H2D, the
copy-engine kernel, readback and assembly. Phases: walk_size, run,
collect, total.

Traffic ``"hint": true`` writes one ``.zxh`` per archive in set-up with
the port's ``write_hints`` (under the run's temporary directory) and
loads each as a ``HintFile``: the decode server's state.

The control in the program's place is the NumPy reference decoding with
overlapping matches copied as one move (``overlap=False``)."""
from __future__ import annotations

import os

KIND = "decode"


def prepare(ctx):
    from zxc_tpu_torch import DecodeOpts, HintFile, write_hints
    opts = DecodeOpts(checksum=bool(ctx.config["checksum"]))
    hints = None
    if ctx.traffic.get("hint"):
        hints = []
        for it in ctx.items:
            path = os.path.join(ctx.tmpdir, f"{it.index}.zxh")
            write_hints(it.archive, path, opts)
            hints.append(HintFile(path, it.archive))
    return {"opts": opts, "device": ctx.device, "hints": hints}


def call(state, item, phases):
    from zxc_tpu_torch import decompress_e2e
    hint = None if state["hints"] is None else state["hints"][item.index]
    return decompress_e2e(item.archive, state["opts"], device=state["device"],
                          hint=hint, _phases=phases)


def control(state, item, phases):
    from bench_port.reference import zxc_numpy
    return zxc_numpy.decode_frame(item.archive, overlap=False)


def close(state):
    for h in state.get("hints") or []:
        h.release_device()
    state.clear()
