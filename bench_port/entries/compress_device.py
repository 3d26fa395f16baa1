"""Entry: ``zxc_tpu_torch.ops.compress_device(plain, level, block_size,
checksum)`` with the configuration's level, block size and checksums:
hash sort and candidates, the LCP and parse-walk kernels on the card,
sequences to the host, host emission. Phases: frame, match, parse, emit
(the program synchronises the card at each boundary when it is handed
the phases, so only traced runs pass them).

The control in the program's place is the same call with checksums off,
which breaks the configuration's guarantee that every block carries its
checksum."""
from __future__ import annotations

KIND = "compress"


def prepare(ctx):
    c = ctx.config
    return {"level": int(c["level"]), "block_size": int(c["block_size"]),
            "checksum": bool(c["checksum"]), "device": ctx.device}


def warmup_items(state, items):
    """Items with every shape of the cell's calls and a fraction of its
    bytes: of each file, one full dispatch group of blocks and its own
    tail (its last partial group and partial block)."""
    from zxc_tpu_torch.ops import encode
    # the program's group of blocks a dispatch; an AttributeError here,
    # not a guess, if it is renamed, so that no shape goes unwarmed
    group = encode.DISPATCH * state["block_size"]
    out = []
    for it in items:
        n = len(it.plain)
        cut = it.plain if n <= 2 * group else (it.plain[:group]
                                               + it.plain[n - n % group:])
        out.append(type(it)(it.index, it.name, cut, b""))
    return out


def call(state, item, phases):
    from zxc_tpu_torch import ops
    return ops.compress_device(item.plain, state["level"],
                               state["block_size"], state["device"],
                               state["checksum"], _phases=phases)


def control(state, item, phases):
    from zxc_tpu_torch import ops
    return ops.compress_device(item.plain, state["level"],
                               state["block_size"], state["device"], False)


def close(state):
    state.clear()
