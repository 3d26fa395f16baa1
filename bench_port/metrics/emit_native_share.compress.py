"""emit_native_share.compress: the plaintext bytes of the blocks that
compress_device's native block emitter wrote (counter emit.native_bytes)
over the plaintext bytes of the requests that count them, in percent;
None where the program counts none."""
from bench_port.harness.readers import done


def read(obs):
    reqs = [r for r in done(obs) if "emit.native_bytes" in r.phases]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return 100.0 * sum(r.phases["emit.native_bytes"] for r in reqs) / plain
