"""emit_seq_s_per_gb.compress: seconds of compress_device's host emission
on the sequence side (spans emit.cap: sequences at the LCP cap extended;
emit.streams: sequences to literal lengths, tokens, offsets and extras)
per plaintext GB of the requests that record them; None where the
program records neither."""
from bench_port.harness.readers import GB, done

KEYS = ("emit.cap", "emit.streams")


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
