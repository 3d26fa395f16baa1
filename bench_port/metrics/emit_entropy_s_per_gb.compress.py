"""emit_entropy_s_per_gb.compress: seconds of compress_device's host
emission on the entropy side (spans emit.literals: the literal section's
auction of RLE and PivCo Huffman; emit.hufflit: the all-literal Huffman
candidate) per plaintext GB of the requests that record them; None where
the program records neither."""
from bench_port.harness.readers import GB, done

KEYS = ("emit.literals", "emit.hufflit")


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
