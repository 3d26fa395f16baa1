"""d2h_bytes_per_byte.compress: bytes compress_device copies from the
device to the host (counter d2h_bytes: every tensor its readback copies,
the sequences' buffers at their full capacity and the counts) over the
plaintext bytes of the requests that count them; None where the program
counts none."""
from bench_port.harness.readers import done


def read(obs):
    reqs = [r for r in done(obs) if "d2h_bytes" in r.phases]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases["d2h_bytes"] for r in reqs) / plain
