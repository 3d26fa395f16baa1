"""readback_s_per_gb.compress: seconds compress_device's host waits for
each dispatch group's queued work to end and its sequences to come back,
then cuts them into blocks (span parse.readback), per plaintext GB of the
requests that record it; None where the program does not."""
from bench_port.harness.readers import GB, done

KEYS = ("parse.readback",)


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
