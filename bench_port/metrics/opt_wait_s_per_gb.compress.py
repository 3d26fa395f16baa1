"""opt_wait_s_per_gb.compress: seconds compress_device's calling thread
waits for its pool of host threads to finish level-7 blocks (span
opt.wait: the host parse and emission not hidden behind the next group's
match on the card), per plaintext GB of the requests that record it;
None where the program does not."""
from bench_port.harness.readers import GB, done

KEYS = ("opt.wait",)


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
