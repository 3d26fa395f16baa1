"""opt_parse_s_per_gb.compress: thread seconds of compress_device's host
level-7 parse (spans opt.prepass: the lazy first pass and the literal
prices; opt.dp: every DP pass), summed over the pool's threads, per
plaintext GB of the requests that record both; None where the program
records neither (levels 1-6, or a program without the level-7 DP)."""
from bench_port.harness.readers import GB, done

KEYS = ("opt.prepass", "opt.dp")


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
