"""issue_s_per_gb.compress: host seconds compress_device spends issuing
its device work (spans match and parse.issue: the copy to the card, which
waits for the card's stream, hashes, sort and candidates, the LCP launch,
the steps, the parse-walk launch and the compaction gathers) per plaintext
GB of the requests that record both; None where the program does not."""
from bench_port.harness.readers import GB, done

KEYS = ("match", "parse.issue")


def read(obs):
    reqs = [r for r in done(obs) if all(k in r.phases for k in KEYS)]
    plain = sum(r.plain_bytes for r in reqs)
    if not plain:
        return None
    return sum(r.phases[k] for r in reqs for k in KEYS) / (plain / GB)
