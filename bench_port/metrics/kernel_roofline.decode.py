"""kernel_roofline.decode: the least time of the traced decodes, their
archive bytes read once and their plaintext bytes written once at the
card's memory bandwidth, over the union of the card's kernel intervals,
in percent. The bytes come from the data, whatever implements the decode."""
from bench_port.harness.readers import done, roofline_pct


def read(obs):
    reqs = done(obs)
    return roofline_pct(obs, sum(r.archive_bytes + r.plain_bytes
                                 for r in reqs))
