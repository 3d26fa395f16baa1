"""kernel_roofline.compress: the least time of the traced compresses, their
plaintext bytes read once at the card's memory bandwidth, over the union
of the card's kernel intervals, in percent."""
from bench_port.harness.readers import done, roofline_pct


def read(obs):
    return roofline_pct(obs, sum(r.plain_bytes for r in done(obs)))
