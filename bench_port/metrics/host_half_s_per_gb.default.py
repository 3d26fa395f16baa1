"""host_half_s_per_gb.default: seconds of ops.decompress's host half
(plan: section parse; resolve: pieces; pad: batches) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("plan", "resolve", "pad"))
