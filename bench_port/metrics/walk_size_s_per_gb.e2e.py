"""walk_size_s_per_gb.e2e: seconds of decompress_e2e's walk_size phase
(hint load, frame walk, checksums, shape sizing) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("walk_size",))
