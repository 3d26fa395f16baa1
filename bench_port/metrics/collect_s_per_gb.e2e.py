"""collect_s_per_gb.e2e: seconds of decompress_e2e's collect phase
(device sync, readback, assembly) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("collect",))
