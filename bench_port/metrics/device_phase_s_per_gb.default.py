"""device_phase_s_per_gb.default: seconds of ops.decompress's device phase
(H2D, the expansion's tensor ops, readback) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("device",))
