"""run_s_per_gb.e2e: seconds of decompress_e2e's run phase (native prep or
hint replay, H2D, copy-engine launches) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("run",))
