"""match_parse_s_per_gb.compress: seconds of compress_device's match and
parse phases (LCP and parse-walk kernels, sequences to the host) per
plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("match", "parse"))
