"""emit_s_per_gb.compress: seconds of compress_device's host emission and
framing (emit, frame) per plaintext GB."""
from bench_port.harness.readers import phase_s_per_gb


def read(obs):
    return phase_s_per_gb(obs, ("emit", "frame"))
