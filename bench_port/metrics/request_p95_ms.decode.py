"""request_p95_ms.decode: the 95th percentile of the host-clock latency of
every request of the traced window (service layer: the clients)."""
from bench_port.harness.readers import percentile_ms


def read(obs):
    return percentile_ms(obs, 95.0)
