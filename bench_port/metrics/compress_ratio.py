"""compress_ratio: archive bytes over plaintext bytes, summed over the
window's completed compress requests."""
from bench_port.harness.readers import ratio as read  # noqa: F401
