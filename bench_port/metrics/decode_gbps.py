"""decode_gbps: plaintext GB of every decode completed in the window, over
the time from the window's start to the last completion (host clock)."""
from bench_port.harness.readers import rate_gbps as read  # noqa: F401
