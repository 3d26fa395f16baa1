"""device_idle.compress: percent of the profiled span in which the card runs
no kernel, copy or memset (torch.profiler)."""
from bench_port.harness.readers import idle_pct as read  # noqa: F401
