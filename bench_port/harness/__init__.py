"""The benchmark's harness: the yardstick that measures ``zxc_tpu_torch``.

Everything that belongs to one configuration, traffic mix, entry or
per-layer metric lives in a file of its own under ``bench_port/`` and is
found by its name in ``BENCHMARK.json`` (``spec``).
"""
