"""The benchmark of zxc_tpu_torch: runs one cell of BENCHMARK.json.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with an NVIDIA card. See
bench_port/README.md.
"""
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_port.harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:], T_START))
