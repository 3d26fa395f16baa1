"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``zxc_tpu_torch`` begins with ``zxc_tpu``
and is the program, not the JAX package); the reference loads nothing of
the program."""
import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "zxc_tpu")


def _top_modules(code: str) -> set:
    r = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "HOME": "/tmp"})
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_whole_name_comparison():
    from bench_port.harness import cli
    sys.modules.setdefault("zxc_tpu_torch_fake_probe", sys)
    try:
        names = {m.split(".")[0] for m in sys.modules}
        assert "zxc_tpu_torch_fake_probe" in names
        assert "zxc_tpu_torch_fake_probe" not in cli.forbidden_modules()
    finally:
        del sys.modules["zxc_tpu_torch_fake_probe"]


def test_harness_cell_and_reference_load_no_jax():
    code = """
import os, sys, time
sys.path.insert(0, os.getcwd())
from bench_port.harness import cli, spec, judge, trace, window, readers
from bench_port.reference import zxc_numpy
cli.fix_cache_dirs(os.getcwd())
import json
for w in json.load(open('BENCHMARK.json'))['workloads']:
    c = spec.load_cell('BENCHMARK.json', w['name'])
    sizes = {k: v // 400 for k, v in c.config['members'].items()}
    for trace in (False, True):
        res = cli.run_cell(w['name'], 2**31 + 3, 0.3, trace,
                           t_start=time.perf_counter(), device='cpu',
                           sizes=sizes)
        assert res['correct'], res
assert cli.forbidden_modules() == []
"""
    mods = _top_modules(code)
    assert "zxc_tpu_torch" in mods and "torch" in mods
    assert not mods & set(FORBIDDEN), mods & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    mods = _top_modules("import sys, os\nsys.path.insert(0, os.getcwd())\n"
                        "from bench_port.reference import zxc_numpy")
    assert "numpy" in mods
    assert not mods & {"zxc_tpu_torch", "torch", *FORBIDDEN}
