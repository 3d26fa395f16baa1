"""The port's command line (``python -m zxc_tpu_torch``) against the JAX
package's (``python -m zxc_tpu``), host commands.

Both ``main`` functions run in this process on the same inputs (numpy,
fixed seeds), each in its own directory, one command at a time. After each
command the exit codes and stdout must be equal, stderr equal once decimal
numbers (times, rates) are masked, and the two directories must hold the
same files with the same bytes. The cases follow ``tests/test_cli.py`` and
``tests/test_cli_matrix.py``. The allowed differences are the ``-V`` line
and the ``--help`` text (GPU for TPU). A few cases run
``python -m zxc_tpu_torch`` in a subprocess.
"""
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from zxc_tpu import cli as JC
from zxc_tpu.codec import dict_train as JDT, frame as JF
from zxc_tpu.errors import ZxcError as JZxcError
from zxc_tpu.format import dictionary as JD, headers as JH
from zxc_tpu_torch import cli as PC
from zxc_tpu_torch.codec import dict_train as PDT, frame as PF
from zxc_tpu_torch.errors import ZxcError as PZxcError
from zxc_tpu_torch.format import dictionary as PD, headers as PH

from test_torch_jax_native import jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECIMAL = re.compile(rb"\d+\.\d+")


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _files() -> dict:
    rng = np.random.default_rng(7)
    seg = rng.integers(32, 127, 600, dtype=np.uint8).tobytes()
    return {
        "t.txt": (b"The quick brown fox jumps over the lazy dog. " * 800
                  + rng.integers(32, 127, 4000, dtype=np.uint8).tobytes()),
        "rnd.bin": rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes(),
        "runs.dat": b"\x00" * 30000 + b"ab" * 5000,
        "a.txt": seg * 40,
        "empty": b"",
    }


def _tree(d) -> dict:
    out = {}
    for dirpath, _, names in os.walk(d):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


class Pair:
    """The JAX CLI in ``jax/`` and the port's in ``port/``, started on the
    same files; ``run`` gives both the same command and checks that they
    agree."""

    def __init__(self, tmp_path, monkeypatch, capsysbinary, files):
        self.mp, self.cap = monkeypatch, capsysbinary
        self.dirs = {"jax": tmp_path / "jax", "port": tmp_path / "port"}
        for d in self.dirs.values():
            self.write(d, files)

    @staticmethod
    def write(d, files: dict):
        for name, data in files.items():
            p = d / name
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)

    def add(self, files: dict):
        for d in self.dirs.values():
            self.write(d, files)

    def one(self, side: str, argv, stdin: bytes = b""):
        self.mp.chdir(self.dirs[side])
        self.mp.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(stdin)))
        self.mp.setattr(sys, "argv", ["zxc"])
        self.cap.readouterr()
        rc = (JC.main if side == "jax" else PC.main)(list(argv))
        out, err = self.cap.readouterr()
        return rc, out, err

    def run(self, *argv, stdin: bytes = b"", rc: int = 0,
            same_stdout: bool = True):
        """Both CLIs on ``argv``; returns the port's (rc, stdout, stderr)."""
        j = self.one("jax", argv, stdin)
        p = self.one("port", argv, stdin)
        assert p[0] == j[0] == rc, (argv, j, p)
        if same_stdout:
            assert p[1] == j[1], argv
        assert DECIMAL.sub(b"#", p[2]) == DECIMAL.sub(b"#", j[2]), (
            argv, j[2], p[2])
        assert _tree(self.dirs["port"]) == _tree(self.dirs["jax"]), argv
        return p

    def read(self, name: str) -> bytes:
        return (self.dirs["port"] / name).read_bytes()


@pytest.fixture()
def pair(tmp_path, monkeypatch, capsysbinary):
    return Pair(tmp_path, monkeypatch, capsysbinary, _files())


FILES = _files()


@pytest.mark.parametrize("level", range(1, 8))
def test_levels(pair, level):
    pair.run("-z", "-k", "-f", f"-{level}", "t.txt")
    assert pair.run("-d", "-c", "t.txt.zxc")[1] == FILES["t.txt"]
    pair.run("-l", "t.txt.zxc")


@pytest.mark.parametrize("bs", ["4K", "64K", "2M", "16k"])
def test_block_sizes(pair, bs):
    pair.run("-z", "-k", "-B", bs, "t.txt")
    pair.run("-l", "t.txt.zxc")
    assert pair.run("-d", "-c", "t.txt.zxc")[1] == FILES["t.txt"]


@pytest.mark.parametrize("name", ["t.txt", "rnd.bin", "runs.dat", "a.txt"])
def test_data_types(pair, name):
    pair.run("-z", "-k", "-3", name)
    assert pair.run("-d", "-c", name + ".zxc")[1] == FILES[name]


def test_seekable(pair):
    pair.run("-z", "-k", "-S", "-B", "4K", "rnd.bin")
    assert b"seekable:        yes" in pair.run("-l", "rnd.bin.zxc")[1]
    row = json.loads(pair.run("-l", "-j", "rnd.bin.zxc")[1])
    assert row["seekable"] == -(-len(FILES["rnd.bin"]) // 4096)
    assert pair.run("-d", "-c", "rnd.bin.zxc")[1] == FILES["rnd.bin"]


@pytest.mark.parametrize("flag", ["-C", "-N"])
def test_checksum_flags(pair, flag):
    pair.run("-z", "-k", flag, "t.txt")
    pair.run("-l", "t.txt.zxc")
    pair.run("-t", "t.txt.zxc")
    assert pair.run("-d", "-c", flag, "t.txt.zxc")[1] == FILES["t.txt"]


def test_keep_force_and_output(pair):
    pair.run("-z", "t.txt")                        # input deleted
    pair.run("-d", "t.txt.zxc")                    # and restored
    pair.run("-z", "-k", "t.txt")
    pair.run("-z", "-k", "t.txt", rc=1)            # .zxc exists
    pair.run("-z", "-k", "-f", "t.txt")
    pair.run("-z", "-f", "-o", "named.zxc", "t.txt")  # -o keeps the input
    pair.run("-d", "-f", "-o", "named.out", "named.zxc")
    assert pair.read("named.out") == FILES["t.txt"]
    pair.run("-d", "-f", "t.txt.zxc", "pos.out")   # positional output
    assert pair.read("pos.out") == FILES["t.txt"]
    pair.run("-d", "-k", "t.txt.zxc", rc=1)        # t.txt exists


def test_stdin_and_stdout(pair):
    data = FILES["t.txt"]
    arc = pair.run("-z", "-c", "-6", stdin=data)[1]
    assert pair.run("-d", "-c", stdin=arc)[1] == data
    arc = pair.run(stdin=data)[1]                  # default mode: compress
    assert pair.run("-d", "-c", "-", stdin=arc)[1] == data
    arc = pair.run("-z", "-c", "-", stdin=FILES["rnd.bin"])[1]
    assert pair.run("-d", "-c", "-", stdin=arc)[1] == FILES["rnd.bin"]
    pair.run("-z", "-c", "a.txt")
    pair.run("-d", "-c", stdin=b"", rc=1)


def test_empty_file(pair):
    pair.run("-z", "-k", "-3", "empty")
    assert pair.run("-d", "-c", "empty.zxc")[1] == b""
    pair.run("-l", "empty.zxc")
    pair.run("-l", "-j", "empty.zxc")
    pair.run("-t", "empty.zxc")
    assert pair.run("-z", "-c", stdin=b"")[1]


def test_multiple_and_recursive(pair):
    pair.run("-z", "-k", "-m", "t.txt", "rnd.bin", "runs.dat")
    pair.run("-d", "-k", "-f", "-m", "t.txt.zxc", "rnd.bin.zxc")
    pair.run("-z", "-k", "-m", "-o", "x.zxc", "t.txt", "rnd.bin", rc=1)
    pair.add({"tree/one.txt": b"one " * 500, "tree/sub/two.txt": b"two " * 700,
              "tree/sub/leaf/three.txt": b"three " * 900})
    pair.run("-z", "-k", "-r", "tree")
    pair.run("-d", "-c", os.path.join("tree", "sub", "two.txt.zxc"))
    pair.run("-t", "-r", "tree", rc=1)             # the plain files fail


@pytest.mark.parametrize("threads", ["1", "4"])
def test_threads(pair, threads):
    pair.run("-z", "-k", "-T", threads, "-o", f"t{threads}.zxc", "t.txt")
    pair.run("-z", "-k", "-T", "0", "-o", "t0.zxc", "t.txt")
    assert pair.read(f"t{threads}.zxc") == pair.read("t0.zxc")
    assert pair.run("-d", "-c", "-T", threads, "t0.zxc")[1] == FILES["t.txt"]


def test_list_text_json_and_failing_entry(pair):
    pair.run("-z", "-k", "-S", "-C", "-B", "4K", "t.txt")
    pair.run("-z", "-k", "-N", "rnd.bin")
    pair.add({"junk.zxc": b"this is not an archive at all",
              "s.j": b'{"k": 1, "endpoint": "/api/v1/x"}' * 30})
    pair.run("--train", "--dict-size", "1024", "-o", "d.zxd", "s.j")
    out = pair.run("-l", "t.txt.zxc", "rnd.bin.zxc")[1]
    assert b"block size:      4096" in out and b"checksums:       no" in out
    out = pair.run("-l", "-j", "-m", "t.txt.zxc", "junk.zxc", "d.zxd",
                   rc=1)[1]
    rows = [json.loads(line) for line in out.splitlines()]
    assert rows[0]["decompressed"] == len(FILES["t.txt"])
    assert "error" in rows[1] and rows[2]["type"] == "dictionary"
    pair.run("-l", "junk.zxc", "d.zxd", rc=1)
    pair.run("-l", "nosuch.zxc", rc=1)


def test_test_mode_good_and_corrupt(pair):
    pair.run("-z", "-k", "-C", "t.txt")
    pair.run("-t", "t.txt.zxc")
    blob = bytearray(pair.read("t.txt.zxc"))
    blob[len(blob) // 2] ^= 0xFF
    pair.add({"bad.zxc": bytes(blob), "trunc.zxc": bytes(blob[:len(blob) // 3])})
    pair.run("-t", "bad.zxc", rc=1)
    pair.run("-t", "t.txt.zxc", "bad.zxc", "trunc.zxc", rc=1)
    pair.run("-d", "-c", "trunc.zxc", rc=1)
    pair.run("-d", "-c", "bad.zxc", rc=1)


def test_bench_json(pair):
    j = pair.one("jax", ["-b", "1", "-j", "-1", "t.txt"])
    p = pair.one("port", ["-b", "1", "-j", "-1", "t.txt"])
    assert p[0] == j[0] == 0 and p[2] == j[2] == b""
    jr, pr = json.loads(j[1]), json.loads(p[1])
    assert pr.keys() == jr.keys()
    timing = ("compress_mbps", "decompress_mbps")
    assert ({k: v for k, v in pr.items() if k not in timing}
            == {k: v for k, v in jr.items() if k not in timing})
    assert all(pr[k] > 0 for k in timing)


def test_train_and_dictionary(pair):
    samples = [f"s{i}.json" for i in range(6)]
    pair.add({n: b'{"id": %d, "status": "ok", "tags": ["a","b"]}' % i * 40
              for i, n in enumerate(samples)})
    pair.add({f"u{i}.j": b"completely different corpus %d " % i * 40
              for i in range(5)})
    pair.run("--train", "--dict-size", "2048", "-o", "d.zxd", "-f", *samples)
    pair.run("--train", "--dict-size", "1024", *[f"u{i}.j" for i in range(5)])
    assert b"zxc dictionary" in pair.run("-l", "d.zxd")[1]
    pair.run("-l", "-j", "d.zxd")
    pair.run("-z", "-k", "-f", "-D", "d.zxd", "-o", "s0.zxc", "s0.json")
    pair.run("-l", "s0.zxc")
    pair.run("-l", "-j", "s0.zxc")
    assert pair.run("-d", "-c", "-D", "d.zxd", "s0.zxc")[1] == \
        pair.read("s0.json")
    pair.run("-t", "-D", "d.zxd", "s0.zxc")
    assert b"DICT_REQUIRED" in pair.run("-d", "-c", "s0.zxc", rc=1)[2]
    other = [n for n in os.listdir(pair.dirs["port"])
             if n.startswith("dictionary_")]
    assert len(other) == 1
    assert b"DICT" in pair.run("-d", "-c", "-D", other[0], "s0.zxc",
                               rc=1)[2]
    pair.run("-z", "-c", "-D", "s0.json", "s1.json", rc=1)   # not a .zxd
    pair.run("--train", rc=1)                      # no samples
    pair.run("--train", "-f", "-o", "tiny.zxd", "empty", rc=1)
    j = pair.one("jax", ["-b", "1", "-j", "-D", "d.zxd", "s0.json"])
    p = pair.one("port", ["-b", "1", "-j", "-D", "d.zxd", "s0.json"])
    assert p[0] == j[0] == 0
    assert json.loads(p[1])["compressed"] == json.loads(j[1])["compressed"]


def test_bad_arguments(pair):
    for bs in ("777", "3K", "1", "4M", "abc"):
        pair.run("-z", "-B", bs, "-c", "t.txt", rc=1)
    pair.run("-z", "missing-input.xyz", rc=1)
    pair.run("-d", "-c", "rnd.bin", rc=1)          # not an archive
    pair.run("-z", "-k", "-f", "-o", "plain", "t.txt")
    pair.run("-d", "plain", rc=1)                  # no .zxc suffix


def test_quiet_verbose_progress_and_long_options(pair):
    assert pair.run("-z", "-k", "-f", "-q", "t.txt")[2] == b""
    assert b"t.txt" in pair.run("-z", "-k", "-f", "-v", "t.txt")[2]
    err = pair.run("-z", "-k", "-f", "--progress", "always", "t.txt")[2]
    assert b"100%" in err and b"MB/s" in err
    pair.run("-d", "-k", "-f", "--progress", "always", "-o", "p.out",
             "t.txt.zxc")
    pair.run("--compress", "--keep", "--force", "--block-size", "64K",
             "--no-checksum", "rnd.bin")
    assert pair.run("--decompress", "--stdout", "rnd.bin.zxc")[1] == \
        FILES["rnd.bin"]


def test_version_and_help_differ_only_as_allowed(pair):
    jv, pv = pair.one("jax", ["-V"]), pair.one("port", ["-V"])
    assert jv[0] == pv[0] == 0
    assert pv[1] == jv[1].replace(b"(zxc_tpu,", b"(zxc_tpu_torch,") != jv[1]
    helps = []
    for side in ("jax", "port"):
        pair.cap.readouterr()
        with pytest.raises(SystemExit) as e:
            (JC.main if side == "jax" else PC.main)(["--help"])
        assert e.value.code == 0
        helps.append(pair.cap.readouterr()[0])
    assert helps[1] == helps[0].replace(b"TPU", b"GPU") != helps[0]


# ---------------------------------------------------------------------------
# the host pieces the CLI needs
# ---------------------------------------------------------------------------

def _samples(seed: int, n: int = 12) -> list[bytes]:
    rng = np.random.default_rng(seed)
    return [b'{"user": %d, "path": "/api/v2/items", "ok": true, "pad": "'
            % i + rng.integers(97, 123, 40 + 7 * i, dtype=np.uint8).tobytes()
            + b'"}' for i in range(n)]


@pytest.mark.parametrize("target", [256, 1024, 16384])
def test_dict_train_equals_jax(target):
    samples = _samples(target) * 8
    j, p = JDT.dict_train(samples, target), PDT.dict_train(samples, target)
    assert p.save() == j.save() and p.id == j.id
    assert np.array_equal(p.content_array, j.content_array)
    assert PD.Dictionary.load(j.save()) == p


def _error(fn, blob):
    """(code, message) of the ZxcError that ``fn(blob)`` raises, or None."""
    try:
        fn(blob)
    except (JZxcError, PZxcError) as e:
        return e.code, str(e)
    return None


def test_dictionary_load_errors_equal_jax():
    good = JDT.dict_train(_samples(3) * 8, 1024).save()
    cases = {"truncated header": good[:10], "truncated content": good[:-1],
             "magic": b"\0" + good[1:],
             "version": good[:4] + b"\x09" + good[5:],
             "checksum id": good[:5] + b"\x03" + good[6:],
             "crc": good[:14] + bytes([good[14] ^ 1]) + good[15:],
             "content": good[:40] + bytes([good[40] ^ 1]) + good[41:]}
    for name, blob in cases.items():
        j = _error(JD.Dictionary.load, blob)
        assert j is not None and _error(PD.Dictionary.load, blob) == j, \
            name
    big = PD.Dictionary(b"x" * 70000, bytes(128))
    with pytest.raises(PZxcError) as e:
        big.save()
    assert e.value.code == -17
    with pytest.raises(ValueError):
        PD.Dictionary(b"x", bytes(12)).save()


@pytest.mark.parametrize("seekable", [False, True])
@pytest.mark.parametrize("checksum", [False, True])
def test_seek_table_and_blocks_equal_jax(seekable, checksum):
    data = FILES["t.txt"] + FILES["rnd.bin"]
    arc = JF.compress(data, JF.EncodeOpts(level=2, block_size=4096,
                                          checksum=checksum,
                                          seekable=seekable))
    assert PH.parse_seek_table(arc) == JH.parse_seek_table(arc)
    assert (PH.parse_seek_table(arc) is not None) == seekable
    assert [(p, vars(b)) for p, b in PF.iter_blocks(arc)] == \
        [(p, vars(b)) for p, b in JF.iter_blocks(arc)]
    assert PF.get_dict_id(arc) == JF.get_dict_id(arc) == 0
    sizes = PH.parse_seek_table(arc) or [9, 10, 11]
    assert PH.write_seek_table(sizes) == JH.write_seek_table(sizes)
    for cut in (len(arc) - 20, len(arc) // 2, 40):
        bad = arc[:cut] + arc[-12:]
        for j, p in ((lambda a: [(q, vars(b)) for q, b in JF.iter_blocks(a)],
                      lambda a: [(q, vars(b)) for q, b in PF.iter_blocks(a)]),
                     (JH.parse_seek_table, PH.parse_seek_table)):
            want = _error(j, bad) or j(bad)
            assert (_error(p, bad) or p(bad)) == want, cut


def test_host_decode_errors_equal_jax():
    """The port's host decode walks the frame before it sizes the output,
    as the JAX package's native decode does: truncated frames and lying
    footers raise the same code and message (what ``-d`` and ``-t``
    print)."""
    import struct
    arc = JF.compress(FILES["t.txt"] * 3, JF.EncodeOpts(
        level=3, block_size=4096, checksum=True))
    foot = len(arc) - 12
    size = len(FILES["t.txt"]) * 3
    cases = [arc[:cut] + arc[-12:] for cut in (20, 100, len(arc) // 3,
                                                len(arc) - 30)]
    cases += [arc[:foot] + struct.pack("<QI", n, 0)
              for n in (size + 1, size - 1, size * 50, 1 << 40, 0)]
    cases.append(arc[:foot - 8] + arc[foot:])      # no EOF block
    for i, blob in enumerate(cases):
        for opts in (None, JF.DecodeOpts(checksum=True)):
            popts = None if opts is None else PF.DecodeOpts(checksum=True)
            want = _error(lambda b: JF.decompress(b, opts), blob)
            assert want is not None, i
            assert _error(lambda b: PF.decompress(b, popts),
                               blob) == want, i


# ---------------------------------------------------------------------------
# python -m zxc_tpu_torch
# ---------------------------------------------------------------------------

def _module(*args, data=None, cwd=None, prog=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, prog] if prog else [sys.executable, "-m",
                                               "zxc_tpu_torch"]
    return subprocess.run(cmd + list(args), input=data, capture_output=True,
                          env=env, cwd=cwd, timeout=120)


def test_module_pipe_roundtrip():
    data = FILES["t.txt"]
    r1 = _module("-z", "-c", data=data)
    assert r1.returncode == 0, r1.stderr
    r2 = _module("-d", "-c", data=r1.stdout)
    assert r2.returncode == 0 and r2.stdout == data


def test_module_version_help_and_bad_block_size(tmp_path):
    r = _module("-V")
    assert r.returncode == 0 and b"zxc_tpu_torch" in r.stdout
    r = _module("--help")
    assert r.returncode == 0 and b"--device" in r.stdout
    (tmp_path / "t.txt").write_bytes(FILES["t.txt"])
    r = _module("-z", "-B", "777", "-c", "t.txt", cwd=tmp_path)
    assert r.returncode == 1 and b"bad block size" in r.stderr
    assert r.stdout == b""


def test_unzxc_alias(tmp_path):
    launcher = tmp_path / "unzxc"
    launcher.write_text("import sys\nfrom zxc_tpu_torch.cli import main\n"
                        "sys.exit(main())\n")
    (tmp_path / "t.zxc").write_bytes(JC.frame.compress(FILES["t.txt"]))
    r = _module("-c", "t.zxc", prog=str(launcher), cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert r.stdout == FILES["t.txt"]
