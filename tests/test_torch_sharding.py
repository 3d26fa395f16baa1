"""The port's sharded decode and encode (``zxc_tpu_torch.parallel``)
against the JAX package's ``zxc_tpu.parallel``, on the CPU.

The JAX side runs in this process on the virtual CPU devices of
``tests/conftest.py`` (``make_mesh(jax.devices()[:n], ...)``). The port
side runs on gloo ranks started by the port's own launcher
(``parallel.launch``), each running ``parallel.jobs.run_jobs`` on one
spec and writing its results under ``tmp_path``; one launch serves all
the scenarios of a rank count (module-scoped fixtures), and each
scenario is its own test case. Inputs are made with numpy from seeds;
every comparison is byte or array equality (tolerance 0), and errors
must carry the JAX error's code and message on every rank.
"""
import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

import jax
from zxc_tpu import parallel as jpar
from zxc_tpu.codec.frame import DecodeOpts as JDecodeOpts
from zxc_tpu.errors import ZxcError as JZxcError
from zxc_tpu.ops import plan_frame as jplan_frame
from zxc_tpu.ops.batch import _pad_batch, _pow2
from zxc_tpu.parallel import sharding as jsh

import zxc_tpu_torch as Z
from zxc_tpu_torch import entry, parallel
from zxc_tpu_torch.codec import frame as pframe
from zxc_tpu_torch.parallel import launch

from test_torch_jax_native import jax_native

LAUNCH_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()


def _data(seed=0, n=200_000):
    """test_sharding.py's data: a repeated segment, random low bytes and a
    run."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, 256, 1231, dtype=np.uint8).tobytes()
    return (seg * 50 + rng.integers(0, 64, n // 2, dtype=np.uint8).tobytes()
            + b"run" * 10_000)[:n]


def _big_data():
    """test_sharding.py's production-size data: 8 blocks of 256 KiB less
    99 bytes."""
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 256, 2011, dtype=np.uint8).tobytes()
    data = (seg * 600 + b"repeated content block " * 9000
            + rng.integers(0, 256, 300000, dtype=np.uint8).tobytes())
    block = 256 * 1024
    return (data * ((block * 8) // len(data) + 1))[:block * 8 - 99]


def _enc_data():
    """test_sharding.py's encode data: 188,000 bytes, 11 full 16 KiB
    blocks and a tail."""
    rng = np.random.default_rng(21)
    seg = (b"sharded encode block content! " * 3000)[:40000]
    return (seg + rng.integers(0, 256, 7000, dtype=np.uint8).tobytes()) * 4


def _words(seed=11, n=24 * 4096 - 77):
    """Word soup with repeats at many distances, runs and random bytes:
    hundreds of sequences a 4 KiB block."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 123, rng.integers(2, 9)).astype(np.uint8))
             for _ in range(300)]
    out = bytearray()
    while len(out) < n:
        r = rng.random()
        if r < 0.03:
            out += bytes([rng.integers(0, 256)]) * int(rng.integers(4, 300))
        elif r < 0.06:
            out += rng.integers(0, 256, 40, dtype=np.uint8).tobytes()
        else:
            out += vocab[int(rng.zipf(1.3)) % len(vocab)] + b" "
    return bytes(out[:n])


DICT = b"the dictionary payload shared by every chip " * 50
DICT_DATA = b"the dictionary payload appears in this doc too " * 400
# [block, sequence, field, value] on the word soup's 24 blocks: block 9
# (rank 1's rows) overflows its capacity, block 20 (rank 3's) points
# before its window; the first one in batch order wins
TAMPER = [[9, 0, "ml", 1_000_000], [20, 1, "off", 60_000]]


def _mesh(n, axes, shape=None):
    return jpar.make_mesh(jax.devices()[:n], axes=tuple(axes),
                          shape=None if shape is None else tuple(shape))


def _batch(arc, tampered=False):
    """The padded (24, ...) batch of the word soup's archive; tampered,
    three rows are corrupt: an offset past its window, a literal count
    too small, a block over its capacity."""
    plan = jplan_frame(arc)
    S, L = _pow2(plan.max_seq), _pow2(plan.max_lit)
    ll, ml, off, lit, n_seq, lit_len = _pad_batch(plan, range(plan.n_blocks),
                                                  S, L)
    if tampered:
        off[1, 2] = 60_000
        lit_len[7] = 0
        ml[13, 0] += 1_000_000
    return dict(ll=ll, ml=ml, off=off, lit=lit, n_seq=n_seq, lit_len=lit_len)


def _jax_run(job, files):
    """The JAX package's result for one job: bytes, arrays or
    ["ZxcError", code, message]."""
    mesh = _mesh(job["n"], job["axes"], job.get("shape"))
    op = job["op"]
    try:
        if op in ("decode_plan_sharded", "decode_plan_dp_sp"):
            opts = (JDecodeOpts(dict_content=DICT) if job.get("dict")
                    else None)
            plan = jplan_frame(files[job["archive"]], opts)
            for blk, seq, fld, value in job.get("tamper") or ():
                getattr(plan, fld)[blk][seq] = value
            if op == "decode_plan_sharded":
                return jpar.decode_plan_sharded(plan, mesh,
                                                batch=job.get("batch"))
            return jpar.decode_plan_dp_sp(plan, mesh)
        if op == "dp_sp_kernel":
            arrays = np.load(job["arrays"])
            kern = jsh.dp_sp_kernel(job["block"], jsh._mesh_key(mesh))
            return tuple(np.asarray(t) for t in kern(
                *(arrays[k] for k in ("ll", "ml", "off", "lit", "n_seq",
                                      "lit_len"))))
        if op == "encode_blocks_sharded":
            blocks = np.frombuffer(files[job["input"]], np.uint8).reshape(
                -1, job["block_size"])
            return tuple(np.asarray(t) for t in jpar.encode_blocks_sharded(
                blocks, mesh, job["level"]))
        if op == "compress_sharded":
            return jpar.compress_sharded(files[job["input"]], mesh,
                                         job["level"], job["block_size"],
                                         job["checksum"])
    except JZxcError as e:
        return ["ZxcError", e.code, str(e)]
    raise AssertionError(op)


def _launch_jobs(tmp, n, jobs, files):
    """Writes the inputs and the spec, runs the jobs on ``n`` gloo ranks
    and returns ({name: [result of each rank]}, [modules of each rank],
    wall seconds)."""
    for name, blob in files.items():
        with open(os.path.join(tmp, name), "wb") as f:
            f.write(blob)
    spec_jobs = []
    for job in jobs:
        job = dict(job)
        for key in ("archive", "input", "dict"):
            if job.get(key):
                job[key] = os.path.join(tmp, job[key])
        spec_jobs.append(job)
    spec = os.path.join(tmp, "spec.json")
    with open(spec, "w") as f:
        json.dump({"out": str(tmp), "device": "cpu", "jobs": spec_jobs}, f)
    t0 = time.perf_counter()
    launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", n, args=(spec,),
                  device="cpu", timeout=LAUNCH_TIMEOUT)
    wall = time.perf_counter() - t0
    res = {}
    for job in jobs:
        res[job["name"]] = []
        for r in range(n):
            with open(os.path.join(tmp, f"{job['name']}.r{r}.pkl"),
                      "rb") as f:
                res[job["name"]].append(pickle.load(f))
    mods = []
    for r in range(n):
        with open(os.path.join(tmp, f"modules.r{r}.json")) as f:
            mods.append(json.load(f))
    return res, mods, wall


def _files():
    big = _big_data()
    return {
        "dp8k.zxc": Z.compress(_data(), Z.EncodeOpts(level=3,
                                                     block_size=8192)),
        "dict.zxc": Z.compress(DICT_DATA, Z.EncodeOpts(
            level=3, block_size=4096, dict_content=DICT)),
        "dict.bin": DICT,
        "sp_l4.zxc": Z.compress(_data(3, 96_000), Z.EncodeOpts(
            level=4, block_size=4096)),
        "sp_l2.zxc": Z.compress(_data(5, 40_000), Z.EncodeOpts(
            level=2, block_size=4096)),
        "sp_256k.zxc": Z.compress(big, Z.EncodeOpts(level=3,
                                                    block_size=256 << 10)),
        "words.zxc": Z.compress(_words(), Z.EncodeOpts(level=3,
                                                       block_size=4096)),
        "enc.bin": _enc_data(),
        "enc8.bin": _enc_data()[:8 * 8192],
        "enc6.bin": _enc_data()[:6 * 8192],
        "enc4k.bin": _enc_data()[:4 * 4096 + 100],
    }


PLAIN = {"dp8k.zxc": _data(), "dict.zxc": DICT_DATA,
         "sp_l4.zxc": _data(3, 96_000), "sp_l2.zxc": _data(5, 40_000),
         "sp_256k.zxc": None, "words.zxc": _words()}

JOBS4 = [
    dict(name="dp_8k", op="decode_plan_sharded", archive="dp8k.zxc",
         axes=["dp"], shape=[4]),
    dict(name="dp_dict", op="decode_plan_sharded", archive="dict.zxc",
         dict="dict.bin", axes=["dp"], shape=[4]),
    dict(name="dp_batch6", op="decode_plan_sharded", archive="dp8k.zxc",
         batch=6, axes=["dp"], shape=[4]),
    dict(name="dp_sp_2x2", op="decode_plan_dp_sp", archive="sp_l4.zxc",
         axes=["dp", "sp"], shape=[2, 2]),
    dict(name="dp_sp_1x4", op="decode_plan_dp_sp", archive="sp_l2.zxc",
         axes=["dp", "sp"], shape=[1, 4]),
    dict(name="dp_sp_4x1", op="decode_plan_dp_sp", archive="sp_l2.zxc",
         axes=["dp", "sp"], shape=[4, 1]),
    dict(name="dp_words", op="decode_plan_sharded", archive="words.zxc",
         axes=["dp"], shape=[4]),
    dict(name="dp_sp_words", op="decode_plan_dp_sp", archive="words.zxc",
         axes=["dp", "sp"], shape=[2, 2]),
    dict(name="dp_sp_256k", op="decode_plan_dp_sp", archive="sp_256k.zxc",
         axes=["dp", "sp"], shape=[2, 2]),
    dict(name="kernel_clean", op="dp_sp_kernel", arrays="clean.npz",
         block=4096, axes=["dp", "sp"], shape=[2, 2]),
    dict(name="kernel_tampered", op="dp_sp_kernel", arrays="tampered.npz",
         block=4096, axes=["dp", "sp"], shape=[2, 2]),
    dict(name="encode_blocks", op="encode_blocks_sharded", input="enc8.bin",
         block_size=8192, level=3, axes=["dp"], shape=[4]),
    dict(name="compress", op="compress_sharded", input="enc.bin",
         block_size=16384, level=3, checksum=True, axes=["dp"], shape=[4]),
    dict(name="compress_l1", op="compress_sharded", input="enc8.bin",
         block_size=8192, level=1, checksum=True, axes=["dp"], shape=[4]),
    dict(name="compress_l6", op="compress_sharded", input="enc4k.bin",
         block_size=4096, level=6, checksum=False, axes=["dp"], shape=[4]),
    dict(name="corrupt_plan", op="decode_plan_sharded", archive="words.zxc",
         tamper=TAMPER, axes=["dp"], shape=[4]),
    dict(name="corrupt_plan_dp_sp", op="decode_plan_dp_sp",
         archive="words.zxc", tamper=[[5, 1, "off", 60_000]],
         axes=["dp", "sp"], shape=[2, 2]),
    dict(name="dict_dp_sp", op="decode_plan_dp_sp", archive="dict.zxc",
         dict="dict.bin", axes=["dp", "sp"], shape=[2, 2]),
    dict(name="truncated", op="decode_plan_sharded",
         archive="truncated.zxc", axes=["dp"], shape=[4]),
    dict(name="block_not_split", op="dp_sp_kernel", arrays="clean.npz",
         block=4098, axes=["dp", "sp"], shape=[1, 4]),
]

JOBS3 = [
    dict(name="dp_pad3", op="decode_plan_sharded", archive="dp8k.zxc",
         axes=["dp"], shape=[3]),
    dict(name="dp_sp_pad3", op="decode_plan_dp_sp", archive="sp_l2.zxc",
         axes=["dp", "sp"], shape=[3, 1]),
    dict(name="compress_tail3", op="compress_sharded", input="enc.bin",
         block_size=16384, level=3, checksum=True, axes=["dp"], shape=[3]),
    dict(name="encode_blocks3", op="encode_blocks_sharded",
         input="enc6.bin", block_size=8192, level=3, axes=["dp"],
         shape=[3]),
]


def _run(tmp, n, jobs):
    files = _files()
    files["truncated.zxc"] = files["dp8k.zxc"][:len(files["dp8k.zxc"]) // 2]
    np.savez(os.path.join(tmp, "clean.npz"),
             **_batch(files["words.zxc"]))
    np.savez(os.path.join(tmp, "tampered.npz"),
             **_batch(files["words.zxc"], tampered=True))
    for job in jobs:
        if job.get("arrays"):
            job["arrays"] = os.path.join(tmp, job["arrays"])
    got, mods, wall = _launch_jobs(tmp, n, jobs, files)
    want = {job["name"]: _jax_run(dict(job, n=n), files)
            for job in jobs if job["op"] != "dp_sp_kernel"
            or job["block"] % job["shape"][1] == 0}
    return {"got": got, "want": want, "mods": mods, "wall": wall,
            "jobs": {j["name"]: j for j in jobs}}


@pytest.fixture(scope="module")
def run4(tmp_path_factory):
    jax_native()
    return _run(tmp_path_factory.mktemp("shard4"), 4,
                [dict(j) for j in JOBS4])


@pytest.fixture(scope="module")
def run3(tmp_path_factory):
    jax_native()
    return _run(tmp_path_factory.mktemp("shard3"), 3,
                [dict(j) for j in JOBS3])


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return (isinstance(b, tuple) and len(a) == len(b)
                and all(np.array_equal(x, y) and x.dtype == y.dtype
                        for x, y in zip(a, b)))
    return a == b


def _check_same_as_jax(run, name):
    want = run["want"][name]
    for rank, res in enumerate(run["got"][name]):
        if isinstance(want, list):
            assert res.get("error") == want, (name, rank, res.get("error"))
        else:
            assert "ok" in res, (name, rank, res.get("error"))
            assert _equal(res["ok"], want), (name, rank)


DECODES4 = ["dp_8k", "dp_dict", "dp_batch6", "dp_words", "dp_sp_2x2",
            "dp_sp_1x4", "dp_sp_4x1", "dp_sp_words", "dp_sp_256k"]


@pytest.mark.parametrize("name", DECODES4)
def test_decode_equals_jax(run4, name):
    _check_same_as_jax(run4, name)
    job = run4["jobs"][name]
    plain = PLAIN[job["archive"]]
    if plain is None:
        plain = _big_data()
    assert run4["got"][name][0]["ok"] == plain


@pytest.mark.parametrize("name", ["encode_blocks", "compress",
                                  "compress_l1", "compress_l6"])
def test_encode_equals_jax(run4, name):
    _check_same_as_jax(run4, name)


def test_compress_sharded_decodes_back(run4):
    arc = run4["got"]["compress"][0]["ok"]
    assert pframe.decompress(arc, Z.DecodeOpts(checksum=True)) == _enc_data()


@pytest.mark.parametrize("name", ["corrupt_plan", "corrupt_plan_dp_sp",
                                  "dict_dp_sp", "truncated"])
def test_errors_equal_jax_on_every_rank(run4, name):
    want = run4["want"][name]
    assert isinstance(want, list) and want[0] == "ZxcError", want
    _check_same_as_jax(run4, name)


def test_corrupt_plan_raises_the_first_error_in_batch_order(run4):
    # block 9 overflows, block 20 points out of its window: every rank
    # raises block 9's error, though rank 1 alone holds block 9
    err = run4["got"]["corrupt_plan"][3]["error"]
    assert err[2].endswith("decoded size exceeds capacity"), err


def test_block_that_does_not_split_over_sp_raises(run4):
    for res in run4["got"]["block_not_split"]:
        assert res["error"][0] == "ValueError", res
        assert "does not split" in res["error"][2]


@pytest.mark.parametrize("which", ["kernel_clean", "kernel_tampered"])
def test_dp_sp_kernel_shards_equal_jax(run4, which):
    """Each rank's (out, total, err) is JAX's output at the rank's (dp, sp)
    coordinates: rows of its dp row, positions of its sp chunk."""
    job = run4["jobs"][which]
    out, total, err = run4["want"][which]
    B = out.shape[0]
    block = job["block"]
    if which == "kernel_tampered":
        assert err[1] & 4 and err[7] & 1 and err[13] & 2, err
    for rank, res in enumerate(run4["got"][which]):
        d, s = divmod(rank, 2)
        rows = slice(d * B // 2, (d + 1) * B // 2)
        cols = slice(s * block // 2, (s + 1) * block // 2)
        g_out, g_total, g_err = res["ok"]
        assert np.array_equal(g_out, out[rows, cols]), rank
        assert np.array_equal(g_total, total[rows]), rank
        assert np.array_equal(g_err, err[rows]), rank
        assert g_out.dtype == np.uint8 and g_err.dtype == np.int32


@pytest.mark.parametrize("name", [j["name"] for j in JOBS4
                                  if j["op"] != "dp_sp_kernel"])
def test_every_rank_returns_the_same(run4, name):
    results = run4["got"][name]
    first = results[0].get("ok", results[0].get("error"))
    for res in results[1:]:
        assert _equal(res.get("ok", res.get("error")), first), name


@pytest.mark.parametrize("n", [3, 4])
def test_ranks_load_no_jax(run3, run4, n):
    run = run3 if n == 3 else run4
    assert run["mods"] == [[]] * n


@pytest.mark.parametrize("name", [j["name"] for j in JOBS3])
def test_odd_mesh_equals_jax(run3, name):
    """Three ranks: pad rows in each batch (25 blocks over 3, 10 over 3)
    and the blocks that do not fill the mesh on the single-device path."""
    _check_same_as_jax(run3, name)
    results = run3["got"][name]
    for res in results[1:]:
        assert _equal(res["ok"], results[0]["ok"])


PHASE_KEYS = {"decode_plan_sharded": {"pad", "device", "collective",
                                      "emit"},
              "decode_plan_dp_sp": {"pad", "device", "collective", "emit"},
              "compress_sharded": {"device", "emit", "collective", "tail"}}


@pytest.mark.parametrize("n,name", [(n, j["name"])
                                    for n, jobs in ((4, JOBS4), (3, JOBS3))
                                    for j in jobs if j["op"] in PHASE_KEYS])
def test_phase_keys_are_the_sharded_paths_own(run3, run4, n, name):
    """Each sharded call's ``_phases`` holds its own keys, seconds on every
    rank, and none of the spans or counters of the encode path it runs
    (the tail's ``encode_chunk_device`` keeps out of ``emit``); a call
    that raises adds nothing."""
    run = run3 if n == 3 else run4
    want = PHASE_KEYS[run["jobs"][name]["op"]]
    for res in run["got"][name]:
        if "ok" not in res:
            assert res["phases"] == {}, name
            continue
        assert set(res["phases"]) == want, name
        assert all(isinstance(v, float) and v >= 0
                   for v in res["phases"].values())


def test_odd_mesh_decodes_the_data(run3):
    assert run3["got"]["dp_pad3"][1]["ok"] == _data()
    assert run3["got"]["dp_sp_pad3"][2]["ok"] == _data(5, 40_000)
    arc = run3["got"]["compress_tail3"][0]["ok"]
    assert pframe.decompress(arc, Z.DecodeOpts(checksum=True)) == _enc_data()


def test_dryrun_multichip_cpu():
    entry.dryrun_multichip(4, device="cpu")


def test_rank_that_raises_fails_the_launch(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "device": "cpu",
                                "jobs": [dict(name="f", op="fail", rank=1,
                                              axes=["dp"])]}))
    t0 = time.perf_counter()
    with pytest.raises(launch.LaunchError, match="rank 1 failed") as e:
        launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", 3,
                      args=(str(spec),), device="cpu", timeout=60)
    assert time.perf_counter() - t0 < 60
    assert "fails before the collective" in str(e.value)


def test_launch_outlived_raises(tmp_path):
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"out": str(tmp_path), "device": "cpu",
                                "jobs": []}))
    with pytest.raises(launch.LaunchError, match="still running"):
        launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", 2,
                      args=(str(spec),), device="cpu", timeout=0.5)


def test_launch_takes_only_functions_of_the_package():
    with pytest.raises(ValueError, match="zxc_tpu_torch"):
        launch.launch("os:getcwd", 1)
    with pytest.raises(ValueError, match="zxc_tpu_torch"):
        launch.launch("zxc_tpu.parallel:make_mesh", 1)
    with pytest.raises(ValueError, match="cpu or cuda"):
        launch.launch("zxc_tpu_torch.parallel.jobs:run_jobs", 1,
                      device="meta")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        parallel.make_mesh("cpu")


def test_no_device_means_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-CUDA refusal "
                    "cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.dryrun_multichip(2)
