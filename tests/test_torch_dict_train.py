"""The port's NumPy dictionary trainer (``codec.dict_train.train_dict`` /
``train_dict_huf``) against the JAX package's, on the CPU, and the
dictionary carried across the two packages: content and 128-byte table
bytes equal to the JAX package's, a JAX-trained dictionary driving the
port's ``Cctx`` and a port-trained one driving the JAX ``Cctx`` with equal
archives, ``.zxd`` bytes equal, and the trainers' refusals with the same
codes. Tolerance: exact equality.
"""
import numpy as np
import pytest

from zxc_tpu import context as jctx, runtime as jrt
from zxc_tpu.codec import dict_train as jdt
from zxc_tpu.errors import ZxcError as JZxcError
from zxc_tpu.format import dictionary as jdict

import zxc_tpu_torch as Z
from zxc_tpu_torch.codec import dict_train as pdt

from test_torch_jax_native import jax_native


@pytest.fixture(autouse=True)
def _jax_native():
    jax_native()
    assert jrt.available()


def _samples(seed: int, n: int = 24, size: int = 2000) -> list[bytes]:
    """Request-log-like samples: shared prefixes, varying fields."""
    rng = np.random.default_rng(seed)
    paths = [b"/api/v1/users", b"/api/v1/orders", b"/static/app.js",
             b"/api/v2/search?q=", b"/healthz"]
    out = []
    for _ in range(n):
        s = bytearray()
        while len(s) < size:
            s += (b"GET " + paths[int(rng.integers(0, len(paths)))]
                  + b" HTTP/1.1\r\nhost: example.org\r\nuser-agent: zxc/"
                  + str(int(rng.integers(0, 40))).encode() + b"\r\nx-id: "
                  + rng.integers(48, 58, 10, dtype=np.uint8).tobytes()
                  + b"\r\n\r\n")
        out.append(bytes(s[:size]))
    return out


def _code(fn):
    try:
        fn()
    except (JZxcError, Z.ZxcError) as e:
        return e.code
    raise AssertionError("no ZxcError raised")


@pytest.mark.parametrize("target", [256, 1024, 16384])
@pytest.mark.parametrize("seed", [1, 2])
def test_train_dict_and_table_equal_jax(seed, target):
    samples = _samples(seed)
    content = pdt.train_dict(samples, target)
    assert content == jdt.train_dict(samples, target)
    assert 0 < len(content) <= target
    table = pdt.train_dict_huf(samples, content)
    assert table == jdt.train_dict_huf(samples, content)
    assert len(table) == 128
    assert Z.Dictionary(content, table).save() == \
        jdict.Dictionary(content, table).save()


def test_mixed_sample_sizes_equal_jax():
    """Samples shorter than a gram or a segment, and one over a block."""
    rng = np.random.default_rng(3)
    samples = _samples(3, 6, 700) + [b"abc", b"", rng.integers(
        0, 4, 600_000, dtype=np.uint8).tobytes()]
    content = pdt.train_dict(samples, 4096)
    assert content == jdt.train_dict(samples, 4096)
    assert pdt.train_dict_huf(samples, content) == \
        jdt.train_dict_huf(samples, content)


@pytest.mark.parametrize("level", [1, 3, 6, 7])
def test_dictionary_drives_the_other_package(level):
    samples = _samples(4)
    body = b"".join(_samples(5, 8, 3000))
    # trained by the JAX package, used by the port
    jc = jdt.train_dict(samples, 2048)
    jt = jdt.train_dict_huf(samples, jc)
    # trained by the port, used by the JAX package
    pc = pdt.train_dict(samples, 2048)
    pt = pdt.train_dict_huf(samples, pc)
    for content, table in ((jc, jt), (pc, pt)):
        p = Z.Cctx(level=level, block_size=4096, checksum=True)
        p.attach_dict(content, table)
        j = jctx.Cctx(level=level, block_size=4096, checksum=True)
        j.attach_dict(content, table)
        arc = p.compress(body)
        assert arc == j.compress(body)
        assert p.compress_block(body[:4096]) == j.compress_block(body[:4096])
        assert Z.get_dict_id(arc) == Z.Dictionary(content, table).id
        dctx = Z.Dctx(checksum=True).attach_dict(content, table)
        assert dctx.decompress(arc) == body
        assert jctx.Dctx(checksum=True).attach_dict(
            content, table).decompress(arc) == body


def test_native_dict_train_still_equals_jax():
    samples = _samples(6)
    assert pdt.dict_train(samples, 1024).save() == \
        jdt.dict_train(samples, 1024).save()


def test_refusals_equal_jax():
    for args in (([], 1024), ([b"abcdefgh" * 10], 0), ([b"abc", b""], 1024)):
        assert _code(lambda: pdt.train_dict(*args)) == \
            _code(lambda: jdt.train_dict(*args)) == Z.ERROR_NULL_INPUT
    big = b"x" * (Z.constants.DICT_SIZE_MAX + 1)
    assert _code(lambda: pdt.train_dict_huf([b"abc"], big)) == \
        _code(lambda: jdt.train_dict_huf([b"abc"], big)) == \
        Z.ERROR_DICT_TOO_LARGE
    assert _code(lambda: pdt.dict_train([])) == \
        _code(lambda: jdt.dict_train([])) == Z.ERROR_NULL_INPUT
