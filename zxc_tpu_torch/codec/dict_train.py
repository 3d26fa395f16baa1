"""Dictionary trainer (zxc_dict_train analog), the port's counterpart of
``zxc_tpu.codec.dict_train.dict_train`` through the native trainer only
(``zxch_dict_train``: 5-gram coverage selection, reverse placement, and
the shared literal table trained on the samples' level-6 literals).

The ``.zxd`` bytes equal the JAX package's wherever that package takes
its native path too. Its NumPy fallback needs the host block encoder,
which the port does not have; without the native library this raises
RuntimeError.
"""
from __future__ import annotations

from .. import runtime
from ..format.dictionary import Dictionary


def dict_train(samples: list[bytes], target_size: int = 16384) -> Dictionary:
    """Train a dictionary of at most ``target_size`` content bytes from
    ``samples``. Raises ZxcError on the trainer's errors (no samples,
    samples too small)."""
    return Dictionary.load(runtime.dict_train(samples, target_size))
