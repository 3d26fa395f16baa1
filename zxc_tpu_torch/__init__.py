"""zxc_tpu_torch: the PyTorch/CUDA port of zxc_tpu's device decode path.

It imports torch and numpy, never jax and nothing of the ``zxc_tpu``
package: the host layers it needs (constants, errors, format readers, the
native runtime) are its own copies. The entry point runs on the card
unless the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions.
"""
from .errors import ZxcError  # noqa: F401
from .codec.frame import DecodeOpts, EncodeOpts, compress  # noqa: F401
from .ops.device_pipeline import decompress_e2e  # noqa: F401
