"""Error codes mirroring the reference ABI (include/zxc_error.h).

The Python API raises :class:`ZxcError`; the numeric codes are preserved so
bindings and differential tests can compare against the C reference.
The PyTorch port keeps its own copy of ``zxc_tpu.errors`` (same codes).
"""
from __future__ import annotations

OK = 0
ERROR_MEMORY = -1
ERROR_DST_TOO_SMALL = -2
ERROR_SRC_TOO_SMALL = -3
ERROR_BAD_MAGIC = -4
ERROR_BAD_VERSION = -5
ERROR_BAD_HEADER = -6
ERROR_BAD_CHECKSUM = -7
ERROR_CORRUPT_DATA = -8
ERROR_BAD_OFFSET = -9
ERROR_OVERFLOW = -10
ERROR_IO = -11
ERROR_NULL_INPUT = -12
ERROR_BAD_BLOCK_TYPE = -13
ERROR_BAD_BLOCK_SIZE = -14
ERROR_DICT_REQUIRED = -15
ERROR_DICT_MISMATCH = -16
ERROR_DICT_TOO_LARGE = -17
ERROR_BAD_LEVEL = -18

_NAMES = {
    0: "ZXC_OK",
    -1: "ZXC_ERROR_MEMORY",
    -2: "ZXC_ERROR_DST_TOO_SMALL",
    -3: "ZXC_ERROR_SRC_TOO_SMALL",
    -4: "ZXC_ERROR_BAD_MAGIC",
    -5: "ZXC_ERROR_BAD_VERSION",
    -6: "ZXC_ERROR_BAD_HEADER",
    -7: "ZXC_ERROR_BAD_CHECKSUM",
    -8: "ZXC_ERROR_CORRUPT_DATA",
    -9: "ZXC_ERROR_BAD_OFFSET",
    -10: "ZXC_ERROR_OVERFLOW",
    -11: "ZXC_ERROR_IO",
    -12: "ZXC_ERROR_NULL_INPUT",
    -13: "ZXC_ERROR_BAD_BLOCK_TYPE",
    -14: "ZXC_ERROR_BAD_BLOCK_SIZE",
    -15: "ZXC_ERROR_DICT_REQUIRED",
    -16: "ZXC_ERROR_DICT_MISMATCH",
    -17: "ZXC_ERROR_DICT_TOO_LARGE",
    -18: "ZXC_ERROR_BAD_LEVEL",
}


def error_name(code: int) -> str:
    return _NAMES.get(code, f"ZXC_ERROR_UNKNOWN({code})")


class ZxcError(Exception):
    """Raised by the Python API on any decode/encode failure."""

    def __init__(self, code: int, message: str = ""):
        self.code = code
        super().__init__(f"{error_name(code)}{': ' + message if message else ''}")
