"""Published peaks of the cards the benchmark knows, by the name that
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part,
at the full power limit of 700 W). The codec does no floating-point
work, so only the memory bandwidth is read."""
from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12}

PEAKS = {
    "NVIDIA H100 80GB HBM3": H100_SXM,
}


def lookup(kind: str) -> dict | None:
    return PEAKS.get(kind)
