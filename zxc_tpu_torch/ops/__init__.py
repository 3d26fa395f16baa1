"""Device paths of the PyTorch port. Decode: the copy-engine kernels
(``copy_engine``), the end-to-end pipeline with its hint path
(``device_pipeline``, ``hints``) and ``decompress`` (``batch``) with its
routes: the expansion as tensor ops (``expand``, the default), the serial
copy engines (``serial``) and the attic's piece-serial kernel
(``attic``). Encode: ``compress_device`` (``encode``) with the LCP and
parse-walk kernels (``encode_kernels``)."""
from .device_pipeline import decompress_e2e, walk_frame  # noqa: F401
from .hints import write_hints, HintFile  # noqa: F401
from .batch import decompress, decode_plan_device, plan_frame  # noqa: F401
from .encode import (compress_device, encode_chunk_device,  # noqa: F401
                     find_matches_device, find_matches_device_lcp,
                     find_matches_device_lcp_batch, parse_device,
                     parse_compact_device, parse_compact_walk)
