"""zxc_tpu_torch: the PyTorch/CUDA port of zxc_tpu.

It imports torch and numpy, never jax and nothing of the ``zxc_tpu``
package: the host layers it needs (constants, errors, format readers, the
host codec, the native runtime) are its own copies.

Public API parity map (reference include/ -> here), the names of
``zxc_tpu``'s public API:
  zxc_buffer.h   one-shot:  compress / decompress / compress_bound /
                 get_decompressed_size / get_dict_id (``codec.frame``,
                 the native encoder and decoder)
  zxc_buffer.h   contexts:  Cctx / Dctx  (``context``)
  zxc_buffer.h   in place:  decompress_inplace / decompress_inplace_bound
  zxc_stream.h   streaming: stream_compress / stream_decompress (the push
                 streams over a buffer), compress_file / decompress_file /
                 stream_get_decompressed_size (``codec.stream``, the
                 multi-threaded file pipeline)
  zxc_pstream.h  push:      CStream / DStream  (``codec.pstream``)
  zxc_seekable.h            Seekable / is_seekable  (``codec.seekable``)
  zxc_dict.h                Dictionary / train_dict / train_dict_huf /
                            dict_train  (``codec.dict_train``)
  zxc_error.h               ZxcError / error_name / ERROR_*
The host surfaces encode through the host block encoder
(``codec.block_encode``) and decode through the native library; without
it they raise.

The device surfaces run on the card unless the caller passes
``device="cpu"``, which runs the kernels' plain PyTorch versions:
``decompress_e2e`` (cold, or with a ``.zxh`` hint from ``write_hints``),
``ops.decompress`` (the expansion route by default, the serial copy
engines and the attic kernel on request),
``codec.seekable.Seekable.decompress_range_device``,
``ops.compress_device`` (device encode) and ``Dctx(device=True)``, a
reusable context over ``ops.decompress``. ``ops.decompress(...,
device_entropy=True)`` also decodes the PivCo literal sections on the
device (``ops.pivco_device``). ``profiling`` holds the program's spans
and counters: ``span(name, args)`` and ``count(name, n)`` record into the
collector of the calling thread (one context variable; ``collect_phases``
installs one) and, where a profiler records the thread, open the range
``zxc.<name>``, so that a ``torch.profiler`` trace (``trace``) shows
``compress_device``'s calls, dispatch groups, issue, readback and
emission beside the card's kernels and copies; without a collector a
span costs one lookup. ``ops.decompress`` adds its phases to the
collector; ``entry.entry()`` is a compile-and-run check of the batched
expansion.

``parallel`` shards the decode and the encode over ranks of
``torch.distributed`` (``make_mesh``, ``decode_plan_sharded``,
``decode_plan_dp_sp``, ``dp_sp_kernel``, ``encode_blocks_sharded``,
``compress_sharded``); ``parallel.launch`` starts the rank processes,
and ``entry.dryrun_multichip(n)`` runs one sharded decode and encode
over ``n`` of them (NCCL on the cards, gloo with ``device="cpu"``).

The command line is ``python -m zxc_tpu_torch`` (``cli``), the JAX
package's ``zxc`` CLI with ``--device`` on the card.
"""
from . import constants  # noqa: F401
from .errors import ZxcError, error_name  # noqa: F401
from .errors import *  # noqa: F401,F403
from .codec.frame import (compress, decompress, get_decompressed_size,  # noqa: F401
                          get_dict_id, EncodeOpts, DecodeOpts)
from .constants import compress_bound, compress_block_bound  # noqa: F401
from .context import Cctx, Dctx  # noqa: F401
from .codec.pstream import (CStream, DStream, stream_compress,  # noqa: F401
                            stream_decompress)
from .codec.stream import (compress_file, decompress_file,  # noqa: F401
                           stream_get_decompressed_size)
from .codec.frame import (decompress_inplace,  # noqa: F401
                          decompress_inplace_bound)
from .codec.seekable import Seekable, is_seekable  # noqa: F401
from .format.dictionary import Dictionary  # noqa: F401
from .codec.dict_train import train_dict, train_dict_huf, dict_train  # noqa: F401
from .ops.device_pipeline import decompress_e2e  # noqa: F401
from .ops.hints import write_hints, HintFile  # noqa: F401
from . import ops  # noqa: F401
from .codec import seekable  # noqa: F401
from . import profiling  # noqa: F401

__version__ = "0.1.0"
FORMAT_VERSION = constants.FORMAT_VERSION
