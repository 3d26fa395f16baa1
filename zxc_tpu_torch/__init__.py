"""zxc_tpu_torch: the PyTorch/CUDA port of zxc_tpu's device paths.

It imports torch and numpy, never jax and nothing of the ``zxc_tpu``
package: the host layers it needs (constants, errors, format readers, the
native runtime) are its own copies. The entry point runs on the card
unless the caller passes ``device="cpu"``, which runs the kernels' plain
PyTorch versions: ``decompress_e2e`` (cold, or with a ``.zxh`` hint from
``write_hints``), ``ops.decompress`` (the expansion route by default,
the serial copy engines and the attic kernel on request),
``codec.seekable.Seekable.decompress_range_device``,
``ops.compress_device`` (device encode) and ``Dctx(device=True)``, a
reusable context over ``ops.decompress``. ``ops.decompress(...,
device_entropy=True)`` also decodes the PivCo literal sections on the
device (``ops.pivco_device``). ``profiling`` collects ``ops.decompress``'s
phases (``collect_phases``) and records ``torch.profiler`` traces
(``trace``); ``entry.entry()`` is a compile-and-run check of the batched
expansion. ``Dictionary`` reads and writes ``.zxd`` dictionaries and
``dict_train`` trains one (native trainer).

``parallel`` shards the decode and the encode over ranks of
``torch.distributed`` (``make_mesh``, ``decode_plan_sharded``,
``decode_plan_dp_sp``, ``dp_sp_kernel``, ``encode_blocks_sharded``,
``compress_sharded``); ``parallel.launch`` starts the rank processes,
and ``entry.dryrun_multichip(n)`` runs one sharded decode and encode
over ``n`` of them (NCCL on the cards, gloo with ``device="cpu"``).

The command line is ``python -m zxc_tpu_torch`` (``cli``), the JAX
package's ``zxc`` CLI with ``--device`` on the card.
"""
from .errors import ZxcError  # noqa: F401
from .codec.frame import DecodeOpts, EncodeOpts, compress  # noqa: F401
from .format.dictionary import Dictionary  # noqa: F401
from .codec.dict_train import dict_train  # noqa: F401
from .ops.device_pipeline import decompress_e2e  # noqa: F401
from .ops.hints import write_hints, HintFile  # noqa: F401
from . import ops  # noqa: F401
from .codec import seekable  # noqa: F401
from .context import Dctx  # noqa: F401
from . import profiling  # noqa: F401
