"""Multi-device scale-out on ``torch.distributed``: the port of
``zxc_tpu.parallel``. ``sharding`` holds the sharded decode and encode,
``launch`` starts rank processes of a function of this package, and
``jobs`` is a rank-side runner of sharded calls."""
from .sharding import (make_mesh, decode_plan_sharded, decode_plan_dp_sp,  # noqa: F401
                       compress_sharded, encode_blocks_sharded,
                       dp_sp_kernel)
