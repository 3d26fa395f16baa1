"""Device decode of the PyTorch port: the copy-engine kernels
(``copy_engine``), the end-to-end pipeline with its hint path
(``device_pipeline``, ``hints``) and the serial route (``batch``,
``serial``)."""
from .device_pipeline import decompress_e2e, walk_frame  # noqa: F401
from .hints import write_hints, HintFile  # noqa: F401
from .batch import decompress, plan_frame  # noqa: F401
