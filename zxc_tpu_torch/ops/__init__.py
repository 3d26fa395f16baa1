"""Device decode of the PyTorch port: the copy-engine kernels
(``copy_engine``) and the end-to-end pipeline (``device_pipeline``)."""
from .device_pipeline import decompress_e2e, walk_frame  # noqa: F401
