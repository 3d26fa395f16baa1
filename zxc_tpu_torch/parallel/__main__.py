"""A rank of ``parallel.launch``: ``python -m zxc_tpu_torch.parallel``."""
import sys

from .launch import rank_main

rank_main(sys.argv[1:])
