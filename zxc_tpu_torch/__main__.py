"""``python -m zxc_tpu_torch``: the port's zxc command line (``cli``)."""
import sys

from .cli import main

sys.exit(main())
