"""`python -m spacetime_tpu_torch ...`: see cli.py."""

import sys

from .cli import main

sys.exit(main())
