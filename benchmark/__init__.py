"""The benchmark of spacetime_tpu_torch: cells of a configuration and a
traffic mix, run one at a time by `python -m benchmark.run` (see run.py).
Imports nothing at import time."""
