"""Run one cell of the benchmark once:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics with
`--trace 0`, its per-layer metrics with `--trace 1`), `device` and, with
`--trace 1`, `breakdown`; then `checked`, each compared number beside its
limit, which the last lines of standard error repeat.

Without CUDA, with fewer cards than the cell asks for, or with a JAX
module or the JAX package loaded once the window has closed, it prints no
result and exits with 2.  `--control` puts the bfloat16 reference in the
program's place in the check (see check.py); the benchmark's own runs
never pass it.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import harness, spec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    harness.keep_caches_inside(str(spec.ROOT))
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", control=args.control)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 2
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
