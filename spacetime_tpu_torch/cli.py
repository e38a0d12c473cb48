"""Command-line runner of the port: headless frames, stats, checkpoints.

    python -m spacetime_tpu_torch --config flagship_1080p --frames 200
    python -m spacetime_tpu_torch --config single_blob --frames 30 --mode points --cpu
    python -m spacetime_tpu_torch --config accelerated_camera --frames 60 --mode retina
    python -m spacetime_tpu_torch --config conical_defect --frames 200 --stats
    python -m spacetime_tpu_torch --config worldline3d --frames 100 --stats
    python -m spacetime_tpu_torch --config btz_hole --frames 200 --stats

Counterpart of `spacetime_tpu/cli.py`, with its flag names.  It runs on
CUDA device 0 and raises when CUDA is absent; only `--cpu` runs on the CPU
(the plain-torch versions of the kernels).  With --stats it prints the
stats summary as JSON (with the drop counters summed over the run and
the CUDA graphs' counts), else one line.  Frames run fused (CUDA graphs on
the card) unless --stage-timing asks for eager frames with per-stage
times; the retina mode's frames always run eagerly, as in the JAX package.
The btz mode needs a config with a hole (`btz_hole`, `btz_reflected`,
`btz_spinning`, `btz_extremal`, `btz_photon_ring`).  Not accepted yet: --out, --every,
--serve, --serve-bind, --overlay and --realtime (they wait for the frame
and stream sinks).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="spacetime_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="single_blob", help="named config (utils/config.py)")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--mode", default=None, choices=["retarded", "instant", "points", "retina",
                                                     "conical", "btz", "worldline3d"])
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--stats", action="store_true", help="print the stats summary JSON")
    ap.add_argument("--stage-timing", action="store_true",
                    help="per-stage timing (eager frames, CUDA-event stage times)")
    ap.add_argument("--save", default=None, help="checkpoint path to write")
    ap.add_argument("--load", default=None, help="checkpoint path to resume")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    return ap


def build(argv=None):
    """Parse `argv` and build the Engine it names (resumed from --load).
    Returns (engine, parsed arguments)."""
    args = _parser().parse_args(argv)
    from . import device as device_mod
    from .engine import Engine

    device = device_mod.resolve("cpu" if args.cpu else None)
    from .utils.config import get_config

    cfg = get_config(args.config)
    overrides = {k: v for k, v in (("render_mode", args.mode), ("width", args.width),
                                   ("height", args.height),
                                   ("stage_timing", args.stage_timing)) if v}
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    eng = Engine(cfg, device=device)
    if args.load:
        eng.load_checkpoint(args.load)
    return eng, args


def run(argv=None):
    """Parse `argv`, build the Engine and run its frames.  Returns
    (engine, last image, stats summary)."""
    eng, args = build(argv)
    last = {}
    summary = eng.run(args.frames, on_frame=lambda i, img: last.update(img=img))
    if args.save:
        eng.save_checkpoint(args.save)
    return eng, last.get("img"), summary


def main(argv=None) -> int:
    eng, _, summary = run(argv)
    if _parser().parse_args(argv).stats:
        print(json.dumps({**summary, "graphs": eng.graph_stats}, indent=2))
    else:
        print(f"{eng.frame} frames of {eng.config.render_mode} on {eng.device}: "
              f"{summary['fps_avg']:.2f} fps (--stats for the summary JSON)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
