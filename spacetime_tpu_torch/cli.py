"""Command-line runner of the port: headless frames, PNG dumps, the live
view, stats, checkpoints.

    python -m spacetime_tpu_torch --config flagship_1080p --frames 200
    python -m spacetime_tpu_torch --config single_blob --frames 30 --mode points --cpu
    python -m spacetime_tpu_torch --config png_demo --frames 60 --out frames --every 10
    python -m spacetime_tpu_torch --config flagship_1080p --frames 100000 --serve 8080 --realtime
    python -m spacetime_tpu_torch --config accelerated_camera --frames 60 --mode retina
    python -m spacetime_tpu_torch --config conical_defect --frames 200 --stats
    python -m spacetime_tpu_torch --config btz_hole --frames 200 --stats

Counterpart of `spacetime_tpu/cli.py`, with its flag names.  It runs on
CUDA device 0 and raises when CUDA is absent; only `--cpu` runs on the CPU
(the plain-torch versions of the kernels).  With --stats it prints the
stats summary as JSON (with the drop counters summed over the run, the
CUDA graphs' counts and, on a fused run, the per-stage times of
`Engine.profile_stages`), else one line.  Frames run fused (CUDA graphs on
the card) unless --stage-timing asks for eager frames with per-stage
times; the retina mode's frames always run eagerly, as in the JAX package.
The btz mode needs a config with a hole (`btz_hole`, `btz_reflected`,
`btz_spinning`, `btz_extremal`, `btz_photon_ring`).

`--out DIR` writes every `--every`-th frame as `frame_%08d.png` through
utils/framesink.py (raw frames); `--serve PORT` serves the live view at
http://ADDR:PORT/ (utils/streamsink.py; 0 = any free port; the URL, with
`?t=<token>` on a non-loopback `--serve-bind`, goes to stderr) with the
stats panel unless `--no-overlay`, and the keys the page posts steer the
Engine (viewer.apply_key; `q` ends the run); `--realtime` paces frames to
the live max_fps.  Both sinks are sized from the first frame, and both are
closed before `--save` writes its checkpoint.
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
    ap.add_argument("--out", default=None, help="directory for PNG frames")
    ap.add_argument("--every", type=int, default=1, help="dump every Nth frame")
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
    ap.add_argument("--realtime", action="store_true",
                    help="pace frames to the live max_fps (reference: main.rs:78-83)")
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="live MJPEG view at http://ADDR:PORT/ (0 = any port)")
    ap.add_argument("--serve-bind", default="127.0.0.1", metavar="ADDR",
                    help="bind address for --serve (default loopback; a non-loopback "
                         "address gets a key token)")
    ap.add_argument("--overlay", action=argparse.BooleanOptionalAction, default=True,
                    help="draw the stats panel on served frames (PNG dumps stay raw)")
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


class Sinks:
    """The frame sinks that `args` asks for (--out, --serve), made at the
    first frame written, from its size (a retina strip differs from the
    config's W x H)."""

    def __init__(self, args, engine):
        self.args, self.engine = args, engine
        self.frames = None  # utils.framesink.FrameSink
        self.stream = None  # utils.streamsink.StreamSink

    def __call__(self, i: int, img) -> None:
        args = self.args
        if (args.out is None and args.serve is None) or i % args.every:
            return
        from .utils.framesink import quantize

        arr = quantize(img)  # uint8 on the device, then to the host
        if args.out is not None:
            if self.frames is None:
                from .utils.framesink import FrameSink

                self.frames = FrameSink(args.out, arr.shape[1], arr.shape[0])
                print(f"# PNG frames: {args.out} "
                      f"({'native' if self.frames.native else 'python'})", file=sys.stderr)
            self.frames.submit(i, arr)
        if args.serve is not None:
            if self.stream is None:
                from .utils.streamsink import StreamSink

                self.stream = StreamSink(args.serve, arr.shape[1], arr.shape[0],
                                         bind=args.serve_bind)
                # /key steers the Engine: a non-loopback URL carries the token
                tok = f"?t={self.stream.key_token}" if self.stream.key_token else ""
                print(f"# live view: http://{args.serve_bind}:{self.stream.port}/{tok} "
                      f"({'native' if self.stream.native else 'python'})", file=sys.stderr)
            if args.overlay:
                from .utils.overlay import overlay_stats

                arr = overlay_stats(arr, self.engine)
            self.stream.submit(arr)

    def poll_keys(self) -> list:
        """The key events the live view's clients posted (none before the
        stream exists)."""
        return self.stream.poll_keys() if self.stream is not None else []

    def paths(self) -> dict:
        """Which path each open sink took: 'native' or 'python'."""
        return {name: "native" if sink.native else "python"
                for name, sink in (("out", self.frames), ("serve", self.stream))
                if sink is not None}

    def close(self) -> None:
        for sink in (self.frames, self.stream):
            if sink is not None:
                sink.close()


def drive(eng, args, sinks: Sinks, on_frame=None) -> dict:
    """Run `args.frames` frames of `eng` through `sinks`, steered by the live
    view's keys when serving and paced by --realtime; then `profile_stages`
    for --stats on a fused run, close the sinks and write --save.
    `on_frame(i, img)`, if given, sees each frame after the sinks.  Returns
    the stats summary, with `sinks` (the path each sink took)."""
    def each(i, img):
        sinks(i, img)
        if on_frame is not None:
            on_frame(i, img)

    try:
        summary = eng.run(args.frames, on_frame=each, realtime=args.realtime,
                          key_source=sinks.poll_keys if args.serve is not None else None)
        if args.stats and eng._can_fuse():
            # fused frames carry no stage times: the per-stage device times of
            # a short profiled run of the same graphs
            eng.profile_stages()
            summary = {**eng.stats.summary(), "drops": summary["drops"]}
        summary["sinks"] = sinks.paths()
    finally:
        sinks.close()
    if args.save:
        eng.save_checkpoint(args.save)
    return summary


def run(argv=None, on_frame=None):
    """Parse `argv`, build the Engine and run it (see `drive`).  Returns
    (engine, last image, stats summary)."""
    eng, args = build(argv)
    last = {}

    def watch(i, img):
        last["img"] = img
        if on_frame is not None:
            on_frame(i, img)

    summary = drive(eng, args, Sinks(args, eng), watch)
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
