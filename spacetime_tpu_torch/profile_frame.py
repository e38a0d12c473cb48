"""Where the device time of the headline frame goes, on one CUDA card.

    python3 -m spacetime_tpu_torch.profile_frame
    python3 -m spacetime_tpu_torch.profile_frame --scene refdemo
    python3 -m spacetime_tpu_torch.profile_frame --scene conical_defect
    python3 -m spacetime_tpu_torch.profile_frame --scene btz_hole

`--scene refdemo` profiles the reference demo's retarded frame
(headline.build_refdemo) instead, by the same protocol.  `--scene
conical_defect` or `--scene selfgravity` profiles that named config's
Engine frame: its eager frames are the Engine's stage-timing frames (stages
step / worldline / render), its graph frames the Engine's fused frames
from the state the eager ones left, and the conical render splits into the
band search of each route (route 1, the Euclidean chord, on the band
kernel; route 2 of each defect on the plain sweep), the pair compaction,
the view tables, the route-2 images, the retina march (one per route), the
route pass and, for matter-sourced defects, the sourced defects.  `--scene
btz_hole` or `--scene btz_extremal` profiles that BTZ config's Engine
frame the same way, its render split into the band sweep + pairs of each
route (every route on the plain sweep), the pair compaction, the view
tables, the bearing retina, the routes' optics at every pixel and the
route pass (over its blocks of view cells).  A config on the exact
rotating-metric solver (`btz_exact_spin`, as btz_extremal) makes a frame of
over half a million launches: it warms EXACT_SOLVER_FRAMES[0] frames and
traces EXACT_SOLVER_FRAMES[1].

Runs the headline frame (headline.py) eagerly WARM_FRAMES times, which
takes the discs into contact, then PROFILE_FRAMES frames under
`torch.profiler`.  Every device kernel, memcpy and memset of that trace is
attributed (utils/profiling.attribute), through the correlation id of its
launch, to the innermost named range (the program's sub-stage spans,
`utils/profiling.spanned` on the functions of ops/, inside the stages step /
push / render) that was open on the host when it was launched.  Then the
same frame, from the state the eager frames left, as the fused frame
(fused.py: one CUDA graph a stage, captured at its first frame):
PROFILE_FRAMES traced, where a graph's kernels fall in the stage range its
replay ran in (the sub-stage ranges do not survive into a graph).  It
prints, per frame and for each of the two: the device time and launches
per range and per kind of kernel, and the device's busy time (the union of
the device intervals).  Frame times are the benchmark's
(`python3 -m benchmark.run`).
"""

from __future__ import annotations

import argparse
import sys

import torch

from .utils.profiling import attribute, span, traced_events

WARM_FRAMES, PROFILE_FRAMES = 185, 5
EXACT_SOLVER_FRAMES = (10, 1)
ENGINE_SCENES = ("conical_defect", "selfgravity", "btz_hole", "btz_extremal")


def report(title: str, res: dict) -> None:
    print(f"{title}:")
    for name, table in (("range", res["by_range"]), ("kind", res["by_kind"])):
        print(f"{'device time by ' + name:<28} {'ms/frame':>9} {'launches':>9} {'share':>7}")
        total = sum(v[0] for v in table.values())
        for key, (ms, n) in sorted(table.items(), key=lambda kv: -kv[1][0]):
            print(f"  {key:<26} {ms:9.4f} {n:9.1f} {ms / total:7.1%}")
        print(f"  {'total':<26} {total:9.4f} {sum(v[1] for v in table.values()):9.1f}")
    print(f"device busy {res['busy_ms']:.4f} ms per frame (union of device intervals)")


def _profile(title: str, run_one, profile_frames: int = PROFILE_FRAMES) -> None:
    """`profile_frames` frames of `run_one` traced, and the report."""
    from . import kernels

    def traced():
        for _ in range(profile_frames):
            run_one()
        torch.cuda.synchronize()

    res = attribute(traced_events(traced, kernels.BUILD_DIR), profile_frames)
    if not res["by_range"]:
        raise RuntimeError(f"{title}: the trace holds no device activity")
    report(title, res)


def profile_engine(name: str, device) -> int:
    """The named config's Engine frame: WARM_FRAMES stage-timing (eager)
    frames, then the eager and the fused frames profiled in turn, with the
    adaptation frozen where the warm-up left it (every timed frame runs at
    one render-params key); a config on the exact solver by
    EXACT_SOLVER_FRAMES instead."""
    import dataclasses

    from .engine import Engine
    from .utils.config import get_config

    cfg = get_config(name)
    warm, prof = (EXACT_SOLVER_FRAMES if cfg.render.btz_exact_spin
                  else (WARM_FRAMES, PROFILE_FRAMES))
    eng = Engine(dataclasses.replace(cfg, stage_timing=True), device=device)
    for _ in range(warm):
        eng.run_frame()
    boosts = {f: getattr(eng, f) for f in eng._ADAPT_FIELDS if getattr(eng, f)}
    print(f"{name}: boosts after {warm} frames {boosts}, frozen from here on")
    eng.config = dataclasses.replace(cfg, stage_timing=True, diag_every=0)
    _profile(f"{name}: eager frames {warm + 1}-{warm + prof}", eng.run_frame, prof)
    eng.config = dataclasses.replace(cfg, diag_every=0)  # fused from here on
    eng.run_frame()  # the eager frame the capture follows, and the capture
    _profile(f"{name}: graph frames (CUDA graphs; {eng.graph_stats})", eng.run_frame, prof)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacetime_tpu_torch.profile_frame", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="headline",
                    choices=["headline", "refdemo", *ENGINE_SCENES])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frame: CUDA is not available; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from . import fused, headline, kernels
    from .ops import raytrace
    from .ops import worldline as wl

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kernels.library()
    if args.scene in ENGINE_SCENES:
        return profile_engine(args.scene, device)
    build = headline.build_refdemo if args.scene == "refdemo" else headline.build
    model, p, objects, buf, cam, params = build(device)
    h = model.params.h

    def frame(p, i):
        with span("step"):
            p, _ = model.step(p)
        with span("push"):
            wl.push_frame(buf, p, h * (i + 1))
        with span("render"):
            raytrace.render_retarded(buf, p.object_index, objects, cam, headline.WIDTH,
                                     headline.HEIGHT, params, planar=True,
                                     boundary=wl.boundary_mask(p))
        return p

    i = 0
    for _ in range(WARM_FRAMES):
        p, i = frame(p, i), i + 1

    state = {"p": p, "i": i}

    def eager_one():
        state["p"], state["i"] = frame(state["p"], state["i"]), state["i"] + 1

    first = WARM_FRAMES + 1
    _profile(f"eager frames {first}-{first + PROFILE_FRAMES - 1}", eager_one)

    # the fused frame from the eager frames' last state and clock
    fs = fused.new_state(state["p"], buf, cam, h * state["i"])
    graph = fused.FusedFrame(
        fused.frame_stages(model, None, fs, objects, headline.WIDTH, headline.HEIGHT, params,
                           "retarded", h), fused.schedule(1), device)
    graph()  # the eager frame the capture follows, and the capture
    _profile(f"graph frames (CUDA graphs; {graph.stats['captures']} capture)", graph)
    return 0


if __name__ == "__main__":
    sys.exit(main())
