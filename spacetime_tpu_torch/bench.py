"""The port's headline benchmark on one CUDA card: the fused frame of
`bench.py`'s main mode (bench.py:34-228), one RK4 step of the
10,050-particle two-disc lattice scene, one push into a T = 1024 worldline
ring and one 1920x1080 opaque retarded render with Doppler and beaming
(headline.build), replayed as CUDA graphs (fused.py).

    python3 -m spacetime_tpu_torch.bench
    python3 -m spacetime_tpu_torch.bench --scene refdemo

`--scene refdemo` times the reference demo's retarded frame instead
(headline.build_refdemo: 116,178 active particles at capacity 149,248, a
T=1024 ring of 4.9 GB, 1920x1080 with `splat_cells=4`, band 4, rank
compaction to 3 crossings a particle and bin_capacity 128; see
headline.refdemo_params) by the same protocol; its row adds `scene` and
`segment_dropped` (also among `drops`).

Prints ONE JSON line.  Without CUDA it exits 1 and prints no result: a CPU
run gives no device time.  The row holds:

  * `value` (fps): 1 / the median, over REPEATS repeats, of the mean wall
    time of TIMED_FRAMES back-to-back frames (host clock, the device
    synchronized at the end of each repeat).  Each repeat starts from the
    same built state and runs WARMUP_FRAMES frames first (the very first
    captures the graphs), so every repeat times the same frames 9-58 that
    bench.py times, before the discs meet; `fps_min`, `fps_max` and
    `frame_ms` (each repeat's mean) give the spread, since the wall time of
    one tree moves between runs;
  * `vs_baseline`: fps / 60, the 60 fps north star;
  * `steps_per_s`: physics only, STEPS steps of a graph of the step stage
    alone, on a copy of the state; `mrays_per_s`: width x height x fps;
  * `device_ms_measured`: device time per frame summed over the kernels,
    copies and fills of the replayed graphs, and `device_busy_ms` the union
    of their intervals, from a torch.profiler trace of PROFILE_FRAMES
    frames; `stage_ms_measured`: that device time by stage (step,
    worldline, render);
  * `drops`: every step and render drop counter (fused.DROP_FIELDS)
    summed over the timed frames; any that is not 0 fails the run (exit 1,
    after the line);
  * `graphs`: captures, replays and the captures' host seconds; `card`:
    name and power limit.

Left out of the JAX bench's keys: `flops_per_frame`, `hbm_bytes_per_frame`,
`mfu_pct` and `hbm_util_pct` come from XLA's static cost analysis, which
PyTorch has no counterpart of, and `hbm_util_measured_pct` /
`hbm_bytes_measured` from the TPU profiler's byte counts, which the torch
profiler does not report.  `--record`, `--replay` and `--diff` wait for the
replay module.
An Engine config's row comes from the CLI: `python3 -m spacetime_tpu_torch
--config NAME --frames N --stats [--stage-timing]` prints its stats
summary, with the drop counters summed over the run and the graph counts.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

WARMUP_FRAMES = 8
TIMED_FRAMES = 50
REPEATS = 5
STEPS = 100
PROFILE_FRAMES = 5
TARGET_FPS = 60.0
METRIC = "fused 10k-particle step + 1080p retarded-time render"
REFDEMO_METRIC = "fused 116k-particle step + 1080p retarded-time render (reference demo)"


def time_frames(frame, sync, reset=lambda: None, frames: int = TIMED_FRAMES,
                repeats: int = REPEATS, warmup: int = WARMUP_FRAMES):
    """`repeats` times: `reset()` (back to the start state), `warmup`
    untimed calls of `frame()` (a fused.FusedFrame, or anything returning
    (image, counters)), then `frames` calls timed on the host clock and
    ended by `sync()`.  Returns (the mean seconds a frame of each repeat,
    the counters summed over the timed frames)."""
    per_frame, counters = [], []
    for _ in range(repeats):
        reset()
        for _ in range(warmup):
            frame()
        sync()
        t0 = time.perf_counter()
        for _ in range(frames):
            counters.append(frame()[1])
        sync()
        per_frame.append((time.perf_counter() - t0) / frames)
    return per_frame, torch.stack(counters).sum(dim=0)


def time_steps(step, sync, steps: int = STEPS) -> float:
    """Steps per second of `step()` over `steps` calls, after one."""
    step()
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    sync()
    return steps / (time.perf_counter() - t0)


def report(per_frame, steps_per_s: float, width: int, height: int, drops: dict,
           measured: dict, graphs: dict, card: str) -> dict:
    """The JSON row (see the module docstring) from the measurements."""
    fps = [1.0 / s for s in per_frame]
    med = statistics.median(fps)
    stages = measured.get("stages")
    return {
        "metric": METRIC,
        "value": med,
        "unit": "fps",
        "vs_baseline": med / TARGET_FPS,
        "fps_min": min(fps),
        "fps_max": max(fps),
        "frame_ms": [s * 1e3 for s in per_frame],
        "repeats": len(per_frame),
        "steps_per_s": steps_per_s,
        "mrays_per_s": width * height * med / 1e6,
        "device_ms_measured": measured["device_s"] * 1e3 if measured else None,
        "device_busy_ms": measured["busy_s"] * 1e3 if measured else None,
        "stage_ms_measured": {k: v * 1e3 for k, v in stages.items()} if stages else None,
        "drops": drops,
        "graphs": graphs,
        "card": card,
    }


def headline_frames(device, scene: str = "headline"):
    """(frame, reset, step_only, width, height): the headline frame (or,
    with scene "refdemo", the reference demo's) as a fused.FusedFrame over
    headline.build's state, a function that puts that state back as built,
    and a FusedFrame of the step stage alone over a copy of it."""
    from . import fused, headline

    build = headline.build_refdemo if scene == "refdemo" else headline.build
    model, particles, objects, buf, cam, params = build(device)
    state = fused.new_state(particles, buf, cam, 0.0)
    built = fused.copy_state(state)
    frame = fused.FusedFrame(
        fused.frame_stages(model, None, state, objects, headline.WIDTH, headline.HEIGHT,
                           params, "retarded", model.params.h), fused.schedule(1), device)
    solo = fused.copy_state(state)
    step_only = fused.FusedFrame(
        fused.frame_stages(model, None, solo, objects, headline.WIDTH, headline.HEIGHT,
                           params, "retarded", model.params.h), [("step", "step")], device)
    return (frame, lambda: fused.restore(state, built), step_only, headline.WIDTH,
            headline.HEIGHT)


def run_headline(scene: str = "headline") -> dict:
    """The headline row (or the refdemo row) on CUDA device 0 (see the
    module docstring)."""
    from . import device as device_mod
    from . import fused
    from .utils import profiling

    device = device_mod.resolve(None)
    sync = torch.cuda.synchronize
    frame, reset, step_only, width, height = headline_frames(device, scene)
    per_frame, counters = time_frames(frame, sync, reset)
    drops = fused.drops_of(counters, frame.stages["render"])
    steps_per_s = time_steps(step_only, sync)

    def traced():
        for _ in range(PROFILE_FRAMES):
            frame()
        sync()

    measured = profiling.measured_roofline(traced, PROFILE_FRAMES)
    row = report(per_frame, steps_per_s, width, height, drops, measured, dict(frame.stats),
                 device_mod.card_line())
    if scene == "refdemo":
        row = {**row, "metric": REFDEMO_METRIC, "scene": scene,
               "segment_dropped": drops["segment_dropped"]}
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacetime_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="headline", choices=["headline", "refdemo"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("spacetime_tpu_torch.bench: CUDA is not available; the bench measures an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    row = run_headline(args.scene)
    print(json.dumps(row))
    if any(row["drops"].values()):
        print(f"nonzero drop counters: {row['drops']}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
