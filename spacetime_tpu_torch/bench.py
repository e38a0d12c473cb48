"""The port's headline benchmark on one CUDA card: the fused frame of
`bench.py`'s main mode (bench.py:34-228), one RK4 step of the
10,050-particle two-disc lattice scene, one push into a T = 1024 worldline
ring and one 1920x1080 opaque retarded render with Doppler and beaming
(headline.build), replayed as CUDA graphs (fused.py).

    python3 -m spacetime_tpu_torch.bench
    python3 -m spacetime_tpu_torch.bench --scene refdemo
    python3 -m spacetime_tpu_torch.bench --scene capacity [--frame]
    python3 -m spacetime_tpu_torch.bench --configs [NAME ...]
    python3 -m spacetime_tpu_torch.bench --record S.jsonl [--config NAME] [--frames N]
    python3 -m spacetime_tpu_torch.bench --replay S.jsonl
    python3 -m spacetime_tpu_torch.bench --diff A.perf.json B.perf.json [--threshold PCT]

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
profiler does not report.

`--scene capacity` is `tools/bench_1m.py`'s row at the reference's limit of
2^20 particles (headline.build_capacity): CAPACITY_STEPS physics steps
timed after one (steps/s, M particle-steps/s, the StepAux counters); with
`--frame`, the fused frame at 2^20 (T=128, 960x540) from the stepped
state with the ring prefilled again from it, as bench_1m does:
CAPACITY_WARMUP then CAPACITY_FRAMES timed frames, device ms by stage over
PROFILE_FRAMES traced frames, every drop counter and `pairs_used` against
`pair_budget`.

`--configs [NAME ...]` is `tools/bench_configs.py`'s table: each named
config's Engine (fused) on CUDA, CONFIG_WARMUP frames, then the best of
CONFIG_WINDOWS windows of CONFIG_FRAMES frames; a config whose first graph
frames take over SLOW_FRAME_S seconds (btz_extremal) takes SLOW_SCHEDULE
instead, and its row says so.  One JSON line a config: particles, size,
history, frame ms, fps, warm-up seconds, the drops summed over the windows.

`--record`, `--replay` and `--diff` are `bench.py`'s replay-driven A/B
harness (bench.py:231-377): `--record` runs `--frames` frames of `--config`
under `scripted_keys` with a utils.replay.ReplayRecorder, `--replay`
re-drives a fresh Engine with the recorded inputs (bit-exact on one card),
each writing SESSION.perf.json (frames, frame_avg_ms, fps_avg,
low_1pct_ms over the steady last half, config, backend); `--diff` prints
the deltas of two perf files and exits 0, 1 (frame time worse by more than
`--threshold` percent) or 2 (unknown: a frame time missing).
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
CAPACITY_STEPS = 30
CAPACITY_WARMUP = 3
CAPACITY_FRAMES = 15
CONFIG_WARMUP, CONFIG_FRAMES, CONFIG_WINDOWS = 100, 40, 3
SLOW_FRAME_S = 0.25
SLOW_SCHEDULE = (10, 3)  # warm-up frames, frames a window


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


def capacity_rows(frame: bool):
    """The capacity row on CUDA device 0 (see the module docstring), and
    the state it leaves: (row, fused.FrameState, objects, render params)."""
    from . import device as device_mod
    from . import fused, headline
    from .ops import worldline as wl
    from .ops.rk4 import StepAux
    from .utils import profiling

    device = device_mod.resolve(None)
    sync = torch.cuda.synchronize
    model, particles, objects, buf, cam, params = headline.build_capacity(device)
    n = int(particles.active.sum())
    state = fused.new_state(particles, buf, cam, 0.0)
    width, height = headline.CAPACITY_WIDTH, headline.CAPACITY_HEIGHT
    stages = fused.frame_stages(model, None, state, objects, width, height, params,
                                "retarded", model.params.h)
    steps_per_s = time_steps(fused.FusedFrame(stages, [("step", "step")], device), sync,
                             CAPACITY_STEPS)
    row = {"metric": "2^20-particle physics step", "particles": n,
           "capacity": particles.capacity, "steps_per_s": steps_per_s,
           "mparticle_steps_per_s": n * steps_per_s / 1e6,
           "step_aux": dict(zip(StepAux._fields, state.aux.tolist())),
           "card": device_mod.card_line()}
    if not frame:
        return row, state, objects, params
    # the frame from the stepped state, the ring prefilled again from it
    p = state.particles
    fused.commit(state.buf, wl.prefill_inertial(state.buf, p.pos, p.vel, p.active, 0.0,
                                                model.params.h))
    step_render = fused.FusedFrame(stages, fused.schedule(1), device)
    t0 = time.perf_counter()
    per_frame, counters = time_frames(step_render, sync, frames=CAPACITY_FRAMES, repeats=1,
                                      warmup=CAPACITY_WARMUP)
    render = step_render.stages["render"]

    def traced():
        for _ in range(PROFILE_FRAMES):
            step_render()
        sync()

    measured = profiling.measured_roofline(traced, PROFILE_FRAMES)
    diag = fused.unpack(step_render()[1], render)[1]  # one more frame's own counters
    row.update({
        "metric": "fused 2^20-particle step + 960x540 retarded-time render",
        "frame_ms": per_frame[0] * 1e3, "fps": 1.0 / per_frame[0],
        "warmup_and_timed_s": time.perf_counter() - t0,
        "width": width, "height": height, "history": state.buf.capacity,
        "device_ms_measured": measured["device_s"] * 1e3 if measured else None,
        "device_busy_ms": measured["busy_s"] * 1e3 if measured else None,
        "stage_ms_measured": ({k: v * 1e3 for k, v in measured["stages"].items()}
                              if measured else None),
        "drops": fused.drops_of(counters, render),
        "pairs_used_last": int(diag.pairs_used), "pair_budget": params.pair_budget,
        "bin_capacity": params.bin_capacity, "graphs": dict(step_render.stats)})
    return row, state, objects, params


def config_row(name: str, device=None) -> dict:
    """One named config's fused Engine frame (see the module docstring)."""
    from . import fused
    from .engine import Engine
    from .utils.config import get_config

    cfg = get_config(name)
    eng = Engine(cfg, device=device)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda" else lambda: None)
    t0 = time.perf_counter()
    probe = []
    for _ in range(5):  # the first frame captures; then graph frames
        t = time.perf_counter()
        eng.run_frame()
        sync()
        probe.append(time.perf_counter() - t)
    slow = statistics.median(probe[1:]) > SLOW_FRAME_S
    warm, timed = SLOW_SCHEDULE if slow else (CONFIG_WARMUP, CONFIG_FRAMES)
    for _ in range(warm - len(probe)):
        eng.run_frame()
    sync()
    warm_s = time.perf_counter() - t0
    best = float("inf")
    drops0 = eng._drops.clone()
    for _ in range(CONFIG_WINDOWS):
        t = time.perf_counter()
        for _ in range(timed):
            eng.run_frame()
        sync()
        best = min(best, (time.perf_counter() - t) / timed)
    return {"config": name, "particles": int(eng.particles.active.sum()),
            "width": cfg.width, "height": cfg.height, "history": cfg.history,
            "frame_ms": best * 1e3, "fps": 1.0 / best, "warmup_s": warm_s,
            "schedule": f"warm {warm}, best of {CONFIG_WINDOWS} x {timed}"
                        + (" (slow-frame schedule)" if slow else ""),
            "drops": dict(zip(fused.DROP_FIELDS, (eng._drops - drops0).tolist())),
            "graphs": dict(eng.graph_stats)}


# --- replay-driven A/B harness (bench.py:231-377) ---------------------------


def scripted_keys(i: int):
    """bench.py's deterministic session script: the key dict of frame `i`.
    (Its "d" names no controller key, so frames 0-9 pan nothing, as in the
    JAX bench; frames 10-19 zoom in.)"""
    if i < 10:
        return {"d": True}
    if i < 20:
        return {"z": True}
    return None


def perf_path(session: str) -> str:
    return session + ".perf.json"


def _perf(eng, times) -> dict:
    """The perf record of a session's frame times (the steady last half)."""
    import numpy as np

    steady = np.asarray(times[len(times) // 2:])
    return {
        "frames": len(times),
        "frame_avg_ms": float(steady.mean() * 1e3),
        "fps_avg": float(1.0 / max(steady.mean(), 1e-9)),
        "low_1pct_ms": float(np.sort(steady)[-max(1, len(steady) // 100):].mean() * 1e3),
        "config": eng.config.name,
        "backend": eng.device.type,
    }


def record_session(config: str, frames: int, path: str, device=None):
    """`frames` frames of the named config under scripted_keys, recorded to
    `path`; writes perf_path(path).  Returns (engine, perf, last image)."""
    from .engine import Engine
    from .utils import replay as replay_mod
    from .utils.config import get_config

    eng = Engine(get_config(config), device=device)
    times, img = [], None
    with replay_mod.ReplayRecorder(path, config=eng.config,
                                   meta={"config_name": eng.config.name}) as rec:
        eng.recorder = rec
        for i in range(frames):
            t0 = time.perf_counter()
            img = eng.run_frame(keys=scripted_keys(i))
            times.append(time.perf_counter() - t0)
        eng.recorder = None
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    perf = _perf(eng, times)
    with open(perf_path(path), "w") as f:
        json.dump(perf, f, indent=2)
    return eng, perf, img


def replay_session(path: str, device=None):
    """A fresh Engine of the session's config re-driven with its recorded
    inputs (utils.replay.replay_events); writes perf_path(path).  Returns
    (engine, perf, last image)."""
    from .engine import Engine
    from .utils import replay as replay_mod
    from .utils.config import get_config

    header, events = replay_mod.load_full(path)
    name = (header.get("meta") or {}).get("config_name")
    if not name:
        raise SystemExit("session has no meta.config_name header")
    eng = Engine(get_config(name), device=device)
    if header.get("config") not in (None, replay_mod.config_fingerprint(eng.config)):
        raise SystemExit("config fingerprint mismatch: the session was recorded under a "
                         "different EngineConfig")
    times, last = [], [time.perf_counter()]

    def on_frame(i, img):  # a frame's time: between successive callbacks
        now = time.perf_counter()
        times.append(now - last[0])
        last[0] = now

    img = replay_mod.replay_events(eng, events, on_frame=on_frame)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    perf = _perf(eng, times)
    with open(perf_path(path), "w") as f:
        json.dump(perf, f, indent=2)
    return eng, perf, img


def diff(a_path: str, b_path: str, threshold: float) -> tuple:
    """(report dict, exit code) of two perf files: the percent deltas of the
    frame time, fps and 1% low; a regression where the frame time grew by
    more than `threshold` percent (exit 1), unknown where either file lacks
    a frame time (exit 2: a failed run is no pass), else exit 0."""
    with open(a_path) as f:
        a = json.load(f)
    with open(b_path) as f:
        b = json.load(f)
    deltas = {
        k: {"a": a.get(k), "b": b.get(k),
            "delta_pct": round(100.0 * (b[k] - a[k]) / a[k], 2)
            if a.get(k) and b.get(k) else None}
        for k in ("frame_avg_ms", "fps_avg", "low_1pct_ms")
    }
    d_frame = deltas["frame_avg_ms"]["delta_pct"]
    reg = "unknown" if d_frame is None else bool(d_frame > threshold)
    report = {"a": a_path, "b": b_path, "config": {"a": a.get("config"), "b": b.get("config")},
              "deltas": deltas, "regression": reg, "threshold_pct": threshold}
    return report, 2 if reg == "unknown" else int(reg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacetime_tpu_torch.bench", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scene", default="headline", choices=["headline", "refdemo", "capacity"])
    ap.add_argument("--frame", action="store_true",
                    help="with --scene capacity: the fused frame at 2^20 too")
    ap.add_argument("--configs", nargs="*", metavar="NAME",
                    help="the named-config table (all configs when no name is given)")
    ap.add_argument("--record", metavar="SESSION")
    ap.add_argument("--replay", metavar="SESSION")
    ap.add_argument("--diff", nargs=2, metavar=("A.perf.json", "B.perf.json"))
    ap.add_argument("--config", default="flagship_1080p", help="the config --record runs")
    ap.add_argument("--frames", type=int, default=30, help="the frames --record runs")
    ap.add_argument("--threshold", type=float, default=5.0,
                    help="--diff: regression threshold, percent frame-time increase")
    args = ap.parse_args(argv)
    if args.diff:
        report, code = diff(args.diff[0], args.diff[1], args.threshold)
        print(json.dumps(report, indent=2))
        return code
    if not torch.cuda.is_available():
        print("spacetime_tpu_torch.bench: CUDA is not available; the bench measures an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    if args.record or args.replay:
        if args.record:
            _, perf, _ = record_session(args.config, args.frames, args.record)
            what = f"recorded session {args.config}"
        else:
            _, perf, _ = replay_session(args.replay)
            what = f"replayed session {perf['config']} ({perf['frames']} frames)"
        print(json.dumps({"metric": what, "value": perf["fps_avg"], "unit": "fps",
                          "vs_baseline": perf["fps_avg"] / TARGET_FPS}))
        return 0
    if args.configs is not None:
        from .utils.config import CONFIGS

        for name in args.configs or list(CONFIGS):
            print(json.dumps(config_row(name)), flush=True)
        return 0
    if args.scene == "capacity":
        row = capacity_rows(args.frame)[0]
    else:
        row = run_headline(args.scene)
    print(json.dumps(row))
    drops = {**row.get("drops", {}),
             **{k: v for k, v in row.get("step_aux", {}).items() if k != "bonds_broken"}}
    if any(drops.values()):
        print(f"nonzero drop counters: {drops}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
