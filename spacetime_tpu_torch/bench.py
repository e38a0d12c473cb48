"""The port's replay-driven A/B harness (the JAX package's bench.py:231-377).

    python3 -m spacetime_tpu_torch.bench --record S.jsonl [--config NAME] [--frames N]
    python3 -m spacetime_tpu_torch.bench --replay S.jsonl
    python3 -m spacetime_tpu_torch.bench --diff A.perf.json B.perf.json [--threshold PCT]

`--record` runs `--frames` frames of `--config` under `scripted_keys` with
a utils.replay.ReplayRecorder, `--replay` re-drives a fresh Engine with the
recorded inputs (bit-exact on one card), each writing SESSION.perf.json
(frames, frame_avg_ms, fps_avg, low_1pct_ms over the steady last half,
config, backend) and printing one JSON line; `--diff` prints the deltas of
two perf files and exits 0, 1 (frame time worse by more than `--threshold`
percent) or 2 (unknown: a frame time missing).  `--record` and `--replay`
need CUDA (exit 1 without it).

The port's frame times come from the benchmark (`python3 -m benchmark.run`,
BENCHMARK.json's cells) and its kernel times from
`python3 -m spacetime_tpu_torch.compare_kernels`; an Engine config's stats
row from the CLI: `python3 -m spacetime_tpu_torch --config NAME --frames N
--stats [--stage-timing]` prints its stats summary, with the drop counters
summed over the run and the graph counts.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

TARGET_FPS = 60.0


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
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--record", metavar="SESSION")
    what.add_argument("--replay", metavar="SESSION")
    what.add_argument("--diff", nargs=2, metavar=("A.perf.json", "B.perf.json"))
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
        print("spacetime_tpu_torch.bench: CUDA is not available; --record and --replay "
              "drive an NVIDIA GPU", file=sys.stderr)
        return 1
    if args.record:
        _, perf, _ = record_session(args.config, args.frames, args.record)
        what = f"recorded session {args.config}"
    else:
        _, perf, _ = replay_session(args.replay)
        what = f"replayed session {perf['config']} ({perf['frames']} frames)"
    print(json.dumps({"metric": what, "value": perf["fps_avg"], "unit": "fps",
                      "vs_baseline": perf["fps_avg"] / TARGET_FPS}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
