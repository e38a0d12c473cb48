"""Where the device time of the headline frame goes, on one CUDA card.

    python3 -m spacetime_tpu_torch.profile_frame

Runs the headline frame (headline.py) WARM_FRAMES times, which takes the
discs into contact, then WALL_FRAMES frames timed on the host clock without
the profiler, then PROFILE_FRAMES frames under `torch.profiler`.  Every
device kernel, memcpy and memset of that trace is attributed, through the
correlation id of its launch, to the innermost named range (the
sub-stages of `named_ranges`, inside the stages step / push / render) that
was open on the host when it was launched.  It prints, per frame: the device time and launches per range and
per kind of kernel, the device's busy time (the union of the device
intervals) and its busy share of the unprofiled frame's wall time.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import sys
import tempfile
import time
from collections import defaultdict

import torch

WARM_FRAMES, WALL_FRAMES, PROFILE_FRAMES = 185, 10, 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# kind of device op, by the first pattern its name matches
KINDS = (
    ("collision kernel", r"collision_kernel"),
    ("pixel kernel", r"pixel_kernel"),
    ("sort", r"[Ss]ort|[Rr]adix"),
    ("reduction", r"[Rr]educe"),
    ("index / gather / scatter", r"[Ii]ndex|[Gg]ather|[Ss]catter"),
    ("elementwise", r"[Ee]lementwise|[Vv]ectorized"),
)


def kind_of(name: str, cat: str) -> str:
    if cat != "kernel":
        return "memcpy / memset"
    for kind, pattern in KINDS:
        if re.search(pattern, name):
            return kind
    return "other"


def attribute(events, frames: int) -> dict:
    """Per-frame device ms and launches by range and by kind, and the busy
    ms (union of device intervals), from a Chrome trace's event list."""
    launches, ranges, device = {}, defaultdict(list), []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e["tid"], e["ts"])
        elif cat == "user_annotation":
            ranges[e["tid"]].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        elif cat in DEVICE_CATS:
            device.append(e)

    def innermost(tid, ts):
        inside = [r for r in ranges.get(tid, ()) if r[0] <= ts <= r[1]]
        # the latest to open, and of those the first to close
        return max(inside, key=lambda r: (r[0], -r[1]))[2] if inside else "(no range)"

    by_range = defaultdict(lambda: [0.0, 0])
    by_kind = defaultdict(lambda: [0.0, 0])
    for e in device:
        host = launches.get(e.get("args", {}).get("correlation"))
        label = innermost(*host) if host else "(no launch)"
        for table, key in ((by_range, label), (by_kind, kind_of(e["name"], e["cat"]))):
            table[key][0] += e["dur"] / 1e3 / frames
            table[key][1] += 1 / frames
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted((e["ts"], e["dur"]) for e in device):
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return {"by_range": dict(by_range), "by_kind": dict(by_kind),
            "busy_ms": busy / 1e3 / frames}


@contextlib.contextmanager
def named_ranges():
    """Wrap the frame's sub-stages in `record_function` ranges for the
    duration of the block (each is looked up through its module at call
    time, so replacing the module attribute reaches every caller)."""
    from .ops import forces, forces_cuda, grid, raytrace, render_cuda

    targets = (
        (grid, "cell_ids", "cell sort"),
        (forces_cuda, "build_cell_order", "cell sort"),
        (forces_cuda, "collision_forces", "collision kernel"),
        (forces, "spring_forces_shifted", "springs"),
        (forces, "bonded_repulsion_shifted", "bonded repulsion"),
        (raytrace, "_band_pairs", "cone sweep + pairs"),
        (raytrace, "_compact_pairs_two_segment", "pair compaction"),
        (raytrace, "_compact_pairs_to_budget", "pair compaction"),
        (raytrace, "_splat_csr", "splat CSR"),
        (raytrace, "_retina", "retina march"),
        (raytrace, "_retina_quads", "retina lookup"),
        (render_cuda, "pixel_pass", "pixel kernel"),
    )
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]

    def ranged(fn, label):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return call

    for mod, name, label in targets:
        setattr(mod, name, ranged(getattr(mod, name), label))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_frame: CUDA is not available; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from . import headline, kernels
    from .ops import raytrace
    from .ops import worldline as wl

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    kernels.library()
    model, p, objects, buf, cam, params = headline.build(device)
    h = model.params.h
    rf = torch.profiler.record_function

    def frame(p, i):
        with rf("step"):
            p, _ = model.step(p)
        with rf("push"):
            wl.push_frame(buf, p, h * (i + 1))
        with rf("render"):
            raytrace.render_retarded(buf, p.object_index, objects, cam, headline.WIDTH,
                                     headline.HEIGHT, params, planar=True,
                                     boundary=wl.boundary_mask(p))
        return p

    i = 0
    for _ in range(WARM_FRAMES):
        p, i = frame(p, i), i + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WALL_FRAMES):
        p, i = frame(p, i), i + 1
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / WALL_FRAMES * 1e3

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with named_ranges(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILE_FRAMES):
            p, i = frame(p, i), i + 1
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=kernels.BUILD_DIR) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    res = attribute(events, PROFILE_FRAMES)
    if not res["by_range"]:
        raise RuntimeError("the trace holds no device activity")

    print(f"frames {WARM_FRAMES + 1}-{WARM_FRAMES + WALL_FRAMES}: {wall_ms:.3f} ms "
          f"wall per frame without the profiler")
    for title, table in (("range", res["by_range"]), ("kind", res["by_kind"])):
        print(f"{'device time by ' + title:<28} {'ms/frame':>9} {'launches':>9} {'share':>7}")
        total = sum(v[0] for v in table.values())
        for key, (ms, n) in sorted(table.items(), key=lambda kv: -kv[1][0]):
            print(f"  {key:<26} {ms:9.4f} {n:9.1f} {ms / total:7.1%}")
        print(f"  {'total':<26} {total:9.4f} {sum(v[1] for v in table.values()):9.1f}")
    print(f"device busy {res['busy_ms']:.4f} ms per frame (union of device intervals), "
          f"{res['busy_ms'] / wall_ms:.1%} of the unprofiled frame")
    return 0


if __name__ == "__main__":
    sys.exit(main())
