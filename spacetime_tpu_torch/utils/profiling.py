"""Device-level profiling on a CUDA card (counterpart of
`spacetime_tpu/utils/profiling.py`, on `torch.profiler` and `torch.cuda`).

  * `trace(path)`: a `torch.profiler` trace (CPU and CUDA activity) of the
    enclosed block, written as a Chrome trace to `path`;
  * `span(name)`: a named range on such a trace's timeline while a trace
    runs, and nothing otherwise; `spanned(label)` puts a function's calls
    in one.  These are the program's only ranges: the fused frame's stage
    ranges (step, worldline, render), the Engine's frame loop
    (`engine.*`; every place where the host waits on the device is an
    `engine.wait.*` span) and the sub-stages of the step and the renders
    (`cell sort`, `collision kernel`, ..., `route pass`).  Kineto puts the
    host ranges and the device's kernels, memcpys and memsets on one
    timeline, so a span shares the device trace's clock;
  * `attribute(events, n)`: each device kernel, memcpy and memset of a
    trace, by the innermost named range open on the host when it was
    launched (the correlation id of its launch) and by kind of kernel, per
    frame, with the device's busy time (the union of the device
    intervals).  The fused frame (fused.py) replays one CUDA graph per
    stage inside a range named after the stage while a trace runs; the
    kernels of a graph replay carry the correlation id of its graph launch,
    so they fall in that range, though the ranges of the code the graph was
    captured from do not survive into it;
  * `traced_events(run)`: the Chrome trace events of `run()`;
  * `device_memory_stats()`: bytes in use, peak and the card's total.

The JAX package also reads each op's HBM bytes from its profiler; the torch
profiler does not report bytes moved.  Without device activity (a CPU run)
`attribute` returns empty tables: a CPU run gives no device time.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Dict, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# kind of device op, by the first pattern its name matches
KINDS = (
    ("collision kernel", r"collision_kernel"),
    ("pixel kernel", r"pixel_kernel"),
    ("band kernel", r"band_kernel"),
    ("points kernel", r"points_(winner|resolve)_kernel"),
    ("step kernels", r"bond_stage_kernel|step_finish_kernel"),
    ("sort", r"[Ss]ort|[Rr]adix"),
    ("reduction", r"[Rr]educe"),
    ("index / gather / scatter", r"[Ii]ndex|[Gg]ather|[Ss]catter"),
    ("elementwise", r"[Ee]lementwise|[Vv]ectorized"),
)


@contextlib.contextmanager
def trace(path: str):
    """Trace the enclosed block (CPU and CUDA activity) and write it to
    `path` as a Chrome trace."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)


def span(name: str):
    """A `record_function` range named `name` while a torch.profiler trace
    runs, else a null context: without a trace a span costs one check of
    the profiler's state.  A CUDA graph's replay runs no Python, so the
    spans of the code it was captured from never open inside it."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def spanned(label):
    """Decorator: each call of the function inside a `span`, named `label`,
    or `label(args, kwargs)` if it is callable (worked out only while a
    trace runs)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not torch.autograd._profiler_enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label(args, kwargs) if callable(label)
                                                else label):
                return fn(*args, **kwargs)
        return call
    return wrap


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


def traced_events(run, tmp_dir: Optional[str] = None) -> list:
    """The Chrome trace events of `run()` (which must synchronize with the
    device before it returns, so the trace holds all its device work); the
    trace file goes to a temporary directory, made in `tmp_dir` if given."""
    with tempfile.TemporaryDirectory(prefix="spacetime_prof_", dir=tmp_dir) as d:
        path = os.path.join(d, "trace.json")
        with trace(path):
            run()
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_memory_stats(device=None) -> Dict[str, int]:
    """Bytes in use, peak in use and the card's total for one CUDA device
    (empty without CUDA)."""
    if not torch.cuda.is_available():
        return {}
    dev = torch.device(device) if device is not None else torch.device("cuda", 0)
    return {"bytes_in_use": int(torch.cuda.memory_allocated(dev)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}
