"""Reduction of a torch.profiler Chrome trace to device times.

A frozen copy of the port's `utils/profiling.attribute` arithmetic: each
device op (kernel, memcpy, memset) is attributed to the innermost named
range open on the host thread that launched it (found by the correlation
id of its launch; a CUDA graph's kernels carry the id of the graph's
launch, so they fall in the range the replay ran in), and the device's
busy time is the union of the device intervals.  Besides: the top device
ops by time, and the idle gaps by what the host was doing meanwhile.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver")


def device_events(events) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS]


def busy_union(intervals) -> float:
    """Microseconds covered by the union of (ts, dur) intervals."""
    busy, end = 0.0, float("-inf")
    for ts, dur in sorted(intervals):
        busy += max(0.0, ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return busy


def by_range(events) -> Dict[str, List[float]]:
    """{innermost host range: [device microseconds, device ops]} over the
    device ops of `events`."""
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

    out = defaultdict(lambda: [0.0, 0])
    for e in device:
        host = launches.get(e.get("args", {}).get("correlation"))
        label = innermost(*host) if host else "(no launch)"
        out[label][0] += e["dur"]
        out[label][1] += 1
    return dict(out)


def top_ops(events, n: int = 10) -> List[Tuple[str, float]]:
    """The `n` device ops with the most time: [name, seconds]."""
    total = defaultdict(float)
    for e in device_events(events):
        total[e["name"]] += e["dur"] / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]


def idle_gaps(events, n: int = 10, named: int = 200) -> List[Tuple[str, float]]:
    """The device's idle time between its first and last op, summed by the
    shortest host op or range open at each gap's middle, over the `named`
    longest gaps (the rest summed as "(shorter gaps)"): [name, seconds],
    the `n` largest."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    gaps, end = [], None
    for a, b in dev:
        if end is not None and a > end:
            gaps.append((a - end, 0.5 * (a + end)))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat", "") in HOST_CATS]
    total = defaultdict(float)
    for length, mid in gaps[:named]:
        open_ = [h for h in host if h[0] <= mid <= h[1]]
        name = min(open_, key=lambda h: h[1] - h[0])[2] if open_ else "(no host op)"
        total[name] += length / 1e6
    rest = sum(length for length, _ in gaps[named:])
    if rest:
        total["(shorter gaps)"] += rest / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])[:n]
