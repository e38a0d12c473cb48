"""Arithmetic on the program's spans in a traced block's Chrome trace.

The Engine opens `engine.frame` around each `run_frame` and an
`engine.wait.<what>` span around each place where the host waits on the
device (`record_function` ranges, category `user_annotation`, on the same
timeline as the device's ops).  Nothing here imports the program; a trace
without those spans (a program that lacks them) gives None where a reader
needs them.

Starved device time: an idle gap between the device's first and last op
is starved from its start until the earlier of its end and the end of the
host call that launched the op ending it (`cudaGraphLaunch`,
`cudaLaunchKernel`, `cudaMemcpyAsync`, ..., found by the op's correlation
id).  A gap ended by work submitted before it began lay inside submitted
work (a graph's node-to-node latency, a stream's dependency): device-side,
not starved.  So does a gap while a launch is in flight, one whose ops ran
both before and after the gap: under the profiler a graph's launch call
lasts well past its first nodes, and the gaps between its nodes are the
graph's, not the host's.

These are readings under the profiler, which slows the host's runtime
calls about threefold: they rank the host's phases and say where the
device waits on them, and do not size what an untraced run would gain.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from ..trace import LAUNCH_CATS, busy_union, device_events

FRAME = "engine.frame"
WAIT = "engine.wait."
PREV_FRAME = "engine.wait.prev_frame"


def ranges(events) -> List[Tuple[float, float, str, object]]:
    """(start us, end us, name, thread) of every host range of the trace."""
    return [(e["ts"], e["ts"] + e["dur"], e["name"], e.get("tid")) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def frame_waits(events, keep=lambda name: True) -> Optional[Tuple[float, float]]:
    """(summed us of the `engine.frame` spans, us of the union of the
    `engine.wait.*` spans whose names `keep` passes, clipped to those frames
    on their threads), or None without an `engine.frame` span."""
    spans = ranges(events)
    frames = [(a, b, tid) for a, b, name, tid in spans if name == FRAME]
    if not frames:
        return None
    waits = [(a, b, tid) for a, b, name, tid in spans if name.startswith(WAIT) and keep(name)]
    inside = [(max(a, fa), min(b, fb)) for fa, fb, ftid in frames
              for a, b, tid in waits if tid == ftid and a < fb and b > fa]
    return sum(b - a for a, b, _ in frames), busy_union((a, b - a) for a, b in inside)


def starved_gaps(events) -> List[Tuple[float, float]]:
    """(start us, end us) of the starved part of each idle gap between the
    device's first and last op (see the module docstring)."""
    calls = {e["args"]["correlation"]: e["ts"] + e["dur"] for e in events
             if e.get("ph") == "X" and e.get("cat", "") in LAUNCH_CATS
             and "correlation" in e.get("args", {})}
    dev = sorted((e["ts"], e["ts"] + e["dur"], e.get("args", {}).get("correlation"))
                 for e in device_events(events))
    last = {c: k for k, (_, _, c) in enumerate(dev) if c is not None}
    # reach: the last op of any launch that has an op before the gap, so a
    # launch is in flight across the gap before op i while reach >= i
    out, end, reach, i = [], None, -1, 0
    while i < len(dev):
        start = dev[i][0]
        # the ops that start together end the gap before them; the earliest
        # submitted of them says whether the host was late
        j = i
        while j < len(dev) and dev[j][0] == start:
            j += 1
        if end is not None and start > end and reach < i:
            submitted = min((calls[c] for _, _, c in dev[i:j] if c in calls), default=None)
            if submitted is not None and submitted > end:
                out.append((end, min(start, submitted)))
        for _, b, c in dev[i:j]:
            end = b if end is None else max(end, b)
            if c is not None:
                reach = max(reach, last[c])
        i = j
    return out


def starved_s(events) -> float:
    """Seconds of starved device time in the trace."""
    return sum(b - a for a, b in starved_gaps(events)) / 1e6


def starved_by_span(events) -> Dict[str, float]:
    """{innermost host range open at the middle of a starved gap's starved
    part (a program span or a harness range; "(no range)" where none is
    open): starved seconds}, largest first."""
    spans = ranges(events)
    total: Dict[str, float] = defaultdict(float)
    for a, b in starved_gaps(events):
        mid = 0.5 * (a + b)
        open_ = [s for s in spans if s[0] <= mid <= s[1]]
        # the latest to open, and of those the first to close
        name = max(open_, key=lambda s: (s[0], -s[1]))[2] if open_ else "(no range)"
        total[name] += (b - a) / 1e6
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))
