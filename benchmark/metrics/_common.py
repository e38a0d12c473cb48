"""Helpers the metric readers share.  A reader is `read(ctx) -> float |
None`; `ctx` holds the traced block's Chrome trace `events`, its
`frames` and `window_s`, the device's `busy_s` over it, the window's
graph `captures`, the cell's `config` and `traffic`, the render `params`
of a window frame (a dict, or None) and the run's `engine`.  A reader
that finds nothing to read returns None, and the metric is left out."""

from __future__ import annotations

import re

from .. import trace


def stage(ctx, name: str):
    """(device ms, device ops) a frame launched inside stage range `name`,
    or None without device activity there."""
    got = trace.by_range(ctx["events"]).get(name)
    if not got or not ctx["frames"]:
        return None
    return got[0] / 1e3 / ctx["frames"], got[1] / ctx["frames"]


def kernel_ms(ctx, pattern: str):
    """Device ms a frame of the kernels whose names match `pattern`, or
    None if none ran."""
    rx = re.compile(pattern)
    dur = [e["dur"] for e in trace.device_events(ctx["events"]) if rx.search(e["name"])]
    if not dur or not ctx["frames"]:
        return None
    return sum(dur) / 1e3 / ctx["frames"]
