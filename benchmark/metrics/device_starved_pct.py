"""100 x the device's starved idle time over the traced block's seconds:
the idle gaps (between the device's first and last op) up to the end of
the host call that launched the op ending each, where that call ended
after the gap began and no launch was in flight across the gap
(`_spans.starved_gaps`).  At most `device_idle_pct`; the rest of the idle
time lay inside work already submitted.  A traced reading: it ranks where
the device waits on the host, and does not size an untraced gain."""

from ._spans import starved_s


def read(ctx):
    if not ctx["busy_s"] or not ctx["window_s"]:
        return None
    return 100.0 * starved_s(ctx["events"]) / ctx["window_s"]
