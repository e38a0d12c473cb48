"""The points kernels' (csrc/points.cu: the winner and resolve passes, by
the names the trace shows) share of their roofline: the least time the
point view's work needs at the chip's peaks (counts.points_work) over
their measured device time a frame."""

from .. import counts
from ._common import kernel_ms


def read(ctx):
    ms = kernel_ms(ctx, r"\bpoints_\w*kernel\b")
    if ms is None:
        return None
    cfg = ctx["config"]
    nbytes, nops = counts.points_work(ctx["engine"].particles.capacity, cfg["width"],
                                      cfg["height"])
    return 100.0 * counts.bound_s(nbytes, nops) * 1e3 / ms
