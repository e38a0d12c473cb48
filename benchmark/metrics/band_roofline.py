"""The band kernel's (csrc/band.cu) share of its roofline: the least time
its work needs at the chip's peaks (counts.band_work at the ring's shape,
its in-use count and the frame's render params) over its measured device
time a frame."""

from .. import counts
from ._common import kernel_ms


def read(ctx):
    ms = kernel_ms(ctx, r"\bband_kernel\b")
    if ms is None or ctx["params"] is None:
        return None
    buf = ctx["engine"].worldline
    nbytes, nops = counts.band_work(buf.capacity, buf.num_particles,
                                    int(buf.frames_in_use), ctx["params"]["band"],
                                    ctx["params"]["max_age"])
    return 100.0 * counts.bound_s(nbytes, nops) * 1e3 / ms
