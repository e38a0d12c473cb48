"""The chip's peaks and the work the hand-written kernels need, from shapes.

Peaks: NVIDIA's data sheet for the H100 SXM (dense, no sparsity): 67
TFLOP/s in float32 outside the tensor cores and 3.35 TB/s of HBM, at the
full 700 W.  A kernel's bound is the larger of its operations over the
first and its bytes over the second; its roofline share is that bound
over the kernel's measured time.

The counts are frozen copies of the ones the port's on-card smoke test
uses (band_bound, and the points kernel's count), in terms of the inputs
a whole-frame run can see.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # f32, outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM bytes/s


def bound_s(nbytes: float, nops: float) -> float:
    return max(nbytes / PEAK_BYTES, nops / PEAK_FLOPS)


def band_work(history: int, particles: int, frames_in_use: int, band: int, max_age: int):
    """(bytes, ops) of one band kernel launch: the two position planes over
    the swept ages 1..hi0 and the four planes' band + 1 window rows read
    once, a0, alast, the four windows and their ages written once; ~10 f32
    operations per (particle, swept age).  hi0 is the oldest usable age:
    in-use ticks - 1, capped by the ring and by `max_age` (0: the ring)."""
    swept = history if max_age <= 0 else min(max_age, history)
    hi0 = max(0, min(frames_in_use - 1, history - 1, swept - 1))
    n, w = particles, band + 1
    nbytes = hi0 * n * 8 + w * n * 16 + 8 * n + 20 * w * n + 8
    return nbytes, 10 * hi0 * n


def points_work(particles: int, width: int, height: int):
    """(bytes, ops) of one point view: positions, active flags and object
    ids read once (13 bytes a particle), the planar f32 image written once;
    ~10 f32 operations a particle."""
    return particles * 13 + 12 * width * height, 10 * particles
