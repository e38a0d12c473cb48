"""Roofline accounting against the H100 SXM's published peaks (counterpart
of `spacetime_tpu/utils/roofline.py`).

The JAX package rates a compiled program by XLA's static cost analysis
(`cost_of`), which has no counterpart here: PyTorch runs no whole-program
compiler that counts a frame's FLOPs and bytes.  So the port rates a piece
of work whose operations and bytes its caller counts from the shapes (as
chip_smoke.py does for each kernel), against the peaks below.
"""

from __future__ import annotations

from typing import NamedTuple

# the H100 SXM's published dense peaks without sparsity (NVIDIA's data
# sheet), at the card's full power limit: f32 outside the tensor cores, and
# HBM
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


class Roofline(NamedTuple):
    """A piece of work on the H100 SXM: the f32 operations it must do and
    the bytes it must move, each input read once and each output written
    once."""

    flops: float
    bytes_accessed: float

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the operations
        over the f32 peak and the bytes over the memory rate."""
        return max(self.flops / F32_FLOPS, self.bytes_accessed / HBM_BYTES_PER_S)

    @property
    def bound_by(self) -> str:
        """'bytes' or 'operations', whichever sets bound_s."""
        return ("bytes" if self.bytes_accessed / HBM_BYTES_PER_S >= self.flops / F32_FLOPS
                else "operations")
