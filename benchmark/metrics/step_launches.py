"""Device ops a frame launched inside the fused frame's `step` stage
range."""

from ._common import stage


def read(ctx):
    got = stage(ctx, "step")
    return None if got is None else got[1]
