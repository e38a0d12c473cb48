"""Device ms a frame of the ops launched inside the fused frame's
`render` stage range."""

from ._common import stage


def read(ctx):
    got = stage(ctx, "render")
    return None if got is None else got[0]
