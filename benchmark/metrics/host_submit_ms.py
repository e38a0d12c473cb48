"""Host ms a frame that `Engine.run_frame` spends issuing the frame: the
summed length of the `engine.frame` spans less the union of the
`engine.wait.*` spans inside them, over the traced frames.  The floor a
short device frame cannot go below."""

from ._spans import frame_waits


def read(ctx):
    got = frame_waits(ctx["events"])
    if got is None or not ctx["frames"]:
        return None
    frames_us, waits_us = got
    return (frames_us - waits_us) / 1e3 / ctx["frames"]
