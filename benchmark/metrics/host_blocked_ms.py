"""Host ms a frame inside `Engine.run_frame` in `engine.wait.*` spans
other than `engine.wait.prev_frame` (the union, so nested waits count
once): the syncs that empty the Engine's one-frame lookahead, such as the
adaptation's read of the render counters."""

from ._spans import PREV_FRAME, frame_waits


def read(ctx):
    got = frame_waits(ctx["events"], keep=lambda name: name != PREV_FRAME)
    if got is None or not ctx["frames"]:
        return None
    return got[1] / 1e3 / ctx["frames"]
