"""Graph captures the Engine made inside the measured window (a capture
there is a stall: a render key the episode had not captured in set-up)."""


def read(ctx):
    return ctx["captures"]
