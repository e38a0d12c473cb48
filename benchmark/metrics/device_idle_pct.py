"""The share of the traced block's wall time in which no op ran on the
device: 100 x (1 - union of the device intervals / the block's seconds)."""


def read(ctx):
    if not ctx["busy_s"] or not ctx["window_s"]:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
