"""The conical frame's route-pass tests, millions a frame: every pixel of
the view-cell grid against its cell's `bin_capacity` candidates on each
route.  The Engine's running total (`Engine.render_work`, host arithmetic
on each frame's shapes, graph replays included) over the frames it ran;
the cell's budgets never move, so every frame counts the same.  None where
the Engine keeps no such total."""


def read(ctx):
    work = getattr(ctx["engine"], "render_work", None)
    if not work or not work["frames"]:
        return None
    return work["route_pass_tests"] / work["frames"] / 1e6
