"""The conical frame's route-2 band sweep rows, millions a frame: the
swept ages times the ring's particles, once a defect (the back routes'
plain sweep; route 1 takes the band kernel).  The Engine's running total
(`Engine.render_work`) over the frames it ran.  None where the Engine
keeps no such total."""


def read(ctx):
    work = getattr(ctx["engine"], "render_work", None)
    if not work or not work["frames"]:
        return None
    return work["route2_sweep_rows"] / work["frames"] / 1e6
