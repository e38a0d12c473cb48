"""The inputs and tolerances that hold the port's kernels to their plain
versions on the card: chip_smoke.py and compare_kernels.py both use them,
so both hold the kernels to the same inputs and tolerances, and the gate
checks a kernel at the state its timer reads it."""

from __future__ import annotations

import torch

COLLISION_TOL = {"rtol": 1e-4, "atol": 1e-3}
BAND_FIELDS = ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages")
PIXEL_TOL = 1e-3  # per-pixel difference counted as a mismatch
PIXEL_SHARE = 1e-3  # largest share of mismatched pixels, kernel vs plain
# the 2^20 capacity scene's first steps (one, then 30 more) and the fused
# frames run after its ring is prefilled again (capacity_frames)
CAPACITY_STEPS, CAPACITY_FRAMES = 31, 24


def collision_inputs(particles, model):
    """(order, {stage: (pos, disp)}): the cell order a step builds from
    `particles` and the collision kernel's inputs at RK4 stage 3 (pos +
    vel h, with the per-axis displacement rk4 reduces) and stage 0 (the
    positions the cells were built from, no displacement)."""
    from .ops import forces_cuda, grid

    P = model.params
    act = particles.active
    bdim = int(round(model.grid_dim * P.grid_resolution / model.bin_resolution))
    cell, origin = grid.cell_ids(particles.pos, act, model.bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, origin, (bdim + 2) ** 2, bdim + 2,
                                         model.bin_resolution)
    moved = (particles.pos + particles.vel * P.h).contiguous()
    disp = torch.where(act[:, None], (moved - particles.pos).abs(), 0.0).amax(dim=0)
    still = torch.zeros(2, dtype=torch.float32, device=particles.pos.device)
    return order, {3: (moved, disp), 0: (particles.pos.contiguous(), still)}


def collision_error(ours, plain, active) -> float:
    """Max abs error of the kernel's forces on the active rows; raises
    unless they are within COLLISION_TOL of the plain version's."""
    torch.testing.assert_close(ours[active], plain[active], **COLLISION_TOL)
    return (ours - plain)[active].abs().max().item()


def band_unequal(ours, plain) -> list:
    """The BandWindow fields in which the kernel's result differs from the
    plain version's (the band kernel must match it exactly)."""
    return [n for n in BAND_FIELDS if not torch.equal(getattr(ours, n), getattr(plain, n))]


def pairs_unequal(ours, plain) -> list:
    """The parts in which two (PairData, n_first, segment_dropped) results,
    the pair-rows kernel's and the plain chain's, differ: the rows bit for
    bit, pair_valid and each count exactly (the kernel must match it)."""
    bits = lambda x: x.view(torch.int32) if x.dtype == torch.float32 else x
    (po, *counts_o), (pp, *counts_p) = ours, plain
    bad = [name for name in ("pdata", "pair_valid", "n_pairs")
           if getattr(po, name).shape != getattr(pp, name).shape
           or not torch.equal(bits(getattr(po, name)), bits(getattr(pp, name)))]
    for name, a, b in zip(("n_first", "segment_dropped"), counts_o, counts_p):
        if (a is None) != (b is None) or (a is not None and int(a) != int(b)):
            bad.append(name)
    return bad


def pixel_inputs(particles, objects, buf, cam, params, width, height):
    """(PixelInputs, RenderDiag) of a frame's pixel pass: the CSR that
    `params` builds from the ring `buf`, as raytrace.render_retarded does."""
    from .ops import raytrace
    from .ops import worldline as wl

    return raytrace.prepare_pixel_pass(buf, particles.object_index, objects, cam, width,
                                       height, params, boundary=wl.boundary_mask(particles))


def pixel_share(ours, plain) -> float:
    """Share of pixels of two (3, H, W) images whose largest channel
    difference exceeds PIXEL_TOL; raises past PIXEL_SHARE (the kernel may
    flip a pixel at a capsule edge, no more)."""
    share = ((ours - plain).abs().amax(dim=0) > PIXEL_TOL).float().mean().item()
    if share > PIXEL_SHARE:
        raise AssertionError(f"pixel kernel disagrees with plain on {share:.2e} of pixels")
    return share


def step_planes(particles, model):
    """The rk4.StepPlanes of one step from `particles` on one device: the
    state's own planes, no material planes."""
    from .ops import rk4

    p = particles
    return rk4.StepPlanes(
        pos0=p.pos, gpos0=p.pos, vel0=p.vel, gvel0=p.vel, rest_mass=p.rest_mass,
        active=p.active, neighbors=p.neighbors.contiguous(), offsets=model.spring_offsets,
        rest=p.rest_len if p.rest_len is not None else model.rest_lengths)


def calls_of(module, name, run):
    """The arguments of every call of `module.name` that `run()` makes, in
    order (the calls still run)."""
    seen, real = [], getattr(module, name)

    def record(*args):
        seen.append(args)
        return real(*args)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, real)
    return seen


def _frame_calls(module, name, buf, particles, objects, cam, params, width, height):
    """The arguments of the one call of `module.name` in one retarded frame
    at `params`, built as the Engine builds it."""
    from .ops import raytrace
    from .ops import worldline as wl

    (args,) = calls_of(module, name, lambda: raytrace.prepare_pixel_pass(
        buf, particles.object_index, objects, cam, width, height, params,
        boundary=wl.boundary_mask(particles)))
    return args


def frame_retina(buf, particles, objects, cam, params, width, height):
    """The inputs of the retina march of one retarded frame at `params`: the
    frame's own prefix of boundary pairs."""
    from .ops import retina_cuda

    return _frame_calls(retina_cuda, "retina_march", buf, particles, objects, cam, params,
                        width, height)


def frame_pairs(buf, particles, objects, cam, params, width, height):
    """The inputs of the pair-rows kernel in one retarded frame at `params`
    (a card frame): (band window, object ids, objects, cam, t_now, width,
    height, params, the boundary mask or None)."""
    from .ops import pairs_cuda

    return _frame_calls(pairs_cuda, "pair_rows", buf, particles, objects, cam, params, width,
                        height)


def capacity_frames(device):
    """The 2^20 capacity scene (headline.build_capacity: 960x540, a 128-tick
    ring) as the fused frame leaves it: CAPACITY_STEPS steps of the step
    stage alone, the ring prefilled again from the stepped state, then
    CAPACITY_FRAMES fused frames (step, push, retarded render).  Returns
    (model, objects, render params, the fused.FrameState, the
    fused.FusedFrame, the counters of each of its frames)."""
    from . import fused, headline
    from .ops import worldline as wl

    model, particles, objects, buf, cam, params = headline.build_capacity(device)
    state = fused.new_state(particles, buf, cam, 0.0)
    stages = fused.frame_stages(model, None, state, objects, headline.CAPACITY_WIDTH,
                                headline.CAPACITY_HEIGHT, params, "retarded", model.params.h)
    step = fused.FusedFrame(stages, [("step", "step")], device)
    for _ in range(CAPACITY_STEPS):
        step()
    p = state.particles
    fused.commit(state.buf, wl.prefill_inertial(state.buf, p.pos, p.vel, p.active, 0.0,
                                                model.params.h))
    frame = fused.FusedFrame(stages, fused.schedule(1), device)
    counters = [frame()[1] for _ in range(CAPACITY_FRAMES)]
    return model, objects, params, state, frame, counters
