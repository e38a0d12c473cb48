"""The inputs and tolerances that hold the port's kernels to their plain
versions on the card: chip_smoke.py and compare_kernels.py both use them,
so both hold the kernels to the same inputs and tolerances."""

from __future__ import annotations

import torch

COLLISION_TOL = {"rtol": 1e-4, "atol": 1e-3}
BAND_FIELDS = ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages")
PIXEL_TOL = 1e-3  # per-pixel difference counted as a mismatch
PIXEL_SHARE = 1e-3  # largest share of mismatched pixels, kernel vs plain


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
