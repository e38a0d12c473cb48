"""The kernel bounds of utils/roofline.py (what compare_kernels prints
beside each kernel's time) on small fixed inputs: for each row of the
kernel table, the bytes and f32 operations reckoned by hand, and the side,
bytes or operations, that sets the bound at the H100 SXM's peaks."""

import pytest
import torch

from spacetime_tpu_torch.ops import band_cuda, forces_cuda, raytrace, rk4
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import roofline


def _collision(exclude):
    """Three particles on a 4 x 4 grid of unit cells, cutoff 0.5: two in
    cell 0, 0.2 apart (bonded when excluding), one alone in cell 10.  The
    scan of reach 1 covers rows [0, 2) and [4, 6) of cell 0's particles
    (2 candidates each) and rows [5, 8), [9, 12), [13, 16) of cell 10's (1
    candidate): 5 candidates, 10 distinct cell_start entries, 2 hits."""
    pos = torch.tensor([[0.1, 0.1], [0.3, 0.1], [2.5, 2.5]])
    active = torch.ones(3, dtype=torch.bool)
    order = forces_cuda.build_cell_order(torch.tensor([0, 0, 10], dtype=torch.int32),
                                         torch.zeros(2), 16, 4, 1.0)
    nbr = None
    if exclude:
        nbr = torch.full((3, 8), -1, dtype=torch.int32)
        nbr[0, 0], nbr[1, 0] = 1, 0
    call = lambda: roofline.collision_bound(pos, active, order, 0.5, 0.0, nbr)
    if exclude:  # + the neighbour table; 9 compares a hit, no contact kept
        return call, 3 * 24 + 4 * 10 + 4 + 32 * 3, 5 * 5 + 9 * 2, "bytes"
    return call, 3 * 24 + 4 * 10 + 4, 5 * 5 + 6 * 2, "bytes"


def _band():
    """10 particles in a 16-tick ring, max_age 12: ages 1..11 swept, band
    4 (5 window rows)."""
    pos = torch.rand(10, 2)
    buf = wl.prefill_inertial(wl.create(16, 10, device="cpu"), pos, torch.zeros(10, 2),
                              torch.ones(10, dtype=torch.bool), 0.0, 0.005)
    params = raytrace.RenderParams(band=4, max_age=12)
    return (lambda: roofline.band_bound(buf, params),
            11 * 10 * 8 + 5 * 10 * 16 + 8 * 10 + 20 * 5 * 10 + 8, 10 * 11 * 10, "bytes")


def _pixel(camera_frame):
    """A 20 x 10 view in 8-pixel cells (3 x 2 cells, the last column 4
    pixels wide, the last row 2 high), 4, 0, 5, 0, 0 and 3 entries a cell
    at bin_capacity 4: 11 entries read and 408 (pixel, candidate) tests;
    the camera-frame branch reads a 2 x 3 retina too."""
    inputs = raytrace.PixelInputs(
        entries=torch.zeros(12, 10), cell_lo=torch.tensor([0, 4, 4, 9, 9, 9]),
        cell_hi=torch.tensor([4, 4, 9, 9, 9, 12]),
        sfq=torch.zeros(2, 3) if camera_frame else None, scal=torch.zeros(8), wc_img=3,
        hc_img=2, ds=1)
    params = raytrace.RenderParams(cell_px=8, bin_capacity=4, camera_frame=camera_frame)
    cand = 4 * 8 * 8 + 4 * 4 * 8 + 3 * 4 * 2
    nbytes = 40 * 11 + 8 * 6 + 32 + 12 * 200 + (4 * 6 if camera_frame else 0)
    return (lambda: roofline.pixel_bound(inputs, params, 20, 10), nbytes,
            18 * cand + (90 if camera_frame else 60) * 200, "bytes")


def _points():
    """100 particles into a 4 x 5 image."""
    return lambda: roofline.points_bound(100, 4, 5), 100 * 13 + 12 * 20, 10 * 100, "bytes"


def _planes(materials):
    n = 4
    planes = rk4.StepPlanes(
        pos0=torch.zeros(n, 2), gpos0=torch.zeros(n, 2), vel0=torch.zeros(n, 2),
        gvel0=torch.zeros(n, 2), rest_mass=torch.ones(n), active=torch.ones(n, dtype=torch.bool),
        neighbors=torch.full((n, 8), -1, dtype=torch.int32), offsets=None, rest=torch.ones(8))
    if materials:
        planes = planes._replace(rest=torch.ones(n, 8), k_pp=torch.ones(n), c_pp=torch.ones(n),
                                 break_scale=torch.ones(n), creep_rate=torch.ones(n),
                                 yield_strain=torch.ones(n))
    return planes


def _stage3():
    """bond_stage after the first evaluation on 4 particles' own planes:
    85 bytes a particle, 8 more for the accumulator read, the 8 slot rest
    lengths; 190 operations a particle."""
    return (lambda: roofline.step_bounds(_planes(False), 2, False)[0], 4 * 93 + 4 * 8,
            4 * 190, "bytes")


def _first():
    """The first evaluation with breaking on planes with every material
    set: 85 bytes a particle, 16 for k_pp and c_pp, 8 for the partners'
    velocities, per-bond rest lengths (32 a particle), and breaking's
    table (32), creep (36) and break scale (4) a particle."""
    return (lambda: roofline.step_bounds(_planes(True), 0, True)[0],
            4 * 101 + 4 * 32 + 4 * 32 + 4 * 36 + 4 * 4, 4 * 190, "bytes")


def _finish():
    return lambda: roofline.step_bounds(_planes(False), 2, False)[1], 4 * 45, 4 * 30, "bytes"


def _retina():
    """256 rays over 20 pair rows, 16 of them valid: 30 operations a ray
    and valid pair outweigh the rows and rays read."""
    valid = torch.zeros(20, dtype=torch.bool)
    valid[:16] = True
    pairs = raytrace.PairData(pdata=torch.zeros(20, 10), pair_valid=valid,
                              n_pairs=torch.tensor(16))
    params = raytrace.RenderParams(num_rays=256)
    return (lambda: roofline.retina_bound(pairs, params), 21 * 20 + 12 * 256,
            roofline.RETINA_OPS * 256 * 16, "operations")


def _pairs():
    """A band-4 window of 10 particles (5 entries each), 7 rows kept of 12
    written: 12 bytes an entry, a boundary flag a particle, 12 a kept row,
    41 a row written, the three counts; 26 operations a segment."""
    bw = band_cuda.BandWindow(*(torch.zeros(()) for _ in range(4)),
                              *(torch.zeros(10, 5) for _ in range(4)),
                              torch.zeros(10, 5, dtype=torch.int32))
    params = raytrace.RenderParams(band=4)
    return (lambda: roofline.pairs_bound(bw, params, 12, 7),
            12 * 10 * 5 + 10 + 12 * 7 + 41 * 12 + 24, roofline.PAIR_OPS * 10 * 4, "bytes")


ROWS = {
    "collision include": lambda: _collision(False),
    "collision exclude": lambda: _collision(True),
    "band": _band,
    "pixel ground": lambda: _pixel(False),
    "pixel camera frame": lambda: _pixel(True),
    "points": _points,
    "bond_stage stage 3": _stage3,
    "bond_stage first": _first,
    "step_finish": _finish,
    "retina": _retina,
    "pairs": _pairs,
}


@pytest.mark.parametrize("row", list(ROWS))
def test_each_kernel_bound_counts_its_bytes_and_operations(row, monkeypatch):
    call, nbytes, nops, by = ROWS[row]()
    ms, bound_by = call()
    assert bound_by == by
    assert ms == pytest.approx(max(nbytes / roofline.HBM_BYTES_PER_S,
                                   nops / roofline.F32_FLOPS) * 1e3, rel=1e-12)
    monkeypatch.setattr(roofline, "bound", lambda b, o: (b, o))
    assert call() == (nbytes, nops)
