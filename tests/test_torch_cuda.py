"""The port's CUDA kernels against their plain-torch versions, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py configures jax).  Without a CUDA device
the `cuda` tests skip; the rest check the wrappers' refusals on the CPU.
"""

import contextlib
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch import fused, kernels, scene
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.checks import pairs_unequal
from spacetime_tpu_torch.constants import DEFAULT_PARAMS as P
from spacetime_tpu_torch.models.softbody import SoftbodyModel, default_bin_resolution
from spacetime_tpu_torch.state import make_objects
from spacetime_tpu_torch.ops import (band_cuda, forces, forces_cuda, grid, pairs_cuda,
                                     points_cuda, raytrace, render_cuda, retina_cuda, rk4,
                                     step_cuda)
from spacetime_tpu_torch.ops import worldline as wl

CD, REP = P.collision_distance, P.collision_repulsion_coefficient
H = 0.005
# collision sums in another f32 order (the tolerance of the JAX package's
# kernel-vs-oracle test)
COLL = dict(rtol=1e-4, atol=1e-3)
# pixels that may flip at capsule edges between kernel and plain version
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _overlapping(device, lattice_pad=True, squeeze=1.0, capacity=256):
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.0, 0.0), (0.0, 0.0), lattice_pad=lattice_pad))
    sb.add(scene.disc_softbody(4, 1, (0.012, 0.007), (0.0, 0.0), lattice_pad=lattice_pad))
    p, _ = sb.build(capacity=capacity, device=device)
    jitter = np.random.default_rng(0).uniform(-2e-4, 2e-4, tuple(p.pos.shape))
    pos = p.pos * squeeze + torch.from_numpy(jitter.astype(np.float32)).to(device)
    return p, torch.where(p.active[:, None], pos, p.pos)


def _cell_order(pos, active, dim=64):
    bres = default_bin_resolution(P)
    cell, origin = grid.cell_ids(pos, active, bres, dim)
    return forces_cuda.build_cell_order(cell, origin, (dim + 2) ** 2, dim + 2, bres)


def _moved(pos, active, lim, seed=1):
    """pos moved by up to `lim` (per axis) where active, and the per-axis
    displacement the RK4 stages would pass."""
    lim = np.broadcast_to(np.asarray(lim, dtype=np.float64), (2,))
    step = np.random.default_rng(seed).uniform(-lim, lim, tuple(pos.shape)).astype(np.float32)
    moved = (pos + torch.from_numpy(step).to(pos.device) * active[:, None]).contiguous()
    disp = torch.where(active[:, None], (moved - pos).abs(), 0.0).amax(dim=0)
    return moved, disp


def _frame(device, frames=3):
    """Two approaching discs, a prefilled ring and `frames` pushed steps."""
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(5, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(scene.disc_softbody(5, 1, (0.387, 0.405), (-0.25, -0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    p, objects = sb.build(device=device)
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                          device=device)
    buf = wl.prefill_inertial(wl.create(64, p.capacity, device=device), p.pos, p.vel, p.active,
                              0.0, H)
    for i in range(frames):
        p, _ = model.step(p)
        wl.push_frame(buf, p, H * (i + 1))
    cam = Camera.create(pos=(0.38, 0.41), zoom=0.15, device=device)
    return p, objects, buf, cam


def _params(**kw):
    base = dict(dt=H, num_rays=512, pair_budget=1024, bin_capacity=128, cell_px=9,
                occlusion_downsample=3, ray_chunk=256, retina_budget=512, max_age=48)
    base.update(kw)
    return raytrace.RenderParams(**base)


def _mismatch(a, b):
    return ((a.cpu() - b.cpu()).abs().amax(dim=0) > PIXEL_TOL).float().mean().item()


# --------------------------------------------------------------------------
# on the CPU: the wrappers refuse what they cannot run
# --------------------------------------------------------------------------


def test_wrappers_refuse_other_devices():
    p, pos = _overlapping("cpu")
    order = _cell_order(pos, p.active)
    still = torch.zeros(2)
    with pytest.raises(ValueError, match="unsupported device"):
        forces_cuda.collision_forces(pos.to("meta"), p.active, order, CD, REP, still)
    p, objects, buf, cam = _frame("cpu", frames=1)
    inputs, _ = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 48, 32, _params())
    meta = inputs._replace(entries=inputs.entries.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        render_cuda.pixel_pass(meta, _params(), width=48, height=32)
    with pytest.raises(ValueError, match="unsupported device"):
        band_cuda.cone_band_window(buf.to("meta"), _params(), cam)
    with pytest.raises(ValueError, match="unsupported device"):
        points_cuda.render_points(p.to("meta"), objects, cam, 48, 32)
    pairs, rcam, t_now, rparams = _retina_case("cells", "cpu", shrink=16)
    with pytest.raises(ValueError, match="unsupported device"):
        retina_cuda.retina_march(pairs._replace(pdata=pairs.pdata.to("meta")), rcam, t_now,
                                 rparams)
    planes, gpos, coll = _stage_inputs("cpu", "shifted", "none", "slot", False)
    with pytest.raises(ValueError, match="unsupported device"):
        rk4.bond_stage(planes, P, gpos.to("meta"), coll, None, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        rk4.step_finish(planes, P, coll.to("meta"))


def test_points_scratch_is_kept_per_size(monkeypatch):
    """One (winner, mask) pair per (device, stream): all EMPTY and 0, one
    mask bit a pixel; the same buffers for the same size, fresh ones that
    replace them for another size."""
    monkeypatch.setattr(points_cuda, "_scratch", {})
    dev = torch.device("cpu")
    winner, mask = points_cuda.scratch(dev, 7, 97, 61)
    assert winner.shape == (97 * 61,) and mask.shape == (-(-97 * 61 // 32),)
    assert bool((winner == points_cuda.EMPTY).all()) and not bool(mask.any())
    assert winner.dtype == mask.dtype == torch.int32
    again = points_cuda.scratch(dev, 7, 97, 61)
    assert again[0] is winner and again[1] is mask
    other_stream = points_cuda.scratch(dev, 8, 97, 61)
    assert other_stream[0] is not winner
    resized = points_cuda.scratch(dev, 7, 96, 64)
    assert resized[0].shape == (96 * 64,) and resized[1].shape == (192,)
    assert len(points_cuda._scratch) == 2


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed in its default prefix")
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        kernels.find_nvcc()


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("disp", [0.0, 1.5e-3])
def test_collision_kernel_matches_plain(cuda_device, disp):
    """At the positions the cells were built from, and after every particle
    moved by up to `disp` (the kernel widens its scan to stay exact)."""
    p, pos = _overlapping(cuda_device)
    order = _cell_order(pos, p.active)
    moved, d = _moved(pos, p.active, disp)
    ours = forces_cuda.collision_forces(moved, p.active, order, CD, REP, d)
    plain = forces_cuda.collision_forces_plain(moved, p.active, CD, REP)
    torch.testing.assert_close(ours[p.active], plain[p.active], **COLL)
    assert plain[p.active].abs().max() > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("disp", [0.0, 1.5e-3])
def test_collision_exclude_kernel_matches_plain(cuda_device, disp):
    """The bond-excluding variant on an unpadded scene squeezed so bonded
    pairs lie inside the collision distance; it launches its own kernel."""
    p, pos = _overlapping(cuda_device, lattice_pad=False, squeeze=0.55)
    order = _cell_order(pos, p.active)
    moved, d = _moved(pos, p.active, disp)
    kernels.reset_launch_counts()
    ours = forces_cuda.collision_forces(moved, p.active, order, CD, REP, d,
                                        neighbors=p.neighbors)
    assert kernels.launches["collision_exclude"] == 1 and kernels.launches["collision"] == 0
    plain = forces_cuda.collision_forces_plain(moved, p.active, CD, REP, p.neighbors)
    torch.testing.assert_close(ours[p.active], plain[p.active], **COLL)
    incl = forces_cuda.collision_forces_plain(moved, p.active, CD, REP)
    assert (incl - plain)[p.active].abs().max() > 1.0  # bonded pairs were excluded
    assert ours[~p.active].abs().max() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("exclude", [False, True], ids=["include", "exclude"])
@pytest.mark.parametrize("case", ["r1", "widened", "one_axis", "clamped", "parked", "inactive",
                                  "ragged"])
def test_collision_kernel_cases(cuda_device, exclude, case):
    """Both variants against plain, each input launched twice (bit-equal:
    the lane butterfly sums in a fixed order, which replay needs): at the
    cells' own positions (the 3 x 3 scan), after a move along both axes
    and along x only (the per-axis scan), after a displacement wider than
    the grid (the scan clamps to it), with a contact pair parked outside
    the grid's extent (border cells), with real particles switched off,
    and with N = 203 (no multiple of the block).  The exclude variant runs
    on the squeezed unpadded scene, where bonded pairs lie inside the
    cutoff, with two of its bond slots set to -1: the id test decides."""
    capacity = 203 if case == "ragged" else 256
    if exclude:
        p, pos = _overlapping(cuda_device, lattice_pad=False, squeeze=0.55, capacity=capacity)
    else:
        p, pos = _overlapping(cuda_device, capacity=capacity)
    active = p.active.clone()
    ids = torch.nonzero(active).flatten().tolist()
    nbr = p.neighbors.clone()
    if exclude:
        nbr[ids[5], :2] = -1
    if case == "parked":  # ids[0] and ids[-1] lie in different discs: not bonded
        pos = pos.clone()
        pos[ids[0]] = pos[ids[1]] + torch.tensor([0.5, 0.3], device=cuda_device)
        pos[ids[-1]] = pos[ids[0]] + torch.tensor([1e-3, 5e-4], device=cuda_device)
    if case == "inactive":
        active[ids[::3]] = False
    order = _cell_order(pos, active)
    lim = {"widened": 1.5e-3, "one_axis": (2e-3, 0.0), "clamped": 1.5e-3}.get(case, 0.0)
    moved, d = _moved(pos, active, lim)
    if case == "clamped":
        d = torch.tensor([0.5, 0.5], device=cuda_device)  # wider than the 64-cell grid
    nbrs = nbr if exclude else None
    ours = forces_cuda.collision_forces(moved, active, order, CD, REP, d, neighbors=nbrs)
    again = forces_cuda.collision_forces(moved, active, order, CD, REP, d, neighbors=nbrs)
    plain = forces_cuda.collision_forces_plain(moved, active, CD, REP, nbrs)
    torch.testing.assert_close(ours[active], plain[active], **COLL)
    assert torch.equal(ours, again)
    assert ours[~active].abs().max() == 0.0
    assert plain[active].abs().max() > 1.0
    if case == "parked":
        assert plain[ids[0]].abs().max() > 1.0
    if exclude:
        incl = forces_cuda.collision_forces_plain(moved, active, CD, REP)
        assert (incl - plain)[active].abs().max() > 1.0  # bonded pairs were excluded


@pytest.mark.cuda
def test_row_physics_on_card_matches_cpu(cuda_device):
    """Row-gather steps (no spring offsets) through the unpadded discs'
    impact on the card vs the CPU path: every collision launch is the
    exclude variant."""
    out = {}
    kernels.reset_launch_counts()
    for dev in ("cpu", cuda_device):
        sb = scene.SceneBuilder()
        sb.add(scene.disc_softbody(5, 0, (0.35, 0.40), (0.25, 0.05)))
        sb.add(scene.disc_softbody(5, 1, (0.387, 0.405), (-0.25, -0.05)))
        p, _ = sb.build(device=dev)
        model = SoftbodyModel(p.capacity, None, device=dev)
        p, _ = model.step_n(p, 4)
        out[str(dev)] = p
    assert kernels.launches["collision_exclude"] == 16 and kernels.launches["collision"] == 0
    cpu, gpu = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(gpu.pos.cpu()[cpu.active], cpu.pos[cpu.active], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [True, False])
def test_pixel_kernel_camera_frame_matches_plain(cuda_device, opaque):
    """The CAMERA_FRAME branch (inverse warp before shading) against the
    plain version on the same warped CSR, camera at 0.5c."""
    p, objects, buf, cam = _frame(cuda_device)
    cam = Camera.create(pos=(0.38, 0.41), zoom=0.15, vel=(0.5, 0.1), device=cuda_device)
    params = _params(opaque=opaque, camera_frame=True)
    inputs, _ = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 96, 64, params,
                                            boundary=wl.boundary_mask(p))
    kernels.reset_launch_counts()
    ours = render_cuda.pixel_pass(inputs, params, width=96, height=64)
    assert kernels.launches["pixel_pass_camera_frame"] == 1 and kernels.launches["pixel_pass"] == 0
    plain = render_cuda.pixel_pass_plain(inputs, params, width=96, height=64)
    assert (plain < 0.99).float().mean() > 0.02
    assert _mismatch(ours, plain) <= PIXEL_SHARE
    assert torch.equal(ours, render_cuda.pixel_pass(inputs, params, width=96, height=64))
    ground = render_cuda.pixel_pass(inputs, dataclasses.replace(params, camera_frame=False),
                                    width=96, height=64)
    assert _mismatch(ours, ground) > 0.01  # the branch changes the picture


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [True, False])
def test_pixel_kernel_matches_plain(cuda_device, opaque):
    p, objects, buf, cam = _frame(cuda_device)
    params = _params(opaque=opaque)
    inputs, _ = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 96, 64, params,
                                            boundary=wl.boundary_mask(p))
    ours = render_cuda.pixel_pass(inputs, params, width=96, height=64)
    plain = render_cuda.pixel_pass_plain(inputs, params, width=96, height=64)
    assert (plain < 0.99).float().mean() > 0.05
    assert _mismatch(ours, plain) <= PIXEL_SHARE
    assert torch.equal(ours, render_cuda.pixel_pass(inputs, params, width=96, height=64))


@pytest.mark.cuda
@pytest.mark.parametrize("camera_frame", [False, True], ids=["ground", "camera_frame"])
def test_pixel_kernel_wide_cells_match_plain(cuda_device, camera_frame):
    """Cells wider than 32 pixels (the Engine's ladder picks 48 and 64 at
    deep zoom-in): 12 runs a cell row, so a tile is one or two rows."""
    p, objects, buf, cam = _frame(cuda_device)
    if camera_frame:
        cam = Camera.create(pos=(0.38, 0.41), zoom=0.15, vel=(0.5, 0.1), device=cuda_device)
    params = _params(cell_px=48, occlusion_downsample=2, camera_frame=camera_frame)
    inputs, _ = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 96, 64, params,
                                            boundary=wl.boundary_mask(p))
    ours = render_cuda.pixel_pass(inputs, params, width=96, height=64)
    plain = render_cuda.pixel_pass_plain(inputs, params, width=96, height=64)
    assert (plain < 0.99).float().mean() > 0.05
    assert _mismatch(ours, plain) <= PIXEL_SHARE
    assert torch.equal(ours, render_cuda.pixel_pass(inputs, params, width=96, height=64))


def _tie_frame(device):
    """Two coincident discs of two colours on a prefilled ring: every
    splat entry of the first disc has an entry of the second with the same
    geometry and time, later in its cell (pair order), so d2 ties exactly
    and the first entry must win."""
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(5, 0, (0.37, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(scene.disc_softbody(5, 1, (0.37, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    p, objects = sb.build(device=device)
    buf = wl.prefill_inertial(wl.create(64, p.capacity, device=device), p.pos, p.vel, p.active,
                              0.0, H)
    return p, objects, buf


def _far_frame(device):
    """Two still discs in one 64-pixel view cell, 0.05 and 0.42 light
    seconds from the camera: the cell's entries span about 80 ages, seen
    from a zoomed-out camera through a 128-row ring."""
    sb = scene.SceneBuilder()
    for i, dx in enumerate((0.05, 0.42)):
        sb.add(scene.disc_softbody(7, i, (0.38 + dx, 0.41 - 0.0245), (0.0, 0.0), lattice_pad=True),
               base_color=((0.25, 0.35, 1.0), (1.0, 0.3, 0.25))[i])
    p, objects = sb.build(device=device)
    buf = wl.prefill_inertial(wl.create(128, p.capacity, device=device), p.pos, p.vel, p.active,
                              0.0, H)
    return p, objects, buf


@pytest.mark.cuda
@pytest.mark.parametrize("camera_frame", [False, True], ids=["ground", "camera_frame"])
@pytest.mark.parametrize("case", ["saturated", "ties", "ragged", "age_span", "uhd", "cap_1536"])
def test_pixel_kernel_cases(cuda_device, camera_frame, case):
    """Both branches against plain (at most PIXEL_SHARE of pixels off by
    more than PIXEL_TOL), two launches bit-equal: 32-pixel cells filled
    to a bin_capacity of 192 (long candidate walks, split over the camera
    branch's lanes); exact d2 ties between coincident discs of two colours
    (the first entry wins, also across the lane merge); a 97 x 61 image
    (no multiple of 4 wide, no multiple of cell_px 16 high: ragged runs, a
    partial last cell row, scalar stores); a cell whose entries span more
    than the kernel's 64 age bins (bins two ages wide); a 3840 x 2160
    image (2,073,600 runs of 4 pixels); a bin_capacity of 1536, whose
    62,480-byte slice needs more than the 48 KB a block has without opting
    in."""
    vel = (0.5, 0.1) if camera_frame else (0, 0)
    zoom = 0.15
    width, height = {"ragged": (97, 61), "age_span": (128, 64), "uhd": (3840, 2160)}.get(
        case, (96, 64))
    kw = dict(cell_px=16, camera_frame=camera_frame)
    if case == "saturated":
        kw.update(cell_px=32, bin_capacity=192, pair_budget=2048)
    if case == "age_span":
        vel = (-0.3, 0.0) if camera_frame else vel
        zoom = 1.0
        kw.update(cell_px=64, occlusion_downsample=2, bin_capacity=384, pair_budget=4096,
                  max_age=120, band=2, rho=0.005)
    if case == "uhd":
        zoom = 0.8
        kw.update(cell_px=32, occlusion_downsample=2)
    if case == "cap_1536":
        kw.update(cell_px=32, bin_capacity=1536, pair_budget=2048)
    cam = Camera.create(pos=(0.38, 0.41), zoom=zoom, vel=vel, device=cuda_device)
    if case == "ties":
        p, objects, buf = _tie_frame(cuda_device)
    elif case == "age_span":
        p, objects, buf = _far_frame(cuda_device)
    else:
        p, objects, buf, _ = _frame(cuda_device)
    params = _params(**kw)
    inputs, diag = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, width, height,
                                               params, boundary=wl.boundary_mask(p))
    count = inputs.cell_hi - inputs.cell_lo
    if case == "saturated":
        assert (count == params.bin_capacity).any() and int(diag.bin_dropped) > 0
    if case == "cap_1536":
        assert int(count.max()) > 192 and int(diag.bin_dropped) == 0
    if case == "age_span":
        ages = torch.round((inputs.scal[0] - inputs.entries[:, 4]) / params.dt)
        spans = [int(ages[lo:hi].max() - ages[lo:hi].min())
                 for lo, hi in zip(inputs.cell_lo.tolist(), inputs.cell_hi.tolist()) if hi > lo]
        assert max(spans) > 64 and int(diag.bin_dropped) == 0
    if case == "ties":  # one particle's entry is in a cell once: a repeat is a tie
        ties = 0
        for c in torch.nonzero(count).flatten().tolist():
            cell = inputs.entries[inputs.cell_lo[c]:inputs.cell_hi[c], :5]
            ties += int((torch.unique(cell, dim=0, return_counts=True)[1] >= 2).sum())
        assert ties > 100
    ours = render_cuda.pixel_pass(inputs, params, width=width, height=height)
    again = render_cuda.pixel_pass(inputs, params, width=width, height=height)
    plain = render_cuda.pixel_pass_plain(inputs, params, width=width, height=height)
    assert ours.shape == (3, height, width)
    if case == "uhd":
        assert int((plain < 0.99).any(dim=0).sum()) > 10_000
    else:
        assert (plain < 0.99).float().mean() > 0.02
    if case == "age_span":  # both discs, the near and the far, are seen (in colour)
        hue = plain.amax(dim=0) - plain.amin(dim=0)
        assert (hue[:, :96] > 0.05).any() and (hue[:, 96:] > 0.05).any()
    assert _mismatch(ours, plain) <= PIXEL_SHARE
    assert torch.equal(ours, again)


@pytest.mark.cuda
def test_slice_on_card_matches_cpu(cuda_device):
    """The whole frame on the card vs the CPU path, through the impact; every
    collision and pixel pass on the card goes through the kernels."""
    kernels.reset_launch_counts()
    pg, objg, bufg, camg = _frame(cuda_device)
    assert kernels.launches["collision"] == 12
    p, objs, buf, cam = _frame("cpu")
    torch.testing.assert_close(pg.pos.cpu()[p.active], p.pos[p.active], rtol=0, atol=1e-5)
    params = _params()
    imgg = raytrace.render_retarded(bufg, pg.object_index, objg, camg, 96, 64, params,
                                    planar=True, boundary=wl.boundary_mask(pg))
    img = raytrace.render_retarded(buf, p.object_index, objs, cam, 96, 64, params,
                                   planar=True, boundary=wl.boundary_mask(p))
    assert kernels.launches["pixel_pass"] == 1
    assert _mismatch(imgg, img) <= PIXEL_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("band,max_age", [(6, 48), (2, 0)])
def test_band_kernel_matches_plain(cuda_device, band, max_age):
    """Exactly equal: a0, alast, truncated, every window value and age."""
    p, objects, buf, cam = _frame(cuda_device)
    params = _params(band=band, max_age=max_age)
    kernels.reset_launch_counts()
    ours = band_cuda.cone_band_window(buf, params, cam)
    plain = band_cuda.cone_band_window_plain(buf, params, cam)
    assert kernels.launches["band"] == 1
    for name in ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages"):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name
    assert ours.hi0 == plain.hi0
    assert (plain.a0 <= plain.hi0).any()
    assert (int(plain.truncated) > 0) == (band == 2)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["few_ages", "ragged_ages", "ragged_n", "truncated"])
def test_band_kernel_cases(cuda_device, case):
    """Exactly equal to plain, and two launches bit-equal: with hi0 below
    the kernel's age slices (max_age 5: hi0 4), hi0 no multiple of them
    (max_age 20: hi0 19), N = 203 (no multiple of the 32 particles of a
    block), and a band short enough that crossings are truncated; each
    case has particles that never enter the band (a0 = hi0 + 1,
    alast = -1)."""
    n = 203 if case == "ragged_n" else None
    max_age = {"few_ages": 5, "ragged_ages": 20}.get(case, 48)
    band = 2 if case == "truncated" else 6
    p, _, buf, cam = _frame(cuda_device)
    if n is not None:
        sb = scene.SceneBuilder()
        sb.add(scene.disc_softbody(5, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True))
        p, _ = sb.build(capacity=n, device=cuda_device)
        buf = wl.prefill_inertial(wl.create(64, n, device=cuda_device), p.pos, p.vel, p.active,
                                  0.0, H)
    params = _params(band=band, max_age=max_age)
    ours = band_cuda.cone_band_window(buf, params, cam)
    again = band_cuda.cone_band_window(buf, params, cam)
    plain = band_cuda.cone_band_window_plain(buf, params, cam)
    for name in ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages"):
        assert torch.equal(getattr(ours, name), getattr(plain, name)), name
        assert torch.equal(getattr(ours, name), getattr(again, name)), name
    assert ours.hi0 == plain.hi0 == max_age - 1
    never = plain.a0 == plain.hi0 + 1
    assert never.any() and (plain.a0 <= plain.hi0).any()
    assert (plain.alast[never] == -1).all()
    if case == "truncated":
        assert int(plain.truncated) > 0


# the occlusion retina's cases: (num_rays, pair rows) at the retarded cells'
# shapes (num_rays 4096, retina_budget 16384), ragged pair and ray counts,
# and rows that no ray may hit
RETINA_CASES = {
    "cells": (4096, 16384), "pairs_1": (4096, 1), "pairs_8193": (4096, 8193),
    "pairs_12345": (4096, 12345), "rays_1000": (1000, 16384), "all_invalid": (4096, 16384),
    "far_sentinels": (4096, 16384), "behind_cone": (4096, 16384), "empty": (4096, 0),
    "valid_prefix": (4096, 16384),
}
RETINA_T_NOW = 1.25


def _retina_case(case, device, shrink=1):
    """(pairs, cam, t_now, params) of RETINA_CASES[case], both counts cut by
    `shrink`: pair rows on the camera's past light cone (each a capsule a
    ray can hit), a tenth of them invalid.  `all_invalid` flags every row
    invalid; `far_sentinels` makes a third of the rows the compaction's
    2e9 sentinels, half of those flagged valid; `behind_cone` moves a third
    to within rho of the camera at ta >= t_now (s_hit <= 0); `valid_prefix`
    keeps only the first 1,126 rows valid, as a frame's retina holds its
    boundary pairs (capacity_2p20.retarded's count)."""
    n_rays, rows = RETINA_CASES[case]
    n_rays, rows = max(1, n_rays // shrink), -(-rows // shrink)
    rng = np.random.default_rng(sum(map(ord, case)))
    cx, cy = 0.38, 0.41
    d = rng.uniform(0.02, 1.0, rows)
    phi = rng.uniform(-np.pi, np.pi, rows)
    ax = cx + d * np.cos(phi) + rng.normal(0.0, 0.002, rows)
    ay = cy + d * np.sin(phi) + rng.normal(0.0, 0.002, rows)
    ta = RETINA_T_NOW - d - rng.uniform(0.0, H, rows)
    vx, vy = rng.uniform(-0.6, 0.6, (2, rows))
    valid = rng.random(rows) >= 0.1
    if case == "behind_cone":
        back = rng.random(rows) < 1 / 3
        ax[back] = cx + rng.uniform(-0.001, 0.001, back.sum())
        ay[back] = cy + rng.uniform(-0.001, 0.001, back.sum())
        ta[back] = RETINA_T_NOW + rng.uniform(0.0, 0.3, back.sum())
        ta[np.flatnonzero(back)[:8]] = RETINA_T_NOW
    pdata = np.stack([ax, ay, ax + vx * H, ay + vy * H, ta, vx, vy,
                      *rng.random((3, rows))], axis=1).astype(np.float32)
    if case == "all_invalid":
        valid[:] = False
    if case == "valid_prefix":  # a frame's boundary pairs: a short valid prefix
        valid = np.arange(rows) < max(1, 1126 // shrink)
    if case == "far_sentinels":
        far = rng.random(rows) < 1 / 3
        pdata[far] = 2.0e9
        valid[far] = rng.random(far.sum()) < 0.5
    pairs = raytrace.PairData(pdata=torch.from_numpy(pdata).to(device),
                              pair_valid=torch.from_numpy(valid).to(device),
                              n_pairs=torch.tensor(int(valid.sum()), device=device))
    cam = Camera.create(pos=(cx, cy), zoom=0.15, device=device)
    t_now = torch.tensor(RETINA_T_NOW, dtype=torch.float32, device=device)
    params = raytrace.RenderParams(dt=H, num_rays=n_rays, ray_chunk=8192 // shrink)
    return pairs, cam, t_now, params


def _retina_expected(case, s_first):
    """What each case must show: no hit at all where no row can be hit, a
    hit on most rays where thousands of rows can (some with the short
    prefix); every hit ahead of the camera (s > 0)."""
    big = torch.tensor(raytrace._BIG, dtype=torch.float32)
    hits = s_first.cpu() < big
    assert bool((s_first.cpu()[hits] > 0).all())
    if case in ("all_invalid", "empty"):
        assert not hits.any()
    elif case == "valid_prefix":
        assert hits.any()
    elif case != "pairs_1":
        assert hits.float().mean() > 0.5, hits.float().mean()


@pytest.mark.parametrize("case", list(RETINA_CASES))
def test_retina_takes_the_plain_path_on_cpu(case):
    """CPU tensors: _retina is the plain march, no kernel launch is
    counted, and the march's chunking does not change a bit (the kernel's
    pair slices rely on that: a minimum is exact in any order)."""
    pairs, cam, t_now, params = _retina_case(case, "cpu", shrink=16)
    kernels.reset_launch_counts()
    ours = raytrace._retina(pairs, cam, t_now, params)
    assert kernels.launches["retina_march"] == 0
    rows = pairs.pdata.shape[0]
    for chunk in (1 if rows < 64 else 37, max(1, rows)):
        whole = retina_cuda.retina_march_plain(pairs, cam, t_now,
                                               dataclasses.replace(params, ray_chunk=chunk))
        assert torch.equal(ours, whole), chunk
    assert ours.shape == (params.num_rays,) and ours.dtype == torch.float32
    _retina_expected(case, ours)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RETINA_CASES))
def test_retina_kernel_matches_plain(cuda_device, case):
    """Bit-equal to the plain march on the same card (csrc/retina.cu rounds
    every operation as torch does), one launch a retina, and a second
    launch bit-equal too (the slices' atomic minimum in another order)."""
    pairs, cam, t_now, params = _retina_case(case, cuda_device)
    kernels.reset_launch_counts()
    ours = raytrace._retina(pairs, cam, t_now, params)
    again = retina_cuda.retina_march(pairs, cam, t_now, params)
    assert kernels.launches["retina_march"] == 2
    plain = retina_cuda.retina_march_plain(pairs, cam, t_now, params)
    differs = (ours != plain).nonzero().flatten()[:8].tolist()
    assert torch.equal(ours, plain), (differs, ours[differs].tolist(), plain[differs].tolist())
    assert torch.equal(again, ours)
    _retina_expected(case, plain)


def test_pair_rows_take_the_kernel_only_on_the_card():
    """The dispatch (raytrace._frame_pairs) observes its inputs: CUDA
    tensors with no mesh take the kernel, whatever the band (the wrapper
    refuses a band it cannot run); CPU tensors and a mesh (whose ranks
    gather raw rows) take the plain chain."""
    params = raytrace.RenderParams()
    card = torch.device("cuda", 0)
    assert pairs_cuda.takes_kernel(card, params)
    assert pairs_cuda.takes_kernel(card, dataclasses.replace(params, band=32))
    assert pairs_cuda.takes_kernel(card, dataclasses.replace(params, band=33))
    assert not pairs_cuda.takes_kernel(torch.device("cpu"), params)
    assert not pairs_cuda.takes_kernel(card, params, mesh=object())


def test_pair_rows_refuse_cpu_tensors():
    p, objects, buf, cam = _frame("cpu", frames=1)
    bw = band_cuda.cone_band_window(buf, _params(), cam)
    with pytest.raises(ValueError, match="unsupported device"):
        pairs_cuda.pair_rows(bw, p.object_index, objects, cam, wl.newest_time(buf), 48, 32,
                             _params())


@pytest.mark.parametrize("band", [0, 33])
def test_pair_rows_refuse_a_band_past_the_mask(band):
    """The kernel keeps a particle's valid segments in one 32-bit mask:
    the wrapper refuses a band outside [1, 32] before it looks at a tensor,
    and raises instead of handing the frame to the plain chain."""
    p, objects, buf, cam = _frame("cpu", frames=1)
    bw = band_cuda.cone_band_window(buf, _params(), cam)
    with pytest.raises(ValueError, match=r"band must be in \[1, 32\]"):
        pairs_cuda.pair_rows(bw, p.object_index, objects, cam, wl.newest_time(buf), 48, 32,
                             _params(band=band))


@pytest.mark.parametrize("mode", ["retarded", "conical", "retina"])
def test_pair_rows_take_the_plain_chain_on_cpu(mode, monkeypatch):
    """CPU tensors never reach the kernel's wrapper, nor do the conical
    mode's geodesic routes (their own cone metric) or the retina mode's
    unculled panorama on any device: each renders with the wrapper (and,
    off the retarded mode, the dispatch) refusing every call and counts no
    pairs launch; the retarded frame's pairs are the plain chain's."""
    from spacetime_tpu_torch.ops import curved

    def refuse(*args, **kw):
        raise AssertionError("the pair-rows kernel's path was taken")

    p, objects, buf, cam = _frame("cpu")
    params = _params()
    boundary = wl.boundary_mask(p)
    monkeypatch.setattr(pairs_cuda, "pair_rows", refuse)
    if mode != "retarded":
        monkeypatch.setattr(raytrace, "_frame_pairs", refuse)
    kernels.reset_launch_counts()
    if mode == "retarded":
        t_now = wl.newest_time(buf)
        ours = raytrace._frame_pairs(buf, p.object_index, objects, cam, t_now, 48, 32, params,
                                     boundary)
        bw = band_cuda.cone_band_window(buf, params, cam)
        plain = pairs_cuda.pair_rows_plain(bw, p.object_index, objects, cam, t_now, 48, 32,
                                           params, boundary)
        assert not pairs_unequal((ours[0], ours[1], ours[3]), plain) and ours[1] is not None
        img = raytrace.render_retarded(buf, p.object_index, objects, cam, 48, 32, params,
                                       boundary=boundary)
    elif mode == "conical":
        defect = curved.ConicalDefect.create((0.36, 0.42), 0.8, device="cpu")
        img, _ = curved.render_retarded_conical_with_diag(buf, p.object_index, objects, cam,
                                                          defect, 48, 32, params)
    else:
        img = raytrace.render_retina(buf, p.object_index, objects, cam, params, height=4)
    assert kernels.launches["pairs"] == 0 and torch.isfinite(img).all()


@pytest.mark.parametrize("budget", ["under_first", "between", "above_valid", "rows", "none"])
def test_plain_pair_compaction_order(budget):
    """The order the pair-rows kernel copies, on the plain chain: the
    valid rows of the first class (boundary particles) in row order, then
    the other valid rows in row order, then sentinel rows (all ten fields
    2e9, pair_valid false), cut to the budget (all rows with a budget of 0
    or at least the row count); n_pairs the valid count before the budget
    and n_first the first class's.  Without the split: the valid rows in
    row order, then sentinels, under a budget below the row count, else the
    rows as they were."""
    rng = np.random.default_rng(11)
    n, k = 16, 3
    rows = n * k
    pdata = torch.from_numpy(rng.random((rows, 10)).astype(np.float32))
    valid = torch.from_numpy(rng.random(rows) < 0.55)
    first = torch.from_numpy(rng.random(n) < 0.4)[:, None].expand(n, k).reshape(-1)
    pairs = raytrace.PairData(pdata=pdata, pair_valid=valid, n_pairs=valid.sum())
    idx0 = [r for r in range(rows) if valid[r] and first[r]]
    idx1 = [r for r in range(rows) if valid[r] and not first[r]]
    assert 0 < len(idx0) < len(idx0) + len(idx1) < rows
    cut = {"under_first": len(idx0) // 2, "between": len(idx0) + len(idx1) // 2,
           "above_valid": len(idx0) + len(idx1) + 3, "rows": rows, "none": 0}[budget]
    keep = cut if 0 < cut < rows else rows

    def expected(order):
        want = torch.full((keep, 10), 2.0e9)
        used = order[:keep]
        want[:len(used)] = pdata[used]
        return want, torch.arange(keep) < len(used)

    out, n_first = raytrace._compact_pairs_two_segment(pairs, first, cut)
    want, want_valid = expected(idx0 + idx1)
    assert torch.equal(out.pdata, want) and torch.equal(out.pair_valid, want_valid)
    assert int(out.n_pairs) == len(idx0) + len(idx1) and int(n_first) == len(idx0)
    one = raytrace._compact_pairs_to_budget(pairs, cut)
    if 0 < cut < rows:
        want, want_valid = expected(sorted(idx0 + idx1))
        assert torch.equal(one.pdata, want) and torch.equal(one.pair_valid, want_valid)
    else:
        assert one is pairs
    assert int(one.n_pairs) == len(idx0) + len(idx1)


# --------------------------------------------------------------------------
# the pair rows (csrc/pairs.cu) against the plain chain
# --------------------------------------------------------------------------

# the retarded cells' particle counts: refdemo_116k's capacity (no multiple
# of the kernel's 1,024-particle tiles) and capacity_2p20's
PAIR_SHAPES = {"refdemo": 149248, "2p20": 1 << 20}
PAIR_TICKS = 48


def _pair_scene(device, n, ticks=PAIR_TICKS, spread=0.9, seed=5, young=0):
    """(buf, obj_index, objects, boundary, cam): n particles in a disc
    around the camera whose radius is `spread` x the ring's light travel
    (so they cross the cone at every age), moving inertially at up to
    0.35c in each axis, 5% parked (never present), three objects, 30% on a
    boundary; the view (960 x 540 at a zoom of half the disc) culls part of
    the disc.  With `young` the ring holds only that many pushed ticks."""
    rng = np.random.default_rng(seed + n)
    r = spread * ticks * H * np.sqrt(rng.random(n))
    phi = rng.uniform(-np.pi, np.pi, n)
    t = lambda a, dtype=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype)
    pos = t(np.stack([0.1 + r * np.cos(phi), -0.2 + r * np.sin(phi)], axis=1))
    vel = t(rng.uniform(-0.35, 0.35, (n, 2)))
    present = t(rng.random(n) >= 0.05, torch.bool)
    if young:
        buf = wl.create(ticks, n, device=device)
        for i in range(young):
            wl.push_raw(buf, pos + vel * (H * i), vel, present, 1.25 + H * i)
    else:
        buf = wl.prefill_inertial(wl.create(ticks, n, device=device), pos, vel, present, 1.25,
                                  H)
    objects = make_objects(3, [{"base_color": c} for c in
                               ((0.2, 0.3, 1.0), (1.0, 0.3, 0.2), (0.4, 0.9, 0.3))],
                           device=device)
    obj_index = t(rng.integers(0, 3, n), torch.int32)
    boundary = t(rng.random(n) < 0.3, torch.bool) & present
    cam = Camera.create(pos=(0.1, -0.2), zoom=0.45 * ticks * H, device=device)
    return buf, obj_index, objects, boundary, cam


def _pair_budgets(plain_all, n_first, rows):
    """A budget under the first class's count, one between it and the valid
    count, one above the valid count, the row count and 0 (no budget)."""
    n_pairs = int(plain_all.n_pairs)
    nf = int(n_first) if n_first is not None else n_pairs // 3
    return sorted({max(1, nf // 2), max(1, (nf + n_pairs) // 2), min(rows, n_pairs + 7), rows, 0})


def _bits(x):
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _check_pair_rows(buf, obj_index, objects, boundary, cam, params, split_counts=True):
    """Every budget of _pair_budgets, each boundary split (mixed, all, none
    and no split) and the hull cull on and off: the kernel's rows bit-equal
    to the plain chain's.  Returns the plain valid counts by cull."""
    bw = band_cuda.cone_band_window(buf, params, cam)
    t_now = wl.newest_time(buf)
    n = buf.num_particles
    k = params.segments if 0 < params.segments < params.band else params.band
    splits = {"mixed": boundary, "all": torch.ones_like(boundary),
              "none": torch.zeros_like(boundary), "no split": None}
    counts = {}
    for camera_frame in (False, True):
        p = dataclasses.replace(params, camera_frame=camera_frame, pair_budget=0)
        whole = pairs_cuda.pair_rows_plain(bw, obj_index, objects, cam, t_now, 960, 540, p,
                                           boundary)
        counts[camera_frame] = int(whole[0].n_pairs)
        for budget in _pair_budgets(whole[0], whole[1], n * k):
            for split, mask in splits.items():
                q = dataclasses.replace(p, pair_budget=budget)
                kernels.reset_launch_counts()
                ours = pairs_cuda.pair_rows(bw, obj_index, objects, cam, t_now, 960, 540, q, mask)
                assert kernels.launches["pairs"] == 1
                plain = pairs_cuda.pair_rows_plain(bw, obj_index, objects, cam, t_now, 960, 540,
                                                   q, mask)
                bad = pairs_unequal(ours, plain)
                assert not bad, (bad, camera_frame, budget, split)
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 2], ids=["all_crossings", "rank_2"])
@pytest.mark.parametrize("band", [4, 6])
@pytest.mark.parametrize("shape", list(PAIR_SHAPES))
def test_pair_rows_kernel_matches_plain(cuda_device, shape, band, segments):
    """At the retarded cells' particle counts, bands 4 and 6, with and
    without rank compaction: rows, pair_valid, n_pairs, n_first and
    segment_dropped bit-equal to the plain chain at every budget (under
    the boundary rows, between them and the valid rows, above those, the
    row count, none), every boundary split and with the hull cull on and
    off; the cull takes rows away."""
    scene_ = _pair_scene(cuda_device, PAIR_SHAPES[shape])
    params = _params(band=band, segments=segments, max_age=0)
    counts = _check_pair_rows(*scene_, params)
    assert 0 < counts[False] < counts[True], counts


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["empty_cone", "young_ring", "ragged_n"])
def test_pair_rows_kernel_cases(cuda_device, case):
    """Bit-equal to the plain chain with no valid row at all (every
    particle beyond the ring's light travel: sentinel rows only), on a ring
    that holds 3 ticks of 48 (hi0 2), and at 1,001 particles (one partial
    tile)."""
    n = 1001 if case == "ragged_n" else PAIR_SHAPES["refdemo"]
    scene_ = _pair_scene(cuda_device, n, spread=4.0 if case == "empty_cone" else 0.9,
                         young=3 if case == "young_ring" else 0)
    if case == "empty_cone":
        buf, obj_index, objects, boundary, cam = scene_
        far = torch.where(buf.pos_x < 1e8, buf.pos_x + 10.0, buf.pos_x)
        scene_ = (dataclasses.replace(buf, pos_x=far.contiguous()), *scene_[1:])
    for segments in (0, 2):
        counts = _check_pair_rows(*scene_, _params(band=4, segments=segments, max_age=0))
        assert (counts[True] == 0) == (case == "empty_cone"), counts


@pytest.mark.cuda
def test_frame_pairs_on_the_card_raise_on_a_band_past_the_mask(cuda_device):
    """A retarded frame on the card with a band the pair-rows kernel cannot
    run raises; it does not fall back to the plain chain."""
    p, objects, buf, cam = _frame(cuda_device)
    params = _params(band=33)
    with pytest.raises(ValueError, match=r"band must be in \[1, 32\]"):
        raytrace._frame_pairs(buf, p.object_index, objects, cam, wl.newest_time(buf), 48, 32,
                              params, wl.boundary_mask(p))


@pytest.mark.cuda
def test_fused_frames_with_pair_rows_match_the_plain_chain(cuda_device, monkeypatch):
    """Fused frames (graph replays) whose pair rows come from the kernel,
    against the same frames run eagerly with the plain chain: images,
    counters (every RenderDiag field), positions and ring bit-equal, one
    pairs launch a frame; the frames split the boundary rows (the retina
    budget under the rows) and compact to a pair budget under them."""
    state, model, objects = _fused_state(cuda_device)
    other = fused.copy_state(state)
    params = _params()
    order = fused.schedule(1)
    graph = fused.FusedFrame(_stages(state, model, objects, params), order, cuda_device)
    eager = _stages(other, model, objects, params)
    frames = 5
    kernels.reset_launch_counts()
    outs = [graph() for _ in range(frames)]
    assert kernels.launches["pairs"] == frames and kernels.launches["band"] == frames
    monkeypatch.setattr(pairs_cuda, "takes_kernel", lambda *args, **kw: False)
    kernels.reset_launch_counts()
    want = [fused.run_stages(eager, order) for _ in range(frames)]
    assert kernels.launches["pairs"] == 0 and kernels.launches["band"] == frames
    for (img, ctr), (img2, ctr2) in zip(outs, want):
        assert torch.equal(img, img2) and torch.equal(ctr, ctr2)
    assert torch.equal(state.buf.pos_x, other.buf.pos_x)
    rows = state.particles.capacity * params.band
    assert 0 < params.retina_budget < params.pair_budget < rows


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(PAIR_SHAPES))
def test_frame_pairs_retina_prefix_matches_plain(cuda_device, shape, monkeypatch):
    """prepare_pixel_pass at the retarded cells' budgets (pair 262,144 /
    131,072, retina 16,384): the retina's prefix of boundary rows, the
    pixel pass's CSR and every RenderDiag field bit-equal with the kernel
    and with the plain chain (one pairs launch, then none)."""
    from spacetime_tpu_torch.checks import calls_of

    buf, obj_index, objects, boundary, cam = _pair_scene(cuda_device, PAIR_SHAPES[shape])
    budget = 262144 if shape == "refdemo" else 131072
    params = _params(band=4, segments=3 if shape == "refdemo" else 0, max_age=0,
                     pair_budget=budget, retina_budget=16384, num_rays=4096)
    runs = {}
    for path in ("kernel", "plain"):
        if path == "plain":
            monkeypatch.setattr(pairs_cuda, "takes_kernel", lambda *args, **kw: False)
        kernels.reset_launch_counts()
        seen = []
        (args,) = calls_of(retina_cuda, "retina_march", lambda: seen.append(
            raytrace.prepare_pixel_pass(buf, obj_index, objects, cam, 960, 540, params,
                                        boundary=boundary)))
        assert kernels.launches["pairs"] == (path == "kernel")
        runs[path] = (args[0], *seen[0])
    (rk, ik, dk), (rp, ip, dp) = runs["kernel"], runs["plain"]
    assert not pairs_unequal((rk, None, None), (rp, None, None))
    for name in ("entries", "cell_lo", "cell_hi", "sfq", "scal"):
        assert torch.equal(_bits(getattr(ik, name)), _bits(getattr(ip, name))), name
    for name, a, b in zip(dk._fields, dk, dp):
        assert (a is None and b is None) or torch.equal(a, b), name
    assert rp.pair_valid.any() and dp.retina_dropped is not None and int(dp.pairs_used) > 0


def _scratch_clean(device, width, height) -> bool:
    winner, mask = points_cuda.scratch(torch.device(device), torch.cuda.current_stream().cuda_stream,
                                       width, height)
    return bool((winner == points_cuda.EMPTY).all()) and not bool(mask.any())


@pytest.mark.cuda
@pytest.mark.parametrize("zoom", [0.15, 2.0])
def test_points_kernel_matches_plain(cuda_device, zoom):
    """Bit-equal, with shared pixels (zoom 2.0) and without; the scratch is
    back at EMPTY and 0 after the render."""
    p, objects, _, _ = _frame(cuda_device, frames=1)
    cam = Camera.create(pos=(0.38, 0.41), zoom=zoom, device=cuda_device)
    kernels.reset_launch_counts()
    ours = points_cuda.render_points(p, objects, cam, 96, 64)
    plain = points_cuda.render_points_plain(p, objects, cam, 96, 64)
    assert kernels.launches["points"] == 1
    assert torch.equal(ours, plain)
    assert (plain != 1.0).any()
    assert _scratch_clean(cuda_device, 96, 64)


@pytest.mark.cuda
def test_points_kernel_leaves_no_stale_scratch(cuda_device):
    """Repeated renders with a moving camera, then at another resolution,
    then of a scene of another capacity: each bit-equal to plain, the
    scratch clean after each (a winner or a bit left over would colour a
    pixel of the next render)."""
    p, objects, _, _ = _frame(cuda_device, frames=1)
    for i in range(6):
        cam = Camera.create(pos=(0.36 + 0.01 * i, 0.41 - 0.005 * i), zoom=0.3 + 0.2 * i,
                            device=cuda_device)
        assert torch.equal(points_cuda.render_points(p, objects, cam, 96, 64),
                           points_cuda.render_points_plain(p, objects, cam, 96, 64))
        assert _scratch_clean(cuda_device, 96, 64)
    cam = Camera.create(pos=(0.38, 0.41), zoom=0.5, device=cuda_device)
    for w, h in ((97, 61), (64, 96)):
        assert torch.equal(points_cuda.render_points(p, objects, cam, w, h),
                           points_cuda.render_points_plain(p, objects, cam, w, h))
        assert _scratch_clean(cuda_device, w, h)
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(7, 0, (0.38, 0.41), (0.0, 0.0), lattice_pad=True),
           base_color=(0.2, 0.9, 0.4))
    big, big_objects = sb.build(capacity=1000, device=cuda_device)
    assert big.capacity != p.capacity
    ours = points_cuda.render_points(big, big_objects, cam, 64, 96)
    assert torch.equal(ours, points_cuda.render_points_plain(big, big_objects, cam, 64, 96))
    assert (ours != 1.0).any() and _scratch_clean(cuda_device, 64, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inactive", "one_pixel", "ragged"])
def test_points_kernel_cases(cuda_device, case):
    """Bit-equal to plain with every particle inactive (all white), with
    every particle on one pixel (the lowest active index's colour), and at
    97 x 61 (5,917 pixels: no multiple of 32 or of 4, so a partial mask
    word and scalar stores)."""
    p, objects, _, _ = _frame(cuda_device, frames=1)
    cam = Camera.create(pos=(0.38, 0.41), zoom=0.5, device=cuda_device)
    width, height = (97, 61) if case == "ragged" else (96, 64)
    if case == "inactive":
        p = dataclasses.replace(p, active=torch.zeros_like(p.active))
    if case == "one_pixel":
        p = dataclasses.replace(p, pos=torch.full_like(p.pos, 0.38))
    ours = points_cuda.render_points(p, objects, cam, width, height)
    plain = points_cuda.render_points_plain(p, objects, cam, width, height)
    assert torch.equal(ours, plain)
    covered = torch.nonzero((plain != 1.0).any(dim=0))
    if case == "inactive":
        assert covered.shape[0] == 0
    elif case == "one_pixel":
        first = int(torch.nonzero(p.active)[0, 0])
        y, x = covered[0].tolist()
        assert covered.shape[0] == 1
        assert torch.equal(ours[:, y, x], objects.base_color[p.object_index[first]])
    else:
        assert covered.shape[0] > 0
    assert _scratch_clean(cuda_device, width, height)


@pytest.mark.cuda
def test_points_failed_launch_drops_scratch(cuda_device, monkeypatch):
    """A launch that reports an error raises and drops the scratch it may
    have left half-written; the next render starts from fresh buffers and
    is bit-equal to plain."""
    p, objects, _, _ = _frame(cuda_device, frames=1)
    cam = Camera.create(pos=(0.38, 0.41), zoom=2.0, device=cuda_device)
    points_cuda.render_points(p, objects, cam, 96, 64)
    key = (cuda_device.index, torch.cuda.current_stream().cuda_stream)
    assert key in points_cuda._scratch

    class HalfDone:
        """Marks winner slots and mask bits as pass 1 would, then fails."""

        def points_launch(self, *args):
            _, _, winner, mask = points_cuda._scratch[key]
            winner[:50] = 0
            mask[:2] = -1
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(kernels, "library", lambda: HalfDone())
    with pytest.raises(RuntimeError, match="points failed to launch"):
        points_cuda.render_points(p, objects, cam, 96, 64)
    assert key not in points_cuda._scratch
    monkeypatch.undo()
    ours = points_cuda.render_points(p, objects, cam, 96, 64)
    assert torch.equal(ours, points_cuda.render_points_plain(p, objects, cam, 96, 64))
    assert _scratch_clean(cuda_device, 96, 64)


# --------------------------------------------------------------------------
# the fused frame's CUDA graphs
# --------------------------------------------------------------------------


def _fused_state(device, frames=3):
    """A FrameState over _frame's scene (the discs near contact), and the
    model and objects, for the fused frame's stages."""
    p, objects, buf, cam = _frame(device, frames)
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                          device=device)
    return fused.new_state(p, buf, cam, H * frames), model, objects


def _stages(state, model, objects, params, mode="retarded"):
    return fused.frame_stages(model, None, state, objects, 96, 64, params, mode, H)


@pytest.mark.cuda
@pytest.mark.parametrize("spf", [1, 2])
def test_fused_graph_replays_bit_equal_to_eager(cuda_device, spf):
    """The same frames as CUDA graph replays and eagerly, from copies of one
    state: positions, velocities, bonds, ring, clock, images and counters
    bit-equal (every kernel is deterministic); one capture, then replays,
    with the launches of each replayed graph counted (4 collision, 4
    bond_stage and 1 step_finish a tick, 1 band, 1 retina march and 1
    pixel pass a frame; the retina reads t_now, which moves every frame,
    on the device)."""
    state, model, objects = _fused_state(cuda_device)
    other = fused.copy_state(state)
    params = _params()
    order = fused.schedule(spf)
    graph = fused.FusedFrame(_stages(state, model, objects, params), order, cuda_device)
    eager = _stages(other, model, objects, params)
    frames = 5
    kernels.reset_launch_counts()
    outs = [graph() for _ in range(frames)]
    counts = dict(kernels.launches)
    want = [fused.run_stages(eager, order) for _ in range(frames)]
    assert (graph.stats["captures"], graph.stats["replays"]) == (1, frames - 1)
    assert graph.stats["capture_s"] > 0
    assert counts["collision"] == 4 * spf * frames and counts["band"] == frames
    assert counts["bond_stage"] == 4 * spf * frames and counts["step_finish"] == spf * frames
    assert counts["pixel_pass"] == frames and counts["retina_march"] == frames
    for (img, ctr), (img2, ctr2) in zip(outs, want):
        assert torch.equal(img, img2) and torch.equal(ctr, ctr2)
    assert outs[0].__class__ is tuple and outs[0][0].data_ptr() != outs[1][0].data_ptr()
    for a, b in ((state.particles, other.particles), (state.buf, other.buf)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x is None or torch.equal(x, y), f.name
    assert torch.equal(state.frame_in, other.frame_in) and torch.equal(state.aux, other.aux)


@pytest.mark.cuda
def test_engine_captures_once_per_render_params_key(cuda_device):
    """A fused CUDA Engine: every frame after a key's first replays its
    graphs; a zoom across the cell ladder captures a new key, revisiting the
    old zoom replays the old one; launches count per replay."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=raytrace.RenderParams(num_rays=256), width=48, height=48, history=32)
    eng = Engine(cfg, device=cuda_device)
    kernels.reset_launch_counts()
    eng.run(3)
    assert (eng.graph_stats["captures"], eng.graph_stats["replays"]) == (1, 2)
    for zoom, captures in ((0.02, 2), (1.0, 2), (0.02, 2)):
        eng.camera = Camera.create(pos=(0.45, 0.45), zoom=zoom, device=cuda_device)
        eng.run(2)
        assert eng.graph_stats["captures"] == captures, zoom
    assert eng.graph_stats["replays"] == 9 - 2
    assert kernels.launches["collision"] == 4 * 9 and kernels.launches["band"] == 9
    assert kernels.launches["pixel_pass"] == 9 and len(eng._fused_cache) == 2


@pytest.mark.cuda
def test_points_graph_scratch_untouched_by_eager_calls(cuda_device):
    """The points Engine's graphs keep their own scratch (made on the
    graphs' stream before the capture); eager renders on the current stream
    between replays, at other sizes and cameras, leave the replays
    bit-equal to the plain renderer and every scratch clean."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 400, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),)),
        width=96, height=64, history=16, render_mode="points", cam_zoom=0.3,
        cam_pos=(0.46, 0.45))
    eng = Engine(cfg, device=cuda_device)
    eng.run(2)
    graph_scratch = points_cuda.held(cuda_device, eng._graph_stream.cuda_stream)
    assert graph_scratch is not None
    for i in range(3):
        cam = Camera.create(pos=(0.4 + 0.02 * i, 0.45), zoom=0.5 + 0.3 * i, device=cuda_device)
        assert torch.equal(points_cuda.render_points(eng.particles, eng.objects, cam, 64, 96),
                           points_cuda.render_points_plain(eng.particles, eng.objects, cam,
                                                           64, 96))
        eng.render()
        img = eng.run_frame().permute(2, 0, 1)
        plain = points_cuda.render_points_plain(eng.particles, eng.objects, eng.camera, 96, 64)
        assert torch.equal(img, plain) and (plain != 1.0).any()
    assert eng.graph_stats["replays"] == 4
    winner, mask = graph_scratch
    assert bool((winner == points_cuda.EMPTY).all()) and not bool(mask.any())
    assert _scratch_clean(cuda_device, 96, 64) and _scratch_clean(cuda_device, 64, 96)


@pytest.mark.cuda
def test_engine_capture_failure_raises(cuda_device, monkeypatch):
    """A render that reads a device value on the host cannot be captured:
    the Engine raises, and never carries on eagerly."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=raytrace.RenderParams(num_rays=256), width=48, height=48, history=32)
    eng = Engine(cfg, device=cuda_device)
    render = raytrace.render_retarded_with_diag

    def syncing(*args, **kwargs):
        img, diag = render(*args, **kwargs)
        int(diag.pairs_used)  # a host read: refused under capture
        return img, diag

    monkeypatch.setattr(raytrace, "render_retarded_with_diag", syncing)
    with pytest.raises(RuntimeError):
        eng.run_frame()
    assert eng.graph_stats["captures"] == 0 and eng.graph_stats["replays"] == 0


def _innermost_of_each_launch(events):
    """[(launching call, innermost range or None)] for each device op of a
    Chrome trace (the range open on the launching thread at the launch)."""
    launches, ranges = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = e
        elif e.get("cat") == "user_annotation":
            ranges.setdefault(e["tid"], []).append((e["ts"], e["ts"] + e["dur"], e["name"]))
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        call = launches.get(e.get("args", {}).get("correlation"))
        if call is None:
            continue
        inside = [r for r in ranges.get(call["tid"], ()) if r[0] <= call["ts"] <= r[1]]
        out.append((call["name"], max(inside, key=lambda r: (r[0], -r[1]))[2]
                    if inside else None))
    return out


@pytest.mark.cuda
def test_traced_fused_frames_keep_the_stage_ranges(cuda_device, monkeypatch):
    """Traced fused Engine frames on the card: each `engine.wait.prev_frame`
    span lies inside an `engine.frame`; the graph replays' kernels fall
    under step / worldline / render (no span opens inside a stage range
    around a replay); and the device ops a frame under `step` and
    `render` are as many as in a trace without the Engine's spans."""
    from spacetime_tpu_torch import engine as engine_mod
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils import profiling
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=raytrace.RenderParams(num_rays=256), width=48, height=48, history=32)
    eng = Engine(cfg, device=cuda_device)
    eng.run(3)
    frames = 4

    def traced():
        for _ in range(frames):
            eng.run_frame()
        torch.cuda.synchronize()

    events = profiling.traced_events(traced)
    assert eng.graph_stats["captures"] == 1
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    frame_spans = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in spans
                   if e["name"] == "engine.frame"]
    waits = [e for e in spans if e["name"] == "engine.wait.prev_frame"]
    assert len(frame_spans) == len(waits) == frames
    for w in waits:
        assert any(t == w["tid"] and a <= w["ts"] and w["ts"] + w["dur"] <= b
                   for t, a, b in frame_spans)
    assert {"engine.wait.staging", "engine.outputs", "engine.adapt"} <= {e["name"] for e in spans}
    replayed = [label for call, label in _innermost_of_each_launch(events)
                if call == "cudaGraphLaunch"]
    assert replayed and set(replayed) <= {"step", "worldline", "render"}
    with_spans = profiling.attribute(events, frames)["by_range"]

    monkeypatch.setattr(engine_mod, "span", lambda name: contextlib.nullcontext())
    bare = profiling.traced_events(traced)
    assert not any(e.get("name", "").startswith("engine.") for e in bare)
    without = profiling.attribute(bare, frames)["by_range"]
    for stage in ("step", "render"):
        assert with_spans[stage][1] == without[stage][1] > 0, stage


# --------------------------------------------------------------------------
# segments, the 2x2 splat, retina, views, aloof bodies, Euler
# --------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("camera_frame", [False, True], ids=["ground", "camera_frame"])
@pytest.mark.parametrize("change", [dict(splat_cells=4), dict(segments=2),
                                    dict(splat_cells=4, segments=2, band=4)],
                         ids=["splat4", "segments", "both"])
def test_pixel_kernel_on_compacted_and_2x2_csr_matches_plain(cuda_device, camera_frame, change):
    """The pixel kernel on a 2x2-splat CSR (4 entries a pair, fewer and
    differently spread a cell) and on rank-compacted pair rows, against
    the plain version: the pixel gate, and two launches bit-equal."""
    p, objects, buf, cam = _frame(cuda_device)
    if camera_frame:
        cam = Camera.create(pos=(0.38, 0.41), zoom=0.15, vel=(0.5, 0.1), device=cuda_device)
    params = _params(cell_px=16, occlusion_downsample=2, camera_frame=camera_frame, **change)
    inputs, diag = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 96, 64, params,
                                               boundary=wl.boundary_mask(p))
    if "segments" in change:
        assert diag.segment_dropped is not None
    ours = render_cuda.pixel_pass(inputs, params, width=96, height=64)
    plain = render_cuda.pixel_pass_plain(inputs, params, width=96, height=64)
    assert (plain < 0.99).float().mean() > 0.02
    assert _mismatch(ours, plain) <= PIXEL_SHARE
    assert torch.equal(ours, render_cuda.pixel_pass(inputs, params, width=96, height=64))


@pytest.mark.cuda
def test_retina_and_views_on_card_match_cpu(cuda_device):
    """render_retina (the band kernel, unculled) and render_views (B band
    and B pixel launches) on the card against the CPU path."""
    out = {}
    for dev in ("cpu", cuda_device):
        p, objects, buf, cam = _frame(dev)
        moving = Camera.create(pos=(0.38, 0.41), zoom=0.15, vel=(0.5, 0.0), device=dev)
        params = _params()
        kernels.reset_launch_counts()
        strip = raytrace.render_retina(buf, p.object_index, objects, moving, params, height=8)
        band = kernels.launches["band"]
        from spacetime_tpu_torch.camera import stack_cameras

        cams = [cam, Camera.create(pos=(0.40, 0.40), zoom=0.2, device=dev), moving]
        kernels.reset_launch_counts()
        views = raytrace.render_views(buf, p.object_index, objects, stack_cameras(cams), 96, 64,
                                      params, boundary=wl.boundary_mask(p))
        launches = dict(kernels.launches)
        singles = [raytrace.render_retarded(buf, p.object_index, objects, c, 96, 64, params,
                                            boundary=wl.boundary_mask(p)) for c in cams]
        assert all(torch.equal(views[i], s) for i, s in enumerate(singles))
        out[str(dev)] = (strip.cpu(), views.cpu(), band, launches)
    (strip_c, views_c, _, _), (strip_g, views_g, band, launches) = out.values()
    assert band == 1 and launches["band"] == 3 and launches["pixel_pass"] == 3
    hit = (strip_c != 1.0).any(-1)
    assert hit.any() and torch.equal(hit, (strip_g != 1.0).any(-1))
    torch.testing.assert_close(strip_g, strip_c, rtol=1e-5, atol=1e-5)
    for a, b in zip(views_g, views_c):
        assert _mismatch(a.permute(2, 0, 1), b.permute(2, 0, 1)) <= PIXEL_SHARE


@pytest.mark.cuda
def test_euler_on_card_matches_cpu(cuda_device):
    """Euler steps on the card (one collision launch a step) against the
    CPU path."""
    out = {}
    for dev in ("cpu", cuda_device):
        p, _, _, _ = _frame(dev, frames=0)
        model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                              device=dev, integrator="euler")
        kernels.reset_launch_counts()
        for _ in range(4):
            p, aux = model.step(p)
        out[str(dev)] = (p.pos.cpu(), p.vel.cpu(), kernels.launches["collision"])
        assert int(aux.bonds_broken) == 0
    (pc, vc, _), (pg, vg, launches) = out.values()
    assert launches == 4
    torch.testing.assert_close(pg, pc, rtol=0, atol=1e-5)
    torch.testing.assert_close(vg, vc, **COLL)


@pytest.mark.cuda
def test_aloof_frame_graph_matches_eager_on_card(cuda_device):
    """An aloof scene's frame on the card: as CUDA graph replays (the
    injection captured in the worldline graph at the device clock) bit-equal
    to the same stages run eagerly from a copy of the state; the aloof
    slots at state_at(clock); and an Engine fused against one with eager
    stage-timed frames (host clock) within an ulp's reach."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.models.aloofbody import AloofBody, circular_trajectory, disc_template
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 30, (0.42, 0.42), (0.0, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=raytrace.RenderParams(num_rays=256), width=48, height=48, history=32,
        cam_zoom=0.3)
    make = lambda c=cfg: Engine(c, device=cuda_device, aloof_bodies=[
        AloofBody(disc_template(2), circular_trajectory((0.55, 0.5), 0.02, 0.3), object_index=5)])
    eng = make()
    state, other = eng._state, fused.copy_state(eng._state)
    params = eng._render_params()
    stages = lambda st: fused.frame_stages(eng.model, None, st, eng.objects, 48, 48, params,
                                           "retarded", H, aloof=eng._aloof, present=eng.present)
    order = fused.schedule(1)
    graph = fused.FusedFrame(stages(state), order, cuda_device)
    eager = stages(other)
    for _ in range(5):
        a, b = graph(), fused.run_stages(eager, order)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (graph.stats["captures"], graph.stats["replays"]) == (1, 4)
    assert torch.equal(state.particles.pos, other.particles.pos)
    assert torch.equal(state.buf.pos_x, other.buf.pos_x)
    lo, hi = eng._aloof_slice
    pos, _ = eng.aloof_bodies[0].state_at(state.frame_in[5])
    assert torch.equal(state.particles.pos[lo:hi], pos)
    fused_eng, timed = make(), make(dataclasses.replace(cfg, stage_timing=True))
    for _ in range(5):
        img_f, img_t = fused_eng.run_frame(), timed.run_frame()
        assert _mismatch(img_f.permute(2, 0, 1), img_t.permute(2, 0, 1)) <= PIXEL_SHARE
    assert fused_eng.graph_stats["captures"] == 1 and timed.graph_stats["eager"] == 5
    torch.testing.assert_close(fused_eng.particles.pos, timed.particles.pos, rtol=0, atol=1e-6)


def _conical_on_both(cuda_device, centers, opaque):
    """The conical render with two defects (deficits 4 and 3 at `centers`)
    on the CPU and on the card from one ring: (CPU image, card image, CPU
    diag, card diag, card launches, camera); route 1's band window on the
    card bit-equal to the plain sweep's."""
    from spacetime_tpu_torch.ops import curved

    out = {}
    state = _frame("cpu")  # one ring for both devices
    for dev in ("cpu", cuda_device):
        p, objects, buf, cam = (x.to(dev) for x in state)
        defects = tuple(curved.ConicalDefect.create(c, k, device=dev)
                        for c, k in zip(centers, (4.0, 3.0)))
        params = _params(opaque=opaque, max_age=0, pair_budget=2048, bin_capacity=384)
        kernels.reset_launch_counts()
        img, diag = curved.render_retarded_conical_with_diag(buf, p.object_index, objects, cam,
                                                             defects, 96, 64, params, planar=True)
        out[str(dev)] = (img.cpu(), [None if v is None else int(v) for v in diag],
                         dict(kernels.launches))
        if dev != "cpu":
            ours = band_cuda.cone_band_window(buf, params, cam)
            plain = band_cuda.cone_band_window_plain(buf, params, cam)
            assert all(torch.equal(a, b) for a, b in zip(ours, plain))
    (img_c, diag_c, _), (img_g, diag_g, launches) = out.values()
    return img_c, img_g, diag_c, diag_g, launches, state[3]


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_conical_on_card_matches_cpu(cuda_device, opaque):
    """The conical render with two defects on the card (route 1 on the band
    kernel, one launch a render; route 2 on the plain sweep; no pixel
    launch) against the CPU path: the diag counters equal, the pixel gate;
    route 1's band window bit-equal to the plain sweep's.  The defects sit
    off the matter, the renderer's stated regime (near a defect the routes
    degenerate and an ulp picks the image)."""
    img_c, img_g, diag_c, diag_g, launches, _ = _conical_on_both(
        cuda_device, ((0.43, 0.37), (0.33, 0.45)), opaque)
    assert launches["band"] == 1 and launches["pixel_pass"] == 0
    assert diag_g == diag_c and diag_c[0] > 0 and diag_c[2] == 0
    assert (img_c < 0.99).any() and _mismatch(img_g, img_c) <= PIXEL_SHARE


def _retina_edge_or_seam(cam, centers, params, width, height):
    """(H, W) mask of the pixels whose image an ulp can flip: a route's
    retina bearing within 1e-3 of a bin edge (the card's pixel centres and
    atan2 round otherwise than the CPU's, and the pixel reads the next
    bin), or the pixel's route-2 bearing within 1e-4 rad of the seam at
    d_phi = 0 or pi (its rotation sign flips)."""
    from spacetime_tpu_torch.camera import pixel_centers
    from spacetime_tpu_torch.ops import curved

    pc = pixel_centers(width, height, cam).double()
    px, py = pc[..., 0], pc[..., 1]
    cx, cy = cam.pos.double()

    def on_edge(x, y):
        u = (torch.atan2(y - cy, x - cx) + np.pi) / (2 * np.pi) * params.num_rays
        return (u - u.round()).abs() < 1e-3

    mask = on_edge(px, py)
    for c, k in zip(centers, (4.0, 3.0)):
        d = curved.ConicalDefect.create(c, k, device="cpu")
        dc = d.center.double()
        bearing = torch.atan2(py - dc[1], px - dc[0]) - torch.atan2(cy - dc[1], cx - dc[0])
        theta = curved._route2_theta(px.float(), py.float(), cam, d).double()
        rx = dc[0] + torch.cos(theta) * (px - dc[0]) - torch.sin(theta) * (py - dc[1])
        ry = dc[1] + torch.sin(theta) * (px - dc[0]) + torch.cos(theta) * (py - dc[1])
        mask |= (torch.sin(bearing).abs() < 1e-4) | on_edge(rx, ry)
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_conical_on_card_among_the_discs_differs_only_at_retina_edges(cuda_device, opaque):
    """The two-defect render with the defects among the discs' matter, on
    the card against the CPU: the diag counters equal, and every pixel
    that differs lies where an ulp picks the result (see
    _retina_edge_or_seam).  On this scene those are the pixels on the
    camera's 45-degree diagonals: their bearing falls exactly on retina
    bin edges 64 and 320 of 512, and on the card the opaque render reads
    the neighbouring bin for some of them."""
    centers = ((0.40, 0.43), (0.33, 0.38))
    img_c, img_g, diag_c, diag_g, launches, cam = _conical_on_both(cuda_device, centers, opaque)
    assert launches["band"] == 1 and launches["pixel_pass"] == 0
    assert diag_g == diag_c and diag_c[0] > 0 and diag_c[2] == 0
    differs = (img_g - img_c).abs().amax(dim=0) > PIXEL_TOL
    mask = _retina_edge_or_seam(cam, centers, _params(), 96, 64)
    assert (img_c < 0.99).any() and mask.float().mean() < 0.05
    assert not (differs & ~mask).any(), (differs & ~mask).nonzero().tolist()


@pytest.mark.cuda
def test_worldline3d_on_card_matches_cpu(cuda_device):
    """The worldline3d view on the card against the CPU path, and its fused
    Engine frames as graphs (collision launches only)."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.ops import worldline3d
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    out = {}
    state = _frame("cpu")
    for dev in ("cpu", cuda_device):
        p, objects, buf, cam = (x.to(dev) for x in state)
        view = worldline3d.Worldline3DParams(time_scale=3.0, fade=0.5, age_stride=2)
        out[str(dev)] = worldline3d.render_worldline3d(
            buf, p.object_index, objects, cam, 96, 64, view, active=p.active,
            boundary=wl.boundary_mask(p), planar=True).cpu()
    img_c, img_g = out.values()
    assert (img_c < 0.99).any() and _mismatch(img_g, img_c) <= PIXEL_SHARE
    cfg = EngineConfig(scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0),
                                                (0.2, 0.2, 1.0)),), capacity=256),
                       width=48, height=48, history=32, render_mode="worldline3d")
    eng = Engine(cfg, device=cuda_device)
    kernels.reset_launch_counts()
    eng.run(5)
    torch.cuda.synchronize()
    assert eng.graph_stats["captures"] == 1 and eng.graph_stats["replays"] == 4
    assert kernels.launches["collision"] == 20 and kernels.launches["band"] == 0


# --------------------------------------------------------------------------
# the RK4 step's stage and finish kernels (csrc/step.cu) against the plain
# functions: on the CPU the wrappers take the plain versions, on the card
# the kernels
# --------------------------------------------------------------------------

# bond layouts: the padded lattice's shifted table (one offset a slot), the
# unpadded discs' table cut to 3 offsets a slot (4 do occur: some valid
# slots then match none and are no bond), and the row-gather physics
LAYOUTS = ("shifted", "shifted_wide", "rows")
STAGE_MATS = ("none", "k_scale", "k_scale_damping")
# a break threshold that the lattice's bonds straddle at the jittered positions
BREAK_P = dataclasses.replace(P, bond_break_threshold=0.0036)


def _stage_inputs(device, layout, mats, rest, block):
    """(StepPlanes, stage positions, collision forces) over the overlapping
    discs, everything else drawn from numpy: velocities, the materials of
    `mats` (a break scale with any of them), per-slot or per-bond rest
    lengths (`rest`; per bond they creep, with yield strains), and with
    `block` the rows [64, 192) of a mesh rank against the global planes."""
    p, pos = _overlapping(device, lattice_pad=layout == "shifted")
    n = p.capacity
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)
    offsets = None
    if layout != "rows":
        offsets = forces.spring_offsets_tensor(
            forces.derive_spring_offsets(p.neighbors.cpu().numpy()), device)
        offsets = offsets[:, :3].contiguous() if layout == "shifted_wide" else offsets
    slots = P.rest_lengths()
    per_bond = t(slots[None, :] * rng.uniform(0.9, 1.1, (n, 8)))
    lo, hi = (64, 192) if block else (0, n)
    own = slice(lo, hi)
    planes = rk4.StepPlanes(
        pos0=pos[own], gpos0=pos, vel0=t(rng.uniform(-0.3, 0.3, (n, 2)))[own],
        gvel0=t(rng.uniform(-0.3, 0.3, (n, 2))), rest_mass=p.rest_mass[own],
        active=p.active[own], neighbors=p.neighbors[own].contiguous(), offsets=offsets,
        rest=t(slots) if rest == "slot" else per_bond[own].contiguous(), row0=lo,
        k_pp=None if mats == "none" else t(rng.uniform(0.5, 2.0, n)),
        c_pp=t(rng.uniform(0.0, 0.4, n)) if mats == "k_scale_damping" else None,
        break_scale=None if mats == "none" else t(rng.uniform(0.8, 1.2, n)),
        creep_rate=t(rng.uniform(0.0, 5.0, n)) if rest == "bond" else None,
        yield_strain=t(rng.uniform(0.0, 0.05, n)) if rest == "bond" else None)
    # the start velocities of the block's rows are the global plane's
    planes = planes._replace(gvel0=planes.gvel0.clone())
    planes.gvel0[own] = planes.vel0
    moved, _ = _moved(pos, p.active, 3e-4)
    return planes, moved, t(rng.normal(0.0, 5.0, (hi - lo, 2)))


def _bonded_expected(planes, params, gpos):
    """The plain functions' bonded force on the block at `gpos`, (B, 2)."""
    px, py = gpos[:, 0], gpos[:, 1]
    vx, vy = planes.gvel0[:, 0], planes.gvel0[:, 1]
    nbr, rest, row0 = planes.neighbors, planes.rest, planes.row0
    if planes.offsets is None:
        fx, fy = forces.spring_forces_rows(px, py, nbr, rest, params.k, k_pp=planes.k_pp,
                                           c_pp=planes.c_pp, vx=vx, vy=vy, row0=row0)
        return torch.stack([fx, fy], dim=-1)
    sfx, sfy = forces.spring_forces_shifted(px, py, nbr, planes.offsets, rest, params.k,
                                            k_pp=planes.k_pp, row0=row0)
    bfx, bfy = forces.bonded_repulsion_shifted(px, py, nbr, planes.offsets, CD, REP, row0=row0)
    fx, fy = sfx - bfx, sfy - bfy
    if planes.c_pp is not None:
        dfx, dfy = forces.bond_damping_shifted(px, py, vx, vy, nbr, planes.offsets,
                                               planes.c_pp, row0=row0)
        fx, fy = fx + dfx, fy + dfy
    return torch.stack([fx, fy], dim=-1)


def _check_stage(device, layout, mats, rest, block):
    """bond_stage and step_finish through their wrappers against the plain
    functions on `device`: the bonded force, the accumulator and bond
    breaking and creep exactly, the next positions within an f32 rounding
    of the acceleration, the displacement fold exactly against the plain
    amax over those positions.  Returns the launches it counted."""
    planes, moved, coll = _stage_inputs(device, layout, mats, rest, block)
    kernels.reset_launch_counts()
    zero = torch.zeros_like(coll)
    bonded = rk4.bond_stage(planes, BREAK_P, moved, zero, None, 0).facc
    assert torch.equal(bonded, _bonded_expected(planes, BREAK_P, moved))
    assert bonded.abs().max() > 1.0
    f = coll + _bonded_expected(planes, BREAK_P, moved)
    prev = coll * 0.5
    for weight, want in ((0, f), (2, prev + 2.0 * f), (1, prev + f)):
        disp = torch.zeros(2, device=device)
        out = rk4.bond_stage(planes, BREAK_P, moved, coll, prev, weight, H / 2.0, disp=disp)
        assert torch.equal(out.facc, want) and out.neighbors is None and out.rest_len is None
        nxt, _ = rk4._advance(planes.pos0, planes.vel0, f, planes.rest_mass, H / 2.0)
        torch.testing.assert_close(out.next_pos, nxt, rtol=0, atol=1e-6)
        moved_by = torch.where(planes.active[:, None], (out.next_pos - planes.pos0).abs(), 0.0)
        assert torch.equal(disp, moved_by.amax(dim=0)) and disp.min() > 0
    # the first evaluation, at the start positions: bonds break, rest lengths creep
    broken = torch.zeros((), dtype=torch.int32, device=device)
    out = rk4.bond_stage(planes, BREAK_P, planes.gpos0, coll, None, 0, H / 2.0, broken=broken)
    if planes.offsets is None:
        nbr, n = rk4.break_bonds(planes.gpos0, planes.neighbors, BREAK_P.bond_break_threshold,
                                 break_scale=planes.break_scale, row0=planes.row0)
    else:
        nbr, n = rk4.break_bonds_shifted(planes.gpos0, planes.neighbors, planes.offsets,
                                         BREAK_P.bond_break_threshold,
                                         break_scale=planes.break_scale, row0=planes.row0)
    assert torch.equal(out.neighbors, nbr) and int(broken) == int(n)
    assert 0 < int(n) < int((planes.neighbors >= 0).sum())
    if rest == "bond":
        if planes.offsets is None:
            crept = forces.creep_rest_lengths_rows(planes.gpos0, planes.neighbors, planes.rest,
                                                   planes.creep_rate, planes.yield_strain, H,
                                                   row0=planes.row0)
        else:
            crept = forces.creep_rest_lengths_shifted(
                planes.gpos0[:, 0], planes.gpos0[:, 1], planes.neighbors, planes.offsets,
                planes.rest, planes.creep_rate, planes.yield_strain, H, row0=planes.row0)
        assert torch.equal(out.rest_len, crept) and not torch.equal(crept, planes.rest)
    else:
        assert out.rest_len is None
    for euler in (False, True):
        pos, vel = rk4.step_finish(planes, BREAK_P, out.facc, euler=euler)
        want_pos, want_vel = rk4.step_finish_plain(planes, BREAK_P, out.facc, euler=euler)
        torch.testing.assert_close(pos, want_pos, rtol=0, atol=1e-6)
        torch.testing.assert_close(vel, want_vel, rtol=1e-5, atol=1e-6)
        assert torch.equal(pos[~planes.active], planes.pos0[~planes.active])
    return dict(kernels.launches)


@pytest.mark.parametrize("layout, mats, rest, block", [
    ("rows", "none", "slot", False),
    ("shifted", "k_scale_damping", "bond", True),
], ids=["dispatch", "break_and_creep"])
def test_step_wrappers_take_the_plain_path_on_cpu(layout, mats, rest, block):
    """CPU tensors: bond_stage and step_finish are the plain functions, and
    no kernel launch is counted; the first evaluation breaks bonds and,
    with per-bond rest lengths, creeps them (on a mesh block).  The card
    test below runs the whole matrix against the kernels."""
    counts = _check_stage("cpu", layout, mats, rest, block)
    assert counts["bond_stage"] == 0 and counts["step_finish"] == 0


def _stage_args(**change):
    """bond_stage_launch's arguments on CPU tensors with `change` applied
    (planes fields, or gpos / coll / facc / weight / h_adv / disp /
    broken)."""
    planes, gpos, coll = _stage_inputs("cpu", "shifted", "none", "slot", False)
    args = dict(gpos=gpos, coll=coll, facc=None, weight=0, h_adv=H / 2.0, disp=None,
                broken=None)
    fields = {k: v for k, v in change.items() if k in rk4.StepPlanes._fields}
    args.update({k: v for k, v in change.items() if k not in fields})
    return planes._replace(**fields), args


def _misaligned(nbr):
    flat = torch.zeros(nbr.numel() + 1, dtype=torch.int32)
    out = flat[1:].view(nbr.shape)
    out.copy_(nbr)
    return out


@pytest.mark.parametrize("case", ["misaligned", "wide_offsets", "weight", "facc", "start",
                                  "creep_per_slot", "disp", "rows", "dtype"])
def test_step_launchers_refuse_what_the_kernels_cannot_run(case):
    """ops/step_cuda's checks raise before any launch (here before the
    library would load): a neighbour table the kernel cannot load by 16
    bytes, an offset table wider than 8, an unknown weight, a missing
    accumulator, bond breaking away from the start positions, creep of
    per-slot rest lengths, a displacement fold with no next positions, a
    block past the global planes, an f64 plane."""
    planes, _, _ = _stage_inputs("cpu", "shifted", "none", "slot", False)
    change = {
        "misaligned": dict(neighbors=_misaligned(planes.neighbors)),
        "wide_offsets": dict(offsets=planes.offsets.repeat(1, 9)),
        "weight": dict(weight=3),
        "facc": dict(weight=2),
        "start": dict(broken=torch.zeros((), dtype=torch.int32)),
        "creep_per_slot": dict(creep_rate=torch.ones(planes.gpos0.shape[0])),
        "disp": dict(h_adv=None, disp=torch.zeros(2)),
        "rows": dict(row0=100),
        "dtype": dict(rest_mass=planes.rest_mass.double()),
    }[case]
    planes, args = _stage_args(**change)
    with pytest.raises(ValueError):
        step_cuda.bond_stage_launch(planes, P, **args)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [False, True], ids=["whole", "block"])
@pytest.mark.parametrize("rest", ["slot", "bond"])
@pytest.mark.parametrize("mats", STAGE_MATS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_kernels_match_plain(cuda_device, layout, mats, rest, block):
    """On the card bond_stage's bonded force and accumulator are bit-equal
    to the plain functions on the same CUDA tensors (csrc/ builds with
    -fmad=false), its broken bonds and crept rest lengths exactly equal,
    its displacement fold the plain amax; one launch a call."""
    counts = _check_stage(cuda_device, layout, mats, rest, block)
    assert counts["bond_stage"] == 5 and counts["step_finish"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_step_launch_counts_on_card(cuda_device, integrator):
    """A step on the card: 4 bond_stage and 1 step_finish launch beside the
    4 collision launches (Euler: 1, 1 and 1), and the bonds an RK4 step
    broke as the plain break at its start positions."""
    p, _, _, _ = _frame(cuda_device, frames=0)
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                          params=dataclasses.replace(P, bond_break_threshold=0.0036),
                          device=cuda_device, integrator=integrator)
    kernels.reset_launch_counts()
    new, aux = model.step(p)
    evals = 4 if integrator == "rk4" else 1
    assert (kernels.launches["collision"], kernels.launches["bond_stage"],
            kernels.launches["step_finish"]) == (evals, evals, 1)
    if integrator == "rk4":
        nbr, n = rk4.break_bonds_shifted(p.pos, p.neighbors, model.spring_offsets, 0.0036)
        assert torch.equal(new.neighbors, nbr) and int(aux.bonds_broken) == int(n) > 0
    else:
        assert new.neighbors is p.neighbors and int(aux.bonds_broken) == 0
