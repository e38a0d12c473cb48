"""The port's CUDA kernels against their plain-torch versions, on the card.

This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

(`--noconftest`: tests/conftest.py configures jax).  Without a CUDA device
the `cuda` tests skip; the rest check the wrappers' refusals on the CPU.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from spacetime_tpu_torch import kernels, scene
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.constants import DEFAULT_PARAMS as P
from spacetime_tpu_torch.models.softbody import SoftbodyModel, default_bin_resolution
from spacetime_tpu_torch.ops import (band_cuda, forces, forces_cuda, grid, points_cuda, raytrace,
                                     render_cuda)
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


@pytest.mark.cuda
def test_pixel_kernel_wide_cells_match_plain(cuda_device):
    """Cells wider than 32 pixels (the Engine's ladder picks 48 and 64 at
    deep zoom-in) take more pixels than a block's 1024 threads."""
    p, objects, buf, cam = _frame(cuda_device)
    params = _params(cell_px=48, occlusion_downsample=2)
    inputs, _ = raytrace.prepare_pixel_pass(buf, p.object_index, objects, cam, 96, 64, params,
                                            boundary=wl.boundary_mask(p))
    ours = render_cuda.pixel_pass(inputs, params, width=96, height=64)
    plain = render_cuda.pixel_pass_plain(inputs, params, width=96, height=64)
    assert (plain < 0.99).float().mean() > 0.05
    assert _mismatch(ours, plain) <= PIXEL_SHARE


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


@pytest.mark.cuda
@pytest.mark.parametrize("zoom", [0.15, 2.0])
def test_points_kernel_matches_plain(cuda_device, zoom):
    """Bit-equal, with shared pixels (zoom 2.0) and without."""
    p, objects, _, _ = _frame(cuda_device, frames=1)
    cam = Camera.create(pos=(0.38, 0.41), zoom=zoom, device=cuda_device)
    kernels.reset_launch_counts()
    ours = points_cuda.render_points(p, objects, cam, 96, 64)
    plain = points_cuda.render_points_plain(p, objects, cam, 96, 64)
    assert kernels.launches["points"] == 1
    assert torch.equal(ours, plain)
    assert (plain != 1.0).any()
