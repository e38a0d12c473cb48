"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels of `spacetime_tpu_torch/csrc/` (one nvcc per
source, in parallel) and checks each against its plain-torch version at
the shapes its path gives it, then drives the port's paths through their
entry points, each with the launch counts set to 0 just before it and read
just after:

  * the headline frame (spacetime_tpu_torch/headline.py: the scene and
    RenderParams of bench.py, a two-disc lattice scene of 10,050 particles
    at capacity 13,312, a T=1024 worldline ring and a 1920x1080 opaque
    retarded render) for FRAMES = 200 frames, which takes the discs
    through their impact (contact at about frame 170): every collision,
    band and pixel-pass launch goes through the kernels, every
    render/step diagnostic counter stays 0, the image is finite and lit;
  * the Engine through its CLI (`cli.run`, the code of
    `python -m spacetime_tpu_torch`): `flagship_1080p` in retarded mode
    for ENGINE_FRAMES frames (the discs meet near frame 120 at a 0.9c
    closing speed), and in instant mode for INSTANT_FRAMES frames; after
    each run the band (retarded only) and pixel kernels are held against
    plain on the Engine's final state at the render params it chose (its
    adapted band and bin capacity, its max_age and cell size);
  * the Engine in points mode on the reference demo scene
    (headline.refdemo_config: 116,178 particles at capacity 149,248,
    1920x1080) for POINTS_FRAMES frames, its last frame bit-equal to the
    plain point renderer on the same state;
  * `boosted_observer` through the CLI's code path (two 3,000-particle
    discs, 512x512, the camera-frame view of a 0.5c camera) for
    BOOSTED_FRAMES frames: every frame 1 camera-frame pixel launch, 1 band
    launch and 4 collision launches, every render drop counter 0 over the
    run; then the band and camera-frame pixel kernels against plain on its
    final state at its own render params;
  * `plastic_collision` through the CLI's code path (two 3,000-particle
    discs of a creeping and a damped material closing at 0.24c) for
    PLASTIC_FRAMES frames, through the impact: the blue body's rest
    lengths grew, the red body's did not;
  * the row-gather physics at full width: `flagship_1080p` with
    `lattice_pad=False` (no spring offsets) through
    `Engine(..., device="cuda")` for ROWS_FRAMES retarded frames through
    the impact: 4 bond-excluding collision launches a frame and no
    include-variant launch; then that variant against plain on the final
    state at RK4 stage 3's positions;
  * small scenes on the GPU against the port's CPU path (which the tier-1
    tests hold against the JAX package): the headline frame's pieces, the
    Engine in all three modes, and tiny `plastic_collision`,
    `boosted_observer` and row-gather scenes.

Kernel times come from `spacetime_tpu_torch.utils.timing.cuda_ms`, which
keeps the host's enqueue out of the reading (a device spin covers it);
every kernel, plain and library reading uses it.  The band kernel is
timed with the L2 evicted before each call, as a frame finds its ring.
The card's launch floor, a trivial kernel timed the same way, is printed
on a line of its own.  The collision inputs at RK4 stage 3 and the
kernel-vs-plain comparisons are compare_kernels' own.

Output: one line per phase, then a JSON line of per-kernel results (each
with its bound: the larger of the bytes it must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s, the H100 SXM's published peaks, from
this run's inputs), the card's name and power limit from nvidia-smi, and
as the last line {"ok": true, "device": {...}}.  Any failure raises
(non-zero exit, no result line).  Needs CUDA: without it the script exits
1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from spacetime_tpu_torch.compare_kernels import (BAND_FIELDS, band_unequal, collision_error,
                                                 collision_inputs)
from spacetime_tpu_torch.utils.timing import cuda_ms, launch_floor_ms

FRAMES = 200  # the discs meet at about frame 170
ENGINE_FRAMES = 200  # flagship_1080p: the discs meet at about frame 120
INSTANT_FRAMES = 20
POINTS_FRAMES = 100
BOOSTED_FRAMES = 300
PLASTIC_FRAMES = 220  # the discs, 0.184 ls apart closing at 0.24c, meet near frame 153
ROWS_FRAMES = 200  # flagship_1080p unpadded: the discs meet near frame 120
SMALL_NEW_FRAMES = 8  # tiny new-config Engines, GPU vs CPU, through contact
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (published)
PEAK_F32 = 67e12  # H100 SXM f32 outside the tensor cores, op/s (published)
SMALL_FRAMES = 5  # frames of the small GPU-vs-CPU scene, through its impact
SMALL_ENGINE_FRAMES = 15  # frames of the tiny Engine config, GPU vs CPU
PIXEL_TOL = 1e-3  # per-pixel difference counted as a mismatch
PIXEL_SHARE = 1e-3  # largest share of mismatched pixels, kernel vs plain


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move `nbytes` and do `nops` f32 operations."""
    t_b, t_o = nbytes / PEAK_BYTES, nops / PEAK_F32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def collision_bound(pos, active, order, cd, max_disp: float, neighbors=None):
    """The collision kernel's needed work at these inputs: pos, sorted ids
    and cells, the output (and the (N, 8) `neighbors` table of the exclude
    variant) once, the cell_start entries its ranges read; per candidate
    scanned 5 f32 operations (the distance test), per pair inside the
    cutoff 9 id compares when excluding, per contact kept 6."""
    import math

    side, bres = order.side, float(order.bin_resolution)
    r = min(max(math.ceil((np.float32(cd) + 2 * np.float32(max_disp)) / np.float32(bres)), 1),
            side)
    live = order.sorted_cell < order.n_cells
    c = order.sorted_cell[live].long()
    cy, cx = c // side, c % side
    rows = cy[:, None] + torch.arange(-r, r + 1, device=c.device)[None, :]
    ok = (rows >= 0) & (rows < side)
    lo = (rows * side + (cx - r).clamp(min=0)[:, None])[ok]
    hi = (rows * side + (cx + r).clamp(max=side - 1)[:, None] + 1)[ok]
    cs = order.cell_start.long()
    candidates = int((cs[hi] - cs[lo]).sum())
    starts = int(torch.unique(torch.cat([lo, hi])).numel())
    n = pos.shape[0]
    hits = contacts = 0
    cd2 = cd * cd
    ids = torch.arange(n, device=pos.device)
    for a in range(0, n, 2048):
        d = pos[a:a + 2048, None, :] - pos[None, :, :]
        d2 = (d * d).sum(-1)
        hit = (d2 < cd2) & (d2 > 0) & active[a:a + 2048, None] & active[None, :]
        hits += int(hit.sum())
        if neighbors is not None:
            hit &= ~(neighbors[a:a + 2048, :, None] == ids[None, None, :]).any(1)
        contacts += int(hit.sum())
    exclude = neighbors is not None
    nbytes = n * (8 + 4 + 4 + 8) + 4 * starts + 4 + (32 * n if exclude else 0)
    nops = 5 * candidates + (9 * hits if exclude else 0) + 6 * contacts
    return bound(nbytes, nops)


def pixel_bound(inputs, params, width, height):
    """The pixel pass's needed work: each referenced entry (40 B), the
    per-cell CSR bounds, the retina quads and the scalars read once, the
    planar image written once; ~18 f32 operations per (pixel, candidate of
    its cell), ~60 per pixel of shading, ~30 more for the camera-frame
    unwarp."""
    entries, cell_lo, cell_hi, sfq, scal, wc, hc, ds = inputs
    k = params.cell_px
    count = (cell_hi - cell_lo).clamp(max=params.bin_capacity).long()
    cells = torch.arange(wc * hc, device=count.device)
    pw = (width - (cells % wc) * k).clamp(0, k)
    ph = (height - (cells // wc) * k).clamp(0, k)
    cand = int((count * pw * ph).sum())
    npx = width * height
    nbytes = 40 * int(count.sum()) + 8 * wc * hc + 32 + 12 * npx
    nbytes += 4 * sfq.numel() if sfq is not None else 0
    nops = 18 * cand + (90 if params.camera_frame else 60) * npx
    return bound(nbytes, nops)


def band_bound(buf, params):
    """The band kernel's needed work: the two position planes over the
    swept ages 1..hi0 and the four planes' band + 1 window rows read once,
    a0, alast, the four windows and their ages written once; ~10 f32
    operations per (particle, swept age)."""
    from spacetime_tpu_torch.ops.band_cuda import _sweep_bounds

    _, _, _, hi0 = _sweep_bounds(buf, params)
    n, w = buf.num_particles, params.band + 1
    nbytes = hi0 * n * 8 + w * n * 16 + 8 * n + 20 * w * n + 8
    return bound(nbytes, 10 * hi0 * n)


def check_collision(device):
    """Kernel vs plain on the overlapping two-disc scene of
    tests/test_forces_pallas.py, scaled to the bench's disc size: at the
    positions the cells were built from (the scan of RK4 stage 0), and after
    every particle moved by up to 0.3c x h per axis with the matching
    per-axis displacement (the widened scan of stages 1-3)."""
    from spacetime_tpu_torch import scene
    from spacetime_tpu_torch.constants import DEFAULT_PARAMS as P
    from spacetime_tpu_torch.models.softbody import GRID_DIM, default_bin_resolution
    from spacetime_tpu_torch.ops import forces_cuda, grid

    r = scene.radius_for_count(5000)
    s = r / 4.0  # the test's discs have radius 4 px
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(r, 0, (0.0, 0.0), (0.0, 0.0), lattice_pad=True))
    sb.add(scene.disc_softbody(r, 1, (0.012 * s, 0.007 * s), (0.0, 0.0), lattice_pad=True))
    particles, _ = sb.build(device=device)
    act = particles.active
    rng = np.random.default_rng(0)
    jitter = rng.uniform(-2e-4, 2e-4, tuple(particles.pos.shape)).astype(np.float32)
    pos = particles.pos + torch.from_numpy(jitter).to(device) * act[:, None]
    bres = default_bin_resolution(P)
    bdim = int(round(GRID_DIM * P.grid_resolution / bres))
    cell, origin = grid.cell_ids(pos, act, bres, bdim)
    order = forces_cuda.build_cell_order(cell, origin, (bdim + 2) ** 2, bdim + 2, bres)
    lim = 0.3 * P.h
    step = rng.uniform(-lim, lim, tuple(pos.shape)).astype(np.float32)
    moved = (pos + torch.from_numpy(step).to(device) * act[:, None]).contiguous()
    errs = []
    for name, at, disp in (("still", pos, np.zeros(2)), ("moved", moved, np.abs(step).max(0))):
        f_kernel = forces_cuda.collision_forces(
            at, act, order, P.collision_distance, P.collision_repulsion_coefficient,
            torch.tensor(disp, dtype=torch.float32, device=device))
        f_plain = forces_cuda.collision_forces_plain(
            at, act, P.collision_distance, P.collision_repulsion_coefficient)
        err = collision_error(f_kernel, f_plain, act)
        fmax = f_plain[act].abs().max().item()
        if not fmax > 1.0:
            raise AssertionError(f"no contact in the collision check scene (max|f| = {fmax})")
        print(f"collision check ({name}, disp ({disp[0]:.3e}, {disp[1]:.3e})): "
              f"{int(act.sum())} active, "
              f"max|f| {fmax:.3f}, max abs err {err:.3e} (rtol 1e-4, atol 1e-3)")
        errs.append(err)
    return max(errs)


def check_pixel(particles, objects, buf, cam, params, width, height, when):
    """Kernel vs plain on the CSR that `params` builds from `buf` (the
    path's own render params, so its cell size, bin capacity, retarded and
    camera-frame flags).  Returns (max abs err, ms, plain ms, (bound_ms,
    bound_by))."""
    from spacetime_tpu_torch.ops import raytrace, render_cuda
    from spacetime_tpu_torch.ops import worldline as wl

    inputs, diag = raytrace.prepare_pixel_pass(
        buf, particles.object_index, objects, cam, width, height, params,
        boundary=wl.boundary_mask(particles))
    run_kernel = lambda: render_cuda.pixel_pass(inputs, params, width=width, height=height)
    run_plain = lambda: render_cuda.pixel_pass_plain(inputs, params, width=width, height=height)
    img_k, img_p = run_kernel(), run_plain()
    torch.cuda.synchronize()
    if img_k.shape != (3, height, width) or not torch.isfinite(img_k).all():
        raise AssertionError("pixel kernel output is not a finite (3, H, W) image")
    diff = (img_k - img_p).abs().amax(dim=0)
    err = diff.max().item()
    share = (diff > PIXEL_TOL).float().mean().item()
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain, reps=5)
    bnd = pixel_bound(inputs, params, width, height)
    print(f"pixel check ({when}; {width}x{height}, cell_px {params.cell_px}, bin_capacity "
          f"{params.bin_capacity}, retarded {params.retarded}, camera_frame "
          f"{params.camera_frame}): {inputs.entries.shape[0]} "
          f"entries, pairs {int(diag.pairs_used)}, max abs err {err:.3e}, share > "
          f"{PIXEL_TOL:g}: {share:.2e} (limit {PIXEL_SHARE:g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]})")
    if share > PIXEL_SHARE:
        raise AssertionError(f"pixel kernel disagrees with plain on {share:.2e} of pixels")
    return err, ms, plain_ms, bnd


def main_path(model, particles, objects, buf, cam, params):
    """FRAMES headline frames through the entry points, each stage timed
    with CUDA events; diagnostics summed on the device, checked once."""
    from spacetime_tpu_torch import kernels
    from spacetime_tpu_torch.headline import HEIGHT, WIDTH
    from spacetime_tpu_torch.ops import raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    h = model.params.h
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)] for _ in range(FRAMES)]
    diag_sum = torch.zeros(6, dtype=torch.int64, device=particles.pos.device)
    kernels.reset_launch_counts()
    img = None
    t0 = time.perf_counter()
    for i in range(FRAMES):
        e = ev[i]
        e[0].record()
        particles, aux = model.step(particles)
        e[1].record()
        buf = wl.push_frame(buf, particles, h * (i + 1))
        e[2].record()
        img, diag = raytrace.render_retarded_with_diag(
            buf, particles.object_index, objects, cam, WIDTH, HEIGHT, params,
            planar=True, boundary=wl.boundary_mask(particles))
        e[3].record()
        diag_sum += torch.stack([
            diag.band_truncated, diag.bin_dropped, diag.cell_too_small.long(),
            diag.retina_dropped, diag.entry_dropped, aux.window_truncated.long(),
        ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    med = lambda a, b: float(np.median([ev[i][a].elapsed_time(ev[i][b]) for i in range(FRAMES)]))
    step_ms, push_ms, render_ms = med(0, 1), med(1, 2), med(2, 3)
    names = ("band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
             "entry_dropped", "window_truncated")
    sums = dict(zip(names, diag_sum.tolist()))
    occupied = ((img != 1.0) & (img != np.float32(params.shadow))).any(dim=0).float().mean().item()
    print(f"main path: {FRAMES} frames in {wall:.2f} s wall; median step {step_ms:.4f} ms, "
          f"push {push_ms:.4f} ms, render {render_ms:.4f} ms; launches {counts}; "
          f"diag sums {sums}; occupied share {occupied:.4f}; "
          f"bonds broken (last frame) {int(aux.bonds_broken)}")
    if (counts["collision"] != 4 * FRAMES or counts["pixel_pass"] != FRAMES
            or counts["band"] != FRAMES):
        raise AssertionError(f"main path launches {counts}, expected 4x / 1x / 1x {FRAMES}")
    if any(sums.values()):
        raise AssertionError(f"nonzero diagnostics over the run: {sums}")
    if img.shape != (3, HEIGHT, WIDTH) or not torch.isfinite(img).all() or occupied <= 0.0:
        raise AssertionError("main path image is not finite or is all background")
    if not torch.isfinite(particles.pos).all():
        raise AssertionError("non-finite particle positions")
    return particles, buf, counts


def check_band(buf, cam, params, when):
    """Kernel vs plain on a path's ring with its render params: a0, alast,
    truncated, every window value and age exactly equal.  Timed with the L2
    evicted before each call, as a frame finds the ring (the 17 MB headline
    ring would otherwise stay in the 50 MB L2 between calls), and also
    warm.  Returns (max abs err, ms (cold), plain ms (cold), (bound_ms,
    bound_by))."""
    from spacetime_tpu_torch.ops import band_cuda

    run_kernel = lambda: band_cuda.cone_band_window(buf, params, cam)
    run_plain = lambda: band_cuda.cone_band_window_plain(buf, params, cam)
    ours, plain = run_kernel(), run_plain()
    unequal = band_unequal(ours, plain)
    err = max((getattr(ours, n).double() - getattr(plain, n).double()).abs().max().item()
              for n in BAND_FIELDS)
    entered = int((plain.a0 <= plain.hi0).sum())
    ms, plain_ms = cuda_ms(run_kernel, cold=True), cuda_ms(run_plain, reps=5, cold=True)
    warm_ms = cuda_ms(run_kernel)
    bnd = band_bound(buf, params)
    print(f"band check ({when}; band {params.band}, max_age {params.max_age}): "
          f"{entered} particles in the cone band, truncated "
          f"{int(plain.truncated)}, max abs err {err:.3e} (exact required); "
          f"kernel {ms:.4f} ms ({warm_ms:.4f} warm), plain {plain_ms:.4f} ms, bound "
          f"{bnd[0]:.6f} ms ({bnd[1]})")
    if unequal or ours.hi0 != plain.hi0 or entered == 0:
        raise AssertionError(f"band kernel differs from plain in {unequal} ({entered} entered)")
    return err, ms, plain_ms, bnd


def _lit(img, params) -> float:
    """Share of pixels that show matter: neither background nor shadow."""
    return ((img != 1.0) & (img != np.float32(params.shadow))).any(dim=-1).float().mean().item()


class DropSums:
    """Sums every frame's render drop counters on the device while the
    Engine runs, by wrapping the render entry point it calls
    (raytrace.render_retarded_with_diag); read once at the end.  The
    wrapped run's frame and render times include these sums (a stack of
    five counters and an add, about 7 small device ops a frame)."""

    NAMES = ("band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
             "entry_dropped")

    def __enter__(self):
        from spacetime_tpu_torch.ops import raytrace

        self.sums, self._orig = None, raytrace.render_retarded_with_diag

        def wrapped(*args, **kwargs):
            img, diag = self._orig(*args, **kwargs)
            vals = torch.stack([torch.as_tensor(getattr(diag, n) if getattr(diag, n) is not None
                                                else 0, device=img.device).long()
                                for n in self.NAMES])
            self.sums = vals if self.sums is None else self.sums + vals
            return img, diag

        raytrace.render_retarded_with_diag = wrapped
        return self

    def __exit__(self, *exc):
        from spacetime_tpu_torch.ops import raytrace

        raytrace.render_retarded_with_diag = self._orig

    def read(self):
        return dict(zip(self.NAMES, self.sums.tolist()))


def engine_via_cli(argv, frames, expect, drops=None):
    """The Engine through the CLI's code path; `expect` maps a kernel name to
    its launches per frame (the names not in it must stay 0).  With `drops`
    (a DropSums) every render drop counter must be 0 over the run."""
    from spacetime_tpu_torch import cli, kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if drops is None:
        eng, img, summary = cli.run(argv)
    else:
        with drops:
            eng, img, summary = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    lit = _lit(img, eng._render_params())
    boosts = {f: getattr(eng, f) for f in eng._ADAPT_FIELDS}
    print(f"engine {' '.join(argv)}: {wall:.2f} s wall incl. setup; launches {counts}; "
          f"lit share {lit:.4f}; boosts {boosts}")
    print(f"  summary {json.dumps(summary)}")
    want = {k: expect.get(k, 0) * frames for k in counts}
    if counts != want:
        raise AssertionError(f"engine launches {counts}, expected {want}")
    if drops is not None:
        sums = drops.read()
        print(f"  render drop counters summed over the run: {sums}")
        if any(sums.values()):
            raise AssertionError(f"nonzero render drop counters over the run: {sums}")
    if img.shape != (eng.config.height, eng.config.width, 3) or not torch.isfinite(img).all() \
            or lit <= 0.0:
        raise AssertionError("engine image is not finite or shows no matter")
    if not all(summary[k] > 0 for k in ("step_avg_ms", "worldline_avg_ms", "render_avg_ms")):
        raise AssertionError(f"engine stage times are not all > 0: {summary}")
    return eng, counts


def check_engine_kernels(eng):
    """The band and pixel kernels against plain on the Engine's final state,
    at the render params its last frame used (boosted band and bin capacity,
    view-derived max_age, ladder cell size; instant mode's opaque=False,
    retarded=False; the camera-frame flag).  Returns {kernel name: (max abs
    err, ms, plain ms, bound)}."""
    cfg = eng.config
    p = eng._render_params()
    when = f"engine {cfg.render_mode}, final state"
    errs = {}
    if cfg.render_mode == "instant":
        p = dataclasses.replace(p, opaque=False, retarded=False)
    else:
        errs["band"] = check_band(eng.worldline, eng.camera, p, when)
    errs["pixel_pass"] = check_pixel(eng.particles, eng.objects, eng.worldline, eng.camera, p,
                                     cfg.width, cfg.height, when)
    return errs


def engine_points(device):
    """The reference demo scene in points mode: POINTS_FRAMES frames through
    the Engine, then its last frame against the plain renderer on the same
    state (bit-equal).  Also times the plain version's winner pass, one
    `scatter_reduce_(..., "amin")`, as the library yardstick of that pass.
    Returns (launches, max abs err, ms, plain ms, bound, library ms)."""
    from spacetime_tpu_torch import headline, kernels
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.ops import points_cuda

    t0 = time.perf_counter()
    eng = Engine(headline.refdemo_config(), device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = eng.run(POINTS_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launches["points"]
    p, cfg = eng.particles, eng.config
    run_kernel = lambda: points_cuda.render_points(p, eng.objects, eng.camera, cfg.width,
                                                   cfg.height)
    run_plain = lambda: points_cuda.render_points_plain(p, eng.objects, eng.camera, cfg.width,
                                                        cfg.height)
    img = eng.render().permute(2, 0, 1)
    plain = run_plain()
    torch.cuda.synchronize()
    err = (img - plain).abs().max().item()
    covered = (plain != 1.0).any(dim=0).sum().item()
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain, reps=5)
    # the winner pass's inputs as render_points_plain builds them
    from spacetime_tpu_torch.camera import world_to_pixel

    n, hw = p.capacity, cfg.width * cfg.height
    px = torch.round(world_to_pixel(p.pos, cfg.width, cfg.height, eng.camera))
    x, y = px[:, 0], px[:, 1]
    inside = p.active & (x >= 0) & (x < cfg.width) & (y >= 0) & (y < cfg.height)
    flat = torch.where(inside, torch.where(inside, y, 0.0).long() * cfg.width
                       + torch.where(inside, x, 0.0).long(), hw)
    ids = torch.arange(n, device=p.pos.device)
    winner = torch.full((hw + 1,), n, dtype=torch.int64, device=p.pos.device)
    library_ms = cuda_ms(lambda: winner.scatter_reduce_(0, flat, ids, "amin"))
    # needed work: pos, active, object ids read once, the planar image
    # written once; ~10 f32 operations per particle
    bnd = bound(n * (8 + 1 + 4) + 12 * hw, 10 * n)
    print(f"engine points (refdemo): {int(p.active.sum())} active of {p.capacity}, setup "
          f"{setup:.2f} s, {POINTS_FRAMES} frames in {wall:.2f} s; points launches {launches}; "
          f"{covered} pixels covered; kernel vs plain max abs err {err:.3e} (bit-equal "
          f"required); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); one scatter_reduce_ amin (the winner pass only) {library_ms:.4f} ms")
    print(f"  summary {json.dumps(summary)}")
    if launches != POINTS_FRAMES:
        raise AssertionError(f"{launches} points launches, expected {POINTS_FRAMES}")
    if not torch.equal(img, plain) or covered == 0:
        raise AssertionError("points kernel image differs from the plain renderer")
    return launches, err, ms, plain_ms, bnd, library_ms


def _tiny_configs():
    """(name, config, frames): the tiny Engine config of tests/test_engine.py
    in each ported mode, and tests/test_torch_engine_configs.py's shrunk
    plastic_collision, boosted_observer and row-gather scenes."""
    from spacetime_tpu_torch.ops.raytrace import RenderParams
    from spacetime_tpu_torch.utils.config import BLUE, RED, EngineConfig, SceneSpec, get_config

    out = []
    for mode in ("retarded", "instant", "points"):
        out.append((mode, EngineConfig(
            scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
            render=RenderParams(num_rays=256), width=48, height=48, history=32,
            render_mode=mode), SMALL_ENGINE_FRAMES))
    shrink = dict(width=48, height=48)
    plastic = get_config("plastic_collision")
    out.append(("plastic_collision", dataclasses.replace(
        plastic, scene=SceneSpec(bodies=(("disc", 50, (0.40, 0.45), (0.12, 0.0), BLUE),
                                         ("disc", 50, (0.4295, 0.453), (-0.12, 0.0), RED)),
                                 material_indices=(0, 1)),
        render=dataclasses.replace(plastic.render, num_rays=256), cam_pos=(0.4113, 0.4437),
        cam_zoom=0.2, history=32, **shrink), SMALL_NEW_FRAMES))
    boosted = get_config("boosted_observer")
    out.append(("boosted_observer", dataclasses.replace(
        boosted, scene=SceneSpec(bodies=(("disc", 50, (0.55, 0.45), (0.0, 0.0), BLUE),
                                         ("disc", 50, (0.40, 0.53), (0.0, 0.0), RED))),
        render=dataclasses.replace(boosted.render, num_rays=256), cam_pos=(0.4513, 0.4437),
        cam_zoom=0.25, history=256, **shrink), SMALL_NEW_FRAMES))
    out.append(("rows", dataclasses.replace(
        plastic, materials=None,
        scene=SceneSpec(bodies=(("disc", 450, (0.40, 0.45), (0.1, 0.0), BLUE),
                                ("disc", 450, (0.52, 0.452), (-0.1, 0.0), RED)),
                        lattice_pad=False),
        render=dataclasses.replace(plastic.render, num_rays=256), cam_pos=(0.4613, 0.4437),
        cam_zoom=0.3, history=32, **shrink), SMALL_NEW_FRAMES))
    return out


def check_small_engine_vs_cpu():
    """Each tiny Engine config (see _tiny_configs) on the GPU and on the
    port's CPU path: positions to 1e-4, rest lengths to 1e-6 where creep
    runs, and at most PIXEL_SHARE of pixels off by > PIXEL_TOL."""
    from spacetime_tpu_torch.engine import Engine

    for name, cfg, frames in _tiny_configs():
        out = {}
        for dev in ("cpu", "cuda"):
            eng = Engine(cfg, device=dev)
            imgs = []
            eng.run(frames, on_frame=lambda i, img: imgs.append(img))
            p = eng.particles
            rl = p.rest_len[p.active].cpu() if p.rest_len is not None else torch.zeros(())
            out[dev] = (p.pos[p.active].cpu(), imgs[-1].cpu(), rl)
        pos_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
        share = ((out["cpu"][1] - out["cuda"][1]).abs().amax(dim=-1) > PIXEL_TOL).float() \
            .mean().item()
        rl_err = (out["cpu"][2] - out["cuda"][2]).abs().max().item()
        print(f"small engine ({name}), GPU vs CPU path after {frames} frames: "
              f"max position err {pos_err:.3e}, rest length err {rl_err:.1e}, "
              f"pixel share > {PIXEL_TOL:g}: {share:.2e}")
        if pos_err > 1e-4 or share > PIXEL_SHARE or rl_err > 1e-6:
            raise AssertionError(f"GPU Engine disagrees with the CPU path ({name})")


def time_collision(particles, model, exclude=False):
    """Kernel vs plain at a path's shapes (its final state): the kernel at
    RK4 stage 3's positions, pos + vel h, with the matching per-axis
    displacement, the widened scan that 3 of a step's 4 launches run (stage
    0's 3 x 3 scan is also timed); two launches on that input must be
    bit-equal.  `exclude` takes the bond-excluding variant (the state's
    neighbour table).  Returns (max abs err at stage 3, ms, plain ms,
    bound)."""
    from spacetime_tpu_torch.ops import forces_cuda

    P = model.params
    act = particles.active
    nbr = particles.neighbors.contiguous() if exclude else None
    order, stages = collision_inputs(particles, model)
    (moved, disp), (start, still) = stages[3], stages[0]
    cd, rep = P.collision_distance, P.collision_repulsion_coefficient
    run = lambda at, d: forces_cuda.collision_forces(at, act, order, cd, rep, d, neighbors=nbr)
    f_kernel, f_again = run(moved, disp), run(moved, disp)
    f_plain = forces_cuda.collision_forces_plain(moved, act, cd, rep, nbr)
    err = collision_error(f_kernel, f_plain, act)
    if not torch.equal(f_kernel, f_again):
        raise AssertionError("two collision launches on one input differ")
    ms = cuda_ms(lambda: run(moved, disp))
    still_ms = cuda_ms(lambda: run(start, still))
    plain_ms = cuda_ms(lambda: forces_cuda.collision_forces_plain(moved, act, cd, rep, nbr),
                       reps=5)
    dx, dy = disp.tolist()
    # the bound counts the square scan of reach ceil((cd + 2 max D) / bin)
    bnd = collision_bound(moved, act, order, cd, max(dx, dy), nbr)
    name = "collision_exclude" if exclude else "collision"
    print(f"{name} at the path's final state: max|f| {f_plain[act].abs().max().item():.3f}, "
          f"max abs err {err:.3e} (rtol 1e-4, atol 1e-3), two launches bit-equal; kernel "
          f"{ms:.4f} ms at stage 3's positions (disp ({dx:.3e}, {dy:.3e})), {still_ms:.4f} ms "
          f"at stage 0's; plain {plain_ms:.4f} ms; bound {bnd[0]:.6f} ms ({bnd[1]})")
    return err, ms, plain_ms, bnd


def engine_rows(device):
    """flagship_1080p with lattice_pad=False: the unpadded discs' bonds have
    no shifted offsets, so the Engine takes the row-gather physics and the
    collision kernel's bond-excluding variant.  ROWS_FRAMES retarded frames
    through the impact; then that variant against plain on the final
    state.  Returns (launches, max abs err, ms, plain ms, bound)."""
    from spacetime_tpu_torch import kernels
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils.config import get_config

    cfg = get_config("flagship_1080p")
    cfg = dataclasses.replace(cfg, scene=dataclasses.replace(cfg.scene, lattice_pad=False))
    t0 = time.perf_counter()
    eng = Engine(cfg, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    if eng.model.spring_offsets is not None:
        raise AssertionError("the unpadded flagship scene did not select the row physics")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = eng.run(ROWS_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    p = eng.particles
    lit = _lit(eng.render(), eng._render_params())
    print(f"engine rows (flagship_1080p, lattice_pad=False): {int(p.active.sum())} active of "
          f"{p.capacity}, setup {setup:.2f} s, {ROWS_FRAMES} frames in {wall:.2f} s; launches "
          f"{counts}; lit share {lit:.4f}; bonds "
          f"{int(((p.neighbors >= 0) & p.active[:, None]).sum())}; boosts "
          f"{ {f: getattr(eng, f) for f in eng._ADAPT_FIELDS} }")
    print(f"  summary {json.dumps(summary)}")
    if counts["collision_exclude"] != 4 * ROWS_FRAMES or counts["collision"] != 0 \
            or counts["band"] != ROWS_FRAMES or counts["pixel_pass"] != ROWS_FRAMES:
        raise AssertionError(f"row-physics launches {counts}, expected 4 exclude-variant "
                             f"collision, 1 band and 1 pixel pass a frame")
    if not torch.isfinite(p.pos).all() or lit <= 0.0:
        raise AssertionError("row-physics run is not finite or shows no matter")
    err, ms, plain_ms, bnd = time_collision(p, eng.model, exclude=True)
    return counts["collision_exclude"], err, ms, plain_ms, bnd


def check_plastic(eng):
    """The plastic_collision run's creep: the blue (material 0, creeping)
    body's rest lengths grew, the red (damped, no creep) body's did not."""
    p = eng.particles
    rest = torch.from_numpy(eng.config.physics.rest_lengths()).to(p.pos.device)
    bonded = (p.neighbors >= 0) & p.active[:, None]
    grown = torch.where(bonded, p.rest_len - rest[None, :], 0.0)
    obj = p.object_index[:, None]
    blue, red = grown[(obj == 0).expand_as(grown)], grown[(obj == 1).expand_as(grown)]
    crept = int((blue > 0).sum())
    print(f"plastic creep after {eng.frame} frames: blue bonds crept {crept}, max growth "
          f"{blue.max().item():.4e} ls, red max |change| {red.abs().max().item():.1e}")
    if not blue.max().item() > 0.0 or red.abs().max().item() != 0.0:
        raise AssertionError("plastic creep: the blue body did not creep or the red one did")


def check_small_vs_cpu():
    """A small two-disc scene on the GPU vs the port's CPU path (which the
    tier-1 tests hold against the JAX package): same positions to 1e-4
    (f32 summation order) and at most PIXEL_SHARE of pixels off by > 1e-3."""
    from spacetime_tpu_torch import scene
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.models.softbody import SoftbodyModel
    from spacetime_tpu_torch.ops import forces, raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    out = {}
    for dev in ("cpu", "cuda"):
        sb = scene.SceneBuilder()
        sb.add(scene.disc_softbody(6, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
               base_color=(0.25, 0.35, 1.0))
        sb.add(scene.disc_softbody(6, 1, (0.395, 0.41), (-0.25, -0.05), lattice_pad=True),
               base_color=(1.0, 0.3, 0.25))
        p, objs = sb.build(device=dev)
        model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                              device=dev)
        buf = wl.prefill_inertial(wl.create(64, p.capacity, device=dev), p.pos, p.vel,
                                  p.active, 0.0, model.params.h)
        cam = Camera.create(pos=(0.38, 0.41), zoom=0.15, device=dev)
        params = raytrace.RenderParams(dt=model.params.h, num_rays=512, pair_budget=1024,
                                       cell_px=9, retina_budget=256, max_age=48)
        for i in range(SMALL_FRAMES):
            p, _ = model.step(p)
            buf = wl.push_frame(buf, p, model.params.h * (i + 1))
        img = raytrace.render_retarded(buf, p.object_index, objs, cam, 96, 64, params,
                                       planar=True, boundary=wl.boundary_mask(p))
        out[dev] = (p.pos[p.active].cpu(), img.cpu())
    pos_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    share = ((out["cpu"][1] - out["cuda"][1]).abs().amax(dim=0) > PIXEL_TOL).float().mean().item()
    print(f"small scene, GPU vs CPU path after {SMALL_FRAMES} frames: "
          f"max position err {pos_err:.3e}, pixel share > {PIXEL_TOL:g}: {share:.2e}")
    if pos_err > 1e-4 or share > PIXEL_SHARE:
        raise AssertionError("GPU run disagrees with the CPU path on the small scene")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from spacetime_tpu_torch import headline, kernels

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {kernels.build_seconds} s) "
          f"-> {kernels.build()}")
    print(f"launch floor: {launch_floor_ms():.4f} ms a launch (torch.cuda._sleep(0) "
          f"back to back, timed as every kernel below)")

    coll_err = check_collision(device)
    model, particles, objects, buf, cam, params = headline.build(device)
    pix_err, pix_ms, pix_plain_ms, pix_bound = check_pixel(
        particles, objects, buf, cam, params, headline.WIDTH, headline.HEIGHT,
        "headline, prefilled ring")
    band_err0 = check_band(buf, cam, params, "headline, prefilled ring")[0]
    particles, buf, counts = main_path(model, particles, objects, buf, cam, params)
    band_err, band_ms, band_plain_ms, band_bnd = check_band(buf, cam, params,
                                                            "headline, after the main path")
    coll_err2, coll_ms, coll_plain_ms, coll_bnd = time_collision(particles, model)
    coll_err = max(coll_err, coll_err2)
    del model, particles, objects, buf
    eng, _ = engine_via_cli(["--config", "flagship_1080p", "--frames", str(ENGINE_FRAMES),
                             "--stats"], ENGINE_FRAMES,
                            {"collision": 4, "pixel_pass": 1, "band": 1})
    retarded_errs = check_engine_kernels(eng)
    del eng
    eng, _ = engine_via_cli(["--config", "flagship_1080p", "--frames", str(INSTANT_FRAMES),
                             "--mode", "instant"], INSTANT_FRAMES,
                            {"collision": 4, "pixel_pass": 1, "band": 0})
    instant_errs = check_engine_kernels(eng)
    del eng
    pix_err = max(pix_err, retarded_errs["pixel_pass"][0], instant_errs["pixel_pass"][0])
    band_err = max(band_err0, band_err, retarded_errs["band"][0])
    pts_launches, pts_err, pts_ms, pts_plain_ms, pts_bnd, pts_lib_ms = engine_points(device)

    # the paths of this slice, each with its launch counts reset just before
    eng, boosted_counts = engine_via_cli(
        ["--config", "boosted_observer", "--frames", str(BOOSTED_FRAMES), "--stats"],
        BOOSTED_FRAMES, {"collision": 4, "pixel_pass_camera_frame": 1, "band": 1},
        drops=DropSums())
    boosted_errs = check_engine_kernels(eng)
    cf_err, cf_ms, cf_plain_ms, cf_bnd = boosted_errs["pixel_pass"]
    band_err = max(band_err, boosted_errs["band"][0])
    del eng
    eng, _ = engine_via_cli(["--config", "plastic_collision", "--frames", str(PLASTIC_FRAMES),
                             "--stats"], PLASTIC_FRAMES,
                            {"collision": 4, "pixel_pass": 1, "band": 1})
    check_plastic(eng)
    del eng
    ex_launches, ex_err, ex_ms, ex_plain_ms, ex_bnd = engine_rows(device)
    check_small_vs_cpu()
    check_small_engine_vs_cpu()

    record = lambda name, src, replaces, launches, err, ms, plain_ms, bnd, lib=None: {
        "name": name, "route": "cuda", "source": f"spacetime_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}
    print(json.dumps({"kernels": [
        record("collision", "collision.cu", "spacetime_tpu/ops/forces_pallas.py:52",
               counts["collision"], coll_err, coll_ms, coll_plain_ms, coll_bnd),
        record("pixel_pass", "pixel_pass.cu", "spacetime_tpu/ops/render_pallas.py:57",
               counts["pixel_pass"], pix_err, pix_ms, pix_plain_ms, pix_bound),
        record("band", "band.cu", "spacetime_tpu/ops/band_pallas.py:52", counts["band"],
               band_err, band_ms, band_plain_ms, band_bnd),
        record("points", "points.cu", "spacetime_tpu/ops/points_pallas.py:58", pts_launches,
               pts_err, pts_ms, pts_plain_ms, pts_bnd, pts_lib_ms),
        record("collision_exclude_bonds", "collision.cu",
               "spacetime_tpu/ops/forces_pallas.py:68", ex_launches, ex_err, ex_ms,
               ex_plain_ms, ex_bnd),
        record("pixel_pass_camera_frame", "pixel_pass.cu",
               "spacetime_tpu/ops/render_pallas.py:110",
               boosted_counts["pixel_pass_camera_frame"], cf_err, cf_ms, cf_plain_ms, cf_bnd),
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
