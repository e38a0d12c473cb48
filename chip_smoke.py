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
  * the same headline frame as the fused frame (spacetime_tpu_torch/
    fused.py: its stages captured as CUDA graphs at the first frame and
    replayed), FRAMES frames from a copy of the start state of two eager
    runs of the same stages: the two eager runs must be bit-equal, and
    then the graph run bit-equal to them (positions, ring, clock, image,
    counters), with 4 collision, 1 band and 1 pixel launch a frame counted
    from the replays, one capture and FRAMES - 1 replays, and every drop
    counter, summed over its frames by name, 0;
  * the Engine through its CLI (`cli.build` + `Engine.run`, the code of
    `python -m spacetime_tpu_torch`), fused (CUDA graphs) unless told
    otherwise: `flagship_1080p` in retarded mode for ENGINE_FRAMES frames
    (the discs meet near frame 120 at a 0.9c closing speed), then
    `profile_stages` (per-stage device times must be > 0), and again with
    `--stage-timing` (eager frames, CUDA-event stage times > 0), the two
    frame times printed side by side; in instant mode for INSTANT_FRAMES
    frames; after each run the band (retarded only) and pixel kernels are
    held against plain on the Engine's final state at the render params it
    chose (its adapted band and bin capacity, its max_age and cell size);
  * the fused Engine's graph cache on `flagship_1080p`: zooms on four rungs
    of the cell ladder capture four keys, a revisit replays, a fifth zoom
    evicts the oldest; device memory peaks with one and with four;
  * the bench (spacetime_tpu_torch/bench.py), once, its JSON line printed;
  * the Engine in points mode on the reference demo scene
    (headline.refdemo_config: 116,178 particles at capacity 149,248,
    1920x1080) for POINTS_FRAMES frames, its last frame bit-equal to the
    plain point renderer on the same state;
  * `boosted_observer` through the CLI's code path (two 3,000-particle
    discs, 512x512, the camera-frame view of a 0.5c camera) for
    BOOSTED_FRAMES frames: every frame 1 camera-frame pixel launch, 1 band
    launch and 4 collision launches, every drop counter summed over the
    run (the CLI summary's `drops`) 0; then the band and camera-frame
    pixel kernels against plain on its final state at its own render
    params, and the pixel kernel at a
    bin_capacity of 1536 (above what a 48 KB slice holds) in both
    branches;
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
    Engine in its four modes, and tiny `plastic_collision`,
    `boosted_observer` and row-gather scenes;
  * `Engine.render_views`, after the flagship run: three cameras on its
    ring, bit-equal to three single renders, 3 band and 3 pixel launches;
  * the reference demo's retarded frame (headline.build_refdemo: 116,178
    active at capacity 149,248, a T=1024 ring of 4.9 GB, 1920x1080,
    `splat_cells=4`, rank compaction to 3 crossings, band 4): the fused
    frame's graphs bit-equal to its stages run eagerly from a copy of the
    start state for REFDEMO_COMPARE_FRAMES frames, then REFDEMO_FRAMES graph
    frames with 4 / 1 / 1 launches a frame, every drop counter 0
    (segment_dropped included) and the pairs within pair_budget; then the
    pixel, band and collision kernels against plain on its final state;
    then, at that scale, the compacted frame against the uncompacted one
    under the pixel gate, and the drops at the reference demo's segments=2;
  * the retina mode through the CLI (`accelerated_camera --mode retina`)
    for RETINA_FRAMES eager frames (4 collision and 1 band launch a frame,
    the strip's shape); a tiny retina Engine on the GPU and the CPU above;
  * `flagship_1080p` with an aloof disc on a circular trajectory: its
    stages as graphs bit-equal to eager, then ALOOF_FRAMES fused Engine
    frames (a capture a key, the aloof slots at state_at(the clock));
  * Euler (`SoftbodyModel(integrator="euler")`): EULER_STEPS headline steps
    with one collision launch a step, and a small scene on the GPU against
    the CPU;
  * the conical mode through the CLI: `conical_defect` (a static defect)
    and `selfgravity` (two defects sourced by the discs' retarded centres
    of energy), CONICAL_FRAMES and SELFGRAVITY_FRAMES fused frames with 4
    collision and 1 band launch a frame (route 1 on the band kernel) and
    no pixel launch, every drop counter 0 over the frames after the
    adaptation's last boost for conical_defect (selfgravity's drops are
    printed: three routes fill its bins past the adaptation's ceiling); the
    conical stages as graphs bit-equal to eager from the final state, the
    route-1 band window exact against the plain sweep, and selfgravity's
    last graph defects bit-equal to an eager recompute; `worldline3d` for
    WL3D_FRAMES fused frames with 4 collision launches a frame and nothing
    else, graph bit-equal to eager; after each of the three, the collision
    kernel against plain at its final state (selfgravity's after the
    impact, with particles near c) at RK4 stages 0 and 3; tiny conical
    and worldline3d Engines join the GPU-vs-CPU set above;
  * the btz mode through the CLI, all five configs at full size (two
    3,000-particle discs, 512x512): `btz_hole` for BTZ_HOLE_FRAMES fused
    frames, `btz_reflected`, `btz_spinning` and `btz_photon_ring` for
    BTZ_FRAMES and `btz_extremal` (the exact rotating-metric solver) for
    BTZ_EXTREMAL_FRAMES, their drops printed, not gated: they do not settle
    under the JAX package's adaptation, which reads one frame in 30.  After
    the last boost each frame's bin drops are set beside its nearest-k
    tolerance, and at the final state each route's band truncations with
    f32 delays beside those with float64 ones.  Each launches 4 collision
    kernels a frame and no band, pixel or points kernel (every route takes
    the plain sweep; the retina and the route pass are plain torch); then
    its stages as graphs bit-equal to eager for REFDEMO_COMPARE_FRAMES
    frames from the final state, the collision kernel against plain at
    that state, and a black pixel inside the horizon disc; for
    btz_extremal the exact solver's fallback share over the final ring's
    route-0 sweep points is printed.  Shrunk btz_hole and btz_extremal
    Engines join the GPU-vs-CPU set;
  * the I/O phase (io_phase), each path with its launch counts reset just
    before it: (a) `png_demo` (two PNG bodies read by the port's own PNG
    reader) through the CLI with `--out DIR --every 10` for IO_PNG_FRAMES
    fused frames: the 6 PNGs read back by utils/png.py equal the on-frame
    images quantized to uint8, with the FrameSink's path (native or
    Python) printed and 4 collision, 1 band and 1 pixel launch a frame; (b)
    `flagship_1080p` through the CLI with `--serve 0` (the stats overlay
    on): a loopback client (every socket with a timeout) reads one JPEG
    part (SOI, EOI, size), posts `d` down and up (the camera's pan equals
    the host CameraController's for the same keys), `o` (camera-frame
    pixel launches follow) and `q`, which ends the run before its frame
    limit, with the StreamSink's path printed; (c) `bench --record` then
    `--replay` of `flagship_1080p` over IO_REPLAY_FRAMES frames of the
    bench's scripted keys: final particles, ring and last image bit-equal
    between the two Engines, their captures and fps printed; (d)
    `--realtime` on `png_demo` at a live max_fps of IO_REALTIME_FPS:
    IO_REALTIME_FRAMES frames take at least IO_REALTIME_FRAMES / fps
    (less 10%); (e) `bench --scene capacity --frame` (2^20 particles,
    headline.build_capacity): steps/s, the frame's ms and device ms by
    stage, every drop counter and the kernels' launches, then the band and
    pixel kernels against plain on its final state;
  * the mesh phase (mesh_phase): a one-rank NCCL process group (TCP store
    on a free loopback port) and `Engine(flagship_1080p, mesh=...)` for
    MESH_FRAMES fused frames, its collectives (the step's gathers and
    reduce-scatters, the pair and image gathers, the counter all-reduces)
    captured in its CUDA graphs: 4 collision, 1 band and 1 pixel launch a
    frame; its last image bit-equal to the single-device Engine's after
    the same frames (else held to the pixel gate), its state bit-equal and
    its drop counters equal to the single-device run's, its graphs
    bit-equal to its stages run eagerly from its final state, and the
    collectives of one eager mesh frame counted and printed (calls and
    bytes by kind); then the same against one device for flagship_1080p
    in points mode (MESH_FRAMES frames, the points kernel's winner and
    resolve passes around a MIN all-reduce: 1 points launch a frame) and
    conical_defect (MESH_CONICAL_FRAMES); the group is destroyed before
    the result line;
  * the kernels' mesh launches against their whole launches, exact: the
    collision kernel over 2 and 4 ranges of sorted rows summed (headline,
    after the main path, both variants), the pixel kernel over 2 and 4
    bands of cell rows (headline and boosted_observer's camera-frame
    branch), and the points kernel's winner pass over 2 and 4 particle
    blocks, MIN-reduced and resolved (the refdemo points state); each
    share's launch time is printed beside the whole launch's, and the JSON
    line carries them as `shard_ms`.

Kernel times come from `spacetime_tpu_torch.utils.timing.cuda_ms`, which
keeps the host's enqueue out of the reading (a device spin covers it);
every kernel, plain and library reading uses it.  The band kernel is
timed with the L2 evicted before each call, as a frame finds its ring.
The card's launch floor, a trivial kernel timed the same way, is printed
on a line of its own.  The collision inputs at RK4 stage 3 and the
kernel-vs-plain comparisons are spacetime_tpu_torch/checks.py's, which
compare_kernels uses too.

Output: one line per phase, then a JSON line of per-kernel results (each
with its bound: the larger of the bytes it must move over 3.35 TB/s and
its f32 operations over 67 TFLOP/s, the H100 SXM's published peaks of
spacetime_tpu_torch/utils/roofline.py, from this run's inputs), the card's
name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (non-zero exit, no
result line).  Needs CUDA: without it the script exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np
import torch

from spacetime_tpu_torch.checks import (BAND_FIELDS, PIXEL_SHARE, PIXEL_TOL, band_unequal,
                                        collision_error, collision_inputs, pixel_inputs,
                                        pixel_share)
from spacetime_tpu_torch.device import card_line
from spacetime_tpu_torch.utils.timing import cuda_ms, launch_floor_ms

FRAMES = 200  # the discs meet at about frame 170
REFDEMO_FRAMES = 60  # fused refdemo frames (the discs meet near frame 350)
REFDEMO_COMPARE_FRAMES = 10  # graph vs eager refdemo frames from one start state
RETINA_FRAMES = 60
ALOOF_FRAMES = 60  # flagship_1080p with an aloof disc, before the impact
# explicit Euler is unstable at the default stiffness (the reference's
# "strictly worse than rk4"): lattice noise grows ~1.7x a step and turns to
# NaN near step 20, so the launch count is read over 10 steps
EULER_STEPS = 10
ENGINE_FRAMES = 200  # flagship_1080p: the discs meet at about frame 120
INSTANT_FRAMES = 20
POINTS_FRAMES = 100
BOOSTED_FRAMES = 300
PLASTIC_FRAMES = 220  # the discs, 0.184 ls apart closing at 0.24c, meet near frame 153
ROWS_FRAMES = 200  # flagship_1080p unpadded: the discs meet near frame 120
CONICAL_FRAMES = 200  # conical_defect: the discs pass the defect's side
SELFGRAVITY_FRAMES = 200  # selfgravity: the discs meet near frame 73
WL3D_FRAMES = 100  # worldline3d: the discs meet near frame 92
SMALL_NEW_FRAMES = 8  # tiny new-config Engines, GPU vs CPU, through contact
BTZ_HOLE_FRAMES = 200  # btz_hole: the discs pass the hole
BTZ_FRAMES = 30  # btz_reflected, btz_spinning, btz_photon_ring
BTZ_EXTREMAL_FRAMES = 10  # btz_extremal: over half a million launches a frame
SMALL_EXTREMAL_FRAMES = 3  # the shrunk btz_extremal, GPU vs CPU
SMALL_FRAMES = 5  # frames of the small GPU-vs-CPU scene, through its impact
SMALL_ENGINE_FRAMES = 15  # frames of the tiny Engine config, GPU vs CPU
BIG_BIN_CAPACITY = 1536  # a staged slice past 48 KB of shared memory
IO_PNG_FRAMES, IO_EVERY = 60, 10  # png_demo through --out: frames 0, 10, ..., 50
IO_SERVE_LIMIT = 40  # the served run's --frames; its client's q ends it at frame 15
IO_REPLAY_FRAMES = 30
IO_REALTIME_FRAMES, IO_REALTIME_FPS = 15, 30.0
IO_TIMEOUT = 5.0  # seconds, every client socket of the served run
MESH_FRAMES = 60  # flagship_1080p on a one-rank NCCL mesh (retarded, then points)
MESH_CONICAL_FRAMES = 20  # conical_defect on that mesh
# kernel name -> (whole launch ms, {parts: [ms of each share's launch]}),
# filled by the share checks for the JSON line
SHARD_MS = {}
SHARES = (2, 4)  # ranks a kernel's work is split over in the share checks
# flagship_1080p zooms on the cell ladder's rungs 16 (its own), 8, 24, 32, 48
LADDER_ZOOMS = (1.2, 2.4, 0.6, 0.4, 0.25)


def bound(nbytes: float, nops: float):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move `nbytes` and do `nops` f32 operations, at the H100 SXM's
    published peaks (utils/roofline.py)."""
    from spacetime_tpu_torch.utils.roofline import Roofline

    r = Roofline(flops=nops, bytes_accessed=nbytes)
    return r.bound_s * 1e3, r.bound_by


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

    hi0 = int(_sweep_bounds(buf, params)[3])
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
    camera-frame flags); two launches must be bit-equal.  Returns (max abs
    err, ms, plain ms, (bound_ms, bound_by))."""
    from spacetime_tpu_torch.ops import render_cuda

    inputs, diag = pixel_inputs(particles, objects, buf, cam, params, width, height)
    run_kernel = lambda: render_cuda.pixel_pass(inputs, params, width=width, height=height)
    run_plain = lambda: render_cuda.pixel_pass_plain(inputs, params, width=width, height=height)
    img_k, img_again, img_p = run_kernel(), run_kernel(), run_plain()
    torch.cuda.synchronize()
    if img_k.shape != (3, height, width) or not torch.isfinite(img_k).all():
        raise AssertionError("pixel kernel output is not a finite (3, H, W) image")
    if not torch.equal(img_k, img_again):
        raise AssertionError("two pixel launches on one input differ")
    err = (img_k - img_p).abs().max().item()
    share = pixel_share(img_k, img_p)
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain, reps=5)
    bnd = pixel_bound(inputs, params, width, height)
    print(f"pixel check ({when}; {width}x{height}, cell_px {params.cell_px}, bin_capacity "
          f"{params.bin_capacity}, retarded {params.retarded}, camera_frame "
          f"{params.camera_frame}): {inputs.entries.shape[0]} "
          f"entries, pairs {int(diag.pairs_used)}, max abs err {err:.3e}, share > "
          f"{PIXEL_TOL:g}: {share:.2e} (limit {PIXEL_SHARE:g}), two launches bit-equal; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.6f} ms ({bnd[1]})")
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


def _slowest(eng):
    """The three slowest frames of an Engine's stats window, as (frame, ms)."""
    ms = [s * 1e3 for s in eng.stats.samples]
    return [(i, round(ms[i], 3)) for i in sorted(range(len(ms)), key=ms.__getitem__)[-3:][::-1]]


def engine_via_cli(argv, frames, expect, drops="report", envelope=False):
    """The Engine through the CLI's code path (`cli.build`, then its
    frames run as `cli.run` runs them); `expect` maps a kernel name to its
    launches per frame (the names not in it must stay 0).  The frames at
    which the adaptation boosted and the drop counters summed over each
    span of frames run at one setting are printed; `drops` says what is
    held of them: "gate", every drop summed over the run (the summary's
    `drops`) is 0; "gate_after_boost", every drop summed over the frames
    after the last boost (all frames when nothing boosts) is 0; "report",
    nothing.  With `envelope`, the frames after the last boost are set
    beside the JAX package's nearest-k tolerance (drop_envelope).  A fused
    run (no --stage-timing) must have replayed a captured graph in every
    frame but each key's first; an eager one (--stage-timing, or the retina
    mode, which runs unfused) must report stage times > 0 and capture
    nothing.  The image is (H, W, 3), or the retina strip (max(16, H // 8),
    num_rays, 3)."""
    from spacetime_tpu_torch import cli, fused, kernels

    if drops not in ("gate", "gate_after_boost", "report"):
        raise ValueError(f"engine_via_cli: unknown drops {drops!r}")
    # per frame: the Engine's drop sums so far, its boosts after it, its pairs
    history, last = [], {}

    def watch(i, img):
        pairs = getattr(eng.last_diag, "pairs_used", None)
        history.append((eng._drops.clone(), tuple(getattr(eng, f) for f in eng._ADAPT_FIELDS),
                        None if pairs is None else pairs.clone()))
        last["img"] = img

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng, args = cli.build(argv)
    summary = eng.run(args.frames, on_frame=watch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    img = last["img"]
    counts = dict(kernels.launches)
    lit = _lit(img, eng._render_params())
    boosts = {f: getattr(eng, f) for f in eng._ADAPT_FIELDS}
    print(f"engine {' '.join(argv)}: {wall:.2f} s wall incl. setup; launches {counts}; "
          f"lit share {lit:.4f}; boosts {boosts}; graphs {eng.graph_stats}; slowest frames "
          f"(index, ms) {_slowest(eng)}")
    print(f"  summary {json.dumps(summary)}")
    want = {k: expect.get(k, 0) * frames for k in counts}
    if counts != want:
        raise AssertionError(f"engine launches {counts}, expected {want}")
    before = (0,) * len(eng._ADAPT_FIELDS)
    boosted = [i for i, h in enumerate(history) if h[1] != (history[i - 1][1] if i else before)]
    # drop sums over the frames run at each setting: frames ends[j-1]+2 .. ends[j]+1
    ends = [-1] + boosted + [frames - 1]
    sums = [history[i][0] if i >= 0 else torch.zeros_like(history[-1][0]) for i in ends]
    spans = [(f"{a + 2}-{b + 1}", history[a][1] if a >= 0 else before,
              {k: v for k, v in zip(fused.DROP_FIELDS, (hi - lo).tolist()) if v})
             for a, b, lo, hi in zip(ends, ends[1:], sums, sums[1:])]
    print(f"  adaptation ({eng._ADAPT_FIELDS}): frames, boosts, nonzero drops summed {spans}")
    if drops == "gate" and any(summary["drops"].values()):
        raise AssertionError(f"nonzero drop counters over the run: {summary['drops']}")
    if drops == "gate_after_boost" and (spans[-1][2] or boosted[-1:] == [frames - 1]):
        raise AssertionError(f"drops after the last boost: {spans[-1][2]}")
    if envelope:
        drop_envelope(history, boosted[-1] + 1 if boosted else 0)
    cfg = eng.config
    shape = ((max(16, cfg.height // 8), cfg.render.num_rays, 3) if cfg.render_mode == "retina"
             else (cfg.height, cfg.width, 3))
    if img.shape != shape or not torch.isfinite(img).all() or lit <= 0.0:
        raise AssertionError(f"engine image {tuple(img.shape)} (expected {shape}) is not "
                             "finite or shows no matter")
    g = eng.graph_stats
    if cfg.stage_timing or cfg.render_mode == "retina":
        if g["eager"] != frames:
            raise AssertionError(f"eager engine ran {g['eager']} eager frames of {frames}")
        if g["captures"] or not all(summary[k] > 0 for k in ("step_avg_ms", "worldline_avg_ms",
                                                              "render_avg_ms")):
            raise AssertionError(f"stage-timed engine: graphs {g} or a stage time not > 0: "
                                 f"{summary}")
    elif not 1 <= g["captures"] <= 8 or g["captures"] + g["replays"] != frames:
        # a capture a render-params key: the adaptation moves to a few keys
        raise AssertionError(f"fused engine graphs {g} over {frames} frames")
    return eng, counts, summary


def drop_envelope(history, start):
    """Prints frames `start` .. of engine_via_cli's `history` (per frame:
    drop sums so far, boosts, pairs) beside the JAX package's nearest-k
    tolerance, max(1, int(1e-3 * pairs)), the bin drops its adaptation
    leaves standing when it reads them (one frame in diag_every): the most
    bins dropped in a frame, and the frames above the tolerance, or that
    drop anything but bins and bands."""
    from spacetime_tpu_torch import fused

    if start >= len(history):
        print(f"  no frame ran after the last boost (frame {len(history)})")
        return
    bins, bands = fused.DROP_FIELDS.index("bin_dropped"), fused.DROP_FIELDS.index("band_truncated")
    worst, over = (0, 1, start + 1), []
    for i in range(start, len(history)):
        per = (history[i][0] - history[i - 1][0] if i else history[i][0]).tolist()
        tol = max(1, int(1e-3 * int(history[i][2])))
        if per[bins] * worst[1] > worst[0] * tol:
            worst = (per[bins], tol, i + 1)
        others = {n: v for j, (n, v) in enumerate(zip(fused.DROP_FIELDS, per))
                  if v and j not in (bins, bands)}
        if per[bins] > tol or others:
            over.append((i + 1, per[bins], tol, others))
    print(f"  frames {start + 1}-{len(history)} beside the nearest-k tolerance: the most bins "
          f"dropped in a frame {worst[0]} (frame {worst[2]}, tolerance {worst[1]}); {len(over)} "
          f"frames over it (frame, bins, tolerance, other drops) {over[:8]}")


def check_profile_stages(eng):
    """Engine.profile_stages on a fused CUDA Engine: per-stage device times
    of the replayed graphs, each > 0, reported by the stats summary."""
    stages = eng.profile_stages(5)
    summary = eng.stats.summary()
    keys = [f"{k}_dev_ms" for k in ("step", "worldline", "render", "total")]
    print(f"  profile_stages (5 fused frames, CUDA events between the stage graphs): "
          f"{ {k: summary.get(k) for k in keys} }")
    if not all(summary.get(k, 0) > 0 for k in keys):
        raise AssertionError(f"profile_stages left a stage time at 0: {stages}")


def _state_diff(a, b):
    """Names of the state tensors that differ between two FrameStates."""
    out = []
    for part, x, y in (("particles", a.particles, b.particles), ("ring", a.buf, b.buf)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if u is not None and not torch.equal(u, v):
                out.append(f"{part}.{f.name}")
    for name in ("frame_in", "aux"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            out.append(name)
    return out


def check_graph_vs_eager(device):
    """The headline frame's stages for FRAMES frames three times from
    copies of one start state: eagerly twice (which must be bit-equal, as
    every kernel is deterministic) and as CUDA graph replays, which must be
    bit-equal to them; where the eager runs differ, the differing tensors
    are named and the graph run is held to check_small_vs_cpu's tolerances
    instead.  Returns (graph ms a frame, eager ms a frame) of the host wall
    clock over frames 2..FRAMES (the first, the graph's capture, apart)."""
    from spacetime_tpu_torch import fused, headline, kernels

    model, particles, objects, buf, cam, params = headline.build(device)
    base = fused.new_state(particles, buf, cam, 0.0)
    runs = {}
    for name in ("eager", "eager again", "graph"):
        state = base if name == "graph" else fused.copy_state(base)
        stages = fused.frame_stages(model, None, state, objects, headline.WIDTH,
                                    headline.HEIGHT, params, "retarded", model.params.h)
        order = fused.schedule(1)
        frame = fused.FusedFrame(stages, order, device) if name == "graph" else \
            (lambda stages=stages: fused.run_stages(stages, order))
        kernels.reset_launch_counts()
        out = frame()  # the graph's capture frame: timed apart
        sums = out[1]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FRAMES - 1):
            out = frame()
            sums = sums + out[1]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / (FRAMES - 1) * 1e3
        runs[name] = (state, out, ms, dict(kernels.launches),
                      getattr(frame, "stats", None), fused.drops_of(sums, stages["render"]))
    (ea, (img_a, ctr_a), ms_a, _, _, _), (eb, (img_b, ctr_b), _, _, _, _) = \
        runs["eager"], runs["eager again"]
    gs, (img_g, ctr_g), ms_g, counts, stats, drops = runs["graph"]
    eager_diff = _state_diff(ea, eb) + [n for n, x, y in (("image", img_a, img_b),
                                                          ("counters", ctr_a, ctr_b))
                                        if not torch.equal(x, y)]
    graph_diff = _state_diff(gs, ea) + [n for n, x, y in (("image", img_g, img_a),
                                                          ("counters", ctr_g, ctr_a))
                                        if not torch.equal(x, y)]
    print(f"graph vs eager (headline, {FRAMES} frames each from one start state): eager runs "
          f"differ in {eager_diff or 'nothing'}; graph differs from eager in "
          f"{graph_diff or 'nothing'}; graph launches {counts}, {stats}; wall per frame "
          f"(frames 2-{FRAMES}): "
          f"graph {ms_g:.4f} ms, eager {ms_a:.4f} ms; graph drop counters summed over the "
          f"run {drops}")
    if counts["collision"] != 4 * FRAMES or counts["band"] != FRAMES \
            or counts["pixel_pass"] != FRAMES:
        raise AssertionError(f"graph launches {counts}, expected 4x / 1x / 1x {FRAMES}")
    if (stats["captures"], stats["replays"]) != (1, FRAMES - 1):
        raise AssertionError(f"graph run {stats}: expected one capture and {FRAMES - 1} replays")
    if not eager_diff:
        if graph_diff:
            raise AssertionError(f"the graph run differs from bit-equal eager runs in "
                                 f"{graph_diff}")
    else:
        act = ea.particles.active
        pos_err = (gs.particles.pos - ea.particles.pos)[act].abs().max().item()
        share = ((img_g - img_a).abs().amax(dim=0) > PIXEL_TOL).float().mean().item()
        print(f"  eager runs are not bit-equal: graph vs eager max position err "
              f"{pos_err:.3e}, pixel share > {PIXEL_TOL:g}: {share:.2e}")
        if pos_err > 1e-4 or share > PIXEL_SHARE:
            raise AssertionError("the graph run disagrees with the eager run")
    if not torch.isfinite(img_g).all() or any(drops.values()):
        raise AssertionError(f"graph run image not finite or drop counters {drops} not 0")
    return ms_g, ms_a


def check_graph_cache(device):
    """flagship_1080p fused on the card: one key, then zooms on three more
    rungs of the cell ladder (a capture each), a revisit (a replay), and a
    fifth rung (a capture that evicts the oldest key); the device memory
    peak after one key and after four."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.utils.config import get_config

    from spacetime_tpu_torch.utils.profiling import device_memory_stats

    peak = lambda: device_memory_stats(device)["peak_bytes_in_use"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(get_config("flagship_1080p"), device=device)
    eng.run(3)
    torch.cuda.synchronize()
    one = peak()
    peaks, cells = [one], []
    for zoom in LADDER_ZOOMS[1:4]:
        eng.camera = Camera.create(pos=(0.7, 0.5), zoom=zoom, device=device)
        eng.run(2)
        torch.cuda.synchronize()
        peaks.append(peak())
        cells.append(eng._render_params().cell_px)
    four = dict(eng.graph_stats)
    eng.camera = Camera.create(pos=(0.7, 0.5), zoom=LADDER_ZOOMS[0], device=device)
    eng.run(2)
    revisit = dict(eng.graph_stats)
    eng.camera = Camera.create(pos=(0.7, 0.5), zoom=LADDER_ZOOMS[4], device=device)
    eng.run(2)
    fifth = dict(eng.graph_stats)
    kept = [k[0].cell_px for k in eng._fused_cache]
    print(f"graph cache (flagship_1080p): cell sizes {cells} after the first; graphs after four "
          f"keys {four}, after a revisit {revisit}, after a fifth {fifth}; kept cells {kept}; "
          f"max_memory_allocated {one / 2**20:.1f} MiB with one key's graphs, "
          f"{peaks[-1] / 2**20:.1f} MiB with four (per key: "
          f"{[round(p / 2**20, 1) for p in peaks]})")
    if four["captures"] != 4 or revisit["captures"] != 4 or fifth["captures"] != 5 \
            or len(kept) != 4 or revisit["replays"] != four["replays"] + 2:
        raise AssertionError("the fused frame cache did not capture once per key")
    return one, peaks[-1]


def run_bench():
    """The bench's headline row (spacetime_tpu_torch/bench.py), printed as
    its JSON line; every drop counter must be 0."""
    from spacetime_tpu_torch import bench

    row = bench.run_headline()
    print(json.dumps(row))
    if any(row["drops"].values()) or not row["value"] > 0:
        raise AssertionError(f"bench drops {row['drops']} or fps {row['value']}")
    return row


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
    state (bit-equal), a second launch bit-equal too, and the kernel's
    scratch back at EMPTY and 0 after both, and so is the scratch of the
    Engine's graphs.  Also times the plain version's
    winner pass, one `scatter_reduce_(..., "amin")`, as the library
    yardstick of that pass.
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
    plain, again = run_plain(), run_kernel()
    # every render leaves the kernel's scratch as it found it
    winner, mask = points_cuda.scratch(p.pos.device, torch.cuda.current_stream().cuda_stream,
                                       cfg.width, cfg.height)
    clean = bool((winner == points_cuda.EMPTY).all()) and not bool(mask.any())
    # and the scratch the Engine's graphs replay on
    winner, mask = points_cuda.held(p.pos.device, eng._graph_stream.cuda_stream)
    clean = clean and bool((winner == points_cuda.EMPTY).all()) and not bool(mask.any())
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
          f"required), relaunch bit-equal, scratch clean {clean}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bnd[0]:.6f} ms "
          f"({bnd[1]}); one scatter_reduce_ amin (the winner pass only) {library_ms:.4f} ms")
    print(f"  summary {json.dumps(summary)}")
    if launches != POINTS_FRAMES:
        raise AssertionError(f"{launches} points launches, expected {POINTS_FRAMES}")
    if not torch.equal(img, plain) or not torch.equal(again, plain) or covered == 0:
        raise AssertionError("points kernel image differs from the plain renderer")
    if not clean:
        raise AssertionError("a points render left winner slots or mask bits set")
    whole_ms, blocks, resolve_ms = check_points_blocks(eng)
    SHARD_MS["points"] = (whole_ms, {**blocks, "resolve": resolve_ms})
    return launches, err, ms, plain_ms, bnd, library_ms


def _tiny_configs():
    """(name, config, frames): the tiny Engine config of tests/test_engine.py
    in each ported mode, tests/test_torch_engine_configs.py's shrunk
    plastic_collision, boosted_observer and row-gather scenes, the shrunk
    conical_defect of tests/test_torch_curved.py and a worldline3d view of
    the plastic scene's tiny discs through their impact; tests/test_btz.py's
    shrunk btz_hole (48x48, history 32) and a shrunk btz_extremal (the
    same with discs of 60)."""
    from spacetime_tpu_torch.ops.raytrace import RenderParams
    from spacetime_tpu_torch.ops.worldline3d import Worldline3DParams
    from spacetime_tpu_torch.utils.config import BLUE, RED, EngineConfig, SceneSpec, get_config

    out = []
    for mode in ("retarded", "instant", "points", "retina"):
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
    conical = get_config("conical_defect")
    out.append(("conical_defect", dataclasses.replace(
        conical, scene=SceneSpec(bodies=(("disc", 60, (0.25, 0.50), (0.0, 0.2), BLUE),
                                         ("disc", 60, (0.75, 0.50), (0.0, -0.2), RED))),
        render=dataclasses.replace(conical.render, num_rays=256), history=128, **shrink),
        SMALL_NEW_FRAMES))
    out.append(("worldline3d", EngineConfig(
        scene=SceneSpec(bodies=(("disc", 50, (0.40, 0.45), (0.12, 0.0), BLUE),
                                ("disc", 50, (0.4295, 0.453), (-0.12, 0.0), RED))),
        render=RenderParams(num_rays=256), cam_pos=(0.4113, 0.4437), cam_zoom=0.2,
        history=32, render_mode="worldline3d",
        wl3d=Worldline3DParams(time_scale=2.0, fade=0.5), **shrink), SMALL_NEW_FRAMES))
    out.append(("rows", dataclasses.replace(
        plastic, materials=None,
        scene=SceneSpec(bodies=(("disc", 450, (0.40, 0.45), (0.1, 0.0), BLUE),
                                ("disc", 450, (0.52, 0.452), (-0.1, 0.0), RED)),
                        lattice_pad=False),
        render=dataclasses.replace(plastic.render, num_rays=256), cam_pos=(0.4613, 0.4437),
        cam_zoom=0.3, history=32, **shrink), SMALL_NEW_FRAMES))
    for name, frames, bodies in (
            ("btz_hole", SMALL_NEW_FRAMES, None),
            ("btz_extremal", SMALL_EXTREMAL_FRAMES,
             (("disc", 60, (0.25, 0.50), (0.0, 0.3), BLUE),
              ("disc", 60, (0.75, 0.50), (0.0, -0.3), RED)))):
        cfg = get_config(name)
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, num_rays=256),
                                  history=32, **shrink)
        if bodies is not None:
            cfg = dataclasses.replace(cfg, scene=SceneSpec(bodies=bodies))
        out.append((name, cfg, frames))
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


def check_collision_state(particles, model, when):
    """Kernel vs plain (the include variant, as the path launches it) at a
    path's own state: the cell order built from its positions, at those
    positions (RK4 stage 0) and at stage 3's, pos + vel h, with the
    per-axis displacement its particles have (the widened scan).  Prints
    how fast the particles move; returns the max abs error."""
    from spacetime_tpu_torch.constants import C
    from spacetime_tpu_torch.ops import forces_cuda

    P = model.params
    act = particles.active
    order, stages = collision_inputs(particles, model)
    cd, rep = P.collision_distance, P.collision_repulsion_coefficient
    speed = particles.vel[act].norm(dim=1) / C
    errs, fmax = [], 0.0
    for k in (0, 3):
        at, disp = stages[k]
        f_kernel = forces_cuda.collision_forces(at, act, order, cd, rep, disp)
        f_plain = forces_cuda.collision_forces_plain(at, act, cd, rep)
        errs.append(collision_error(f_kernel, f_plain, act))
        fmax = max(fmax, f_plain[act].abs().max().item())
    dx, dy = stages[3][1].tolist()
    print(f"collision at {when}: {int(act.sum())} active, max |v|/c {speed.max().item():.4f} "
          f"({int((speed > 0.9).sum())} past 0.9c), stage 3 disp ({dx:.3e}, {dy:.3e}); "
          f"max|f| {fmax:.3f}; max abs err stage 0 {errs[0]:.3e}, stage 3 {errs[1]:.3e} "
          f"(rtol 1e-4, atol 1e-3)")
    return max(errs)


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


def refdemo_frame(device):
    """The reference demo's retarded frame (headline.build_refdemo: 116,178
    active particles at capacity 149,248, a T=1024 ring of 4.9 GB, 1920x1080,
    band 4, `splat_cells=4`, rank compaction) as the fused frame:
    REFDEMO_COMPARE_FRAMES graph frames bit-equal to the same stages run
    eagerly from a copy of the start state; then, with the launch counts
    reset, REFDEMO_FRAMES graph frames: 4 collision, 1 band and 1 pixel
    launch a frame, every drop counter summed over them 0 (segment_dropped
    included) and the pairs within pair_budget; then the pixel, band and
    collision kernels against plain on the final state.  Returns (state,
    model, objects, params, {kernel: (err, ms, plain ms, bound)}, launches)."""
    from spacetime_tpu_torch import fused, headline, kernels

    t0 = time.perf_counter()
    model, particles, objects, buf, cam, params = headline.build_refdemo(device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    state = fused.new_state(particles, buf, cam, 0.0)
    del particles, buf
    other = fused.copy_state(state)
    order = fused.schedule(1)
    stages = lambda st: fused.frame_stages(model, None, st, objects, headline.WIDTH,
                                           headline.HEIGHT, params, "retarded", model.params.h)
    graph = fused.FusedFrame(stages(state), order, device)
    eager = stages(other)
    unequal = []
    for i in range(REFDEMO_COMPARE_FRAMES):
        (img_g, ctr_g), (img_e, ctr_e) = graph(), fused.run_stages(eager, order)
        if not torch.equal(img_g, img_e) or not torch.equal(ctr_g, ctr_e):
            unequal.append(i)
    unequal += _state_diff(state, other)
    del other, eager
    kernels.reset_launch_counts()
    sums = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REFDEMO_FRAMES):
        img, ctr = graph()
        sums = ctr if sums is None else sums + ctr
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / REFDEMO_FRAMES * 1e3
    counts = dict(kernels.launches)
    render = graph.stages["render"]
    drops = fused.drops_of(sums, render)
    diag = fused.unpack(ctr, render)[1]
    pairs = int(diag.pairs_used)
    occupied = ((img != 1.0) & (img != np.float32(params.shadow))).any(dim=0).float().mean().item()
    p = state.particles
    print(f"refdemo frame: {int(p.active.sum())} active of {p.capacity}, ring "
          f"{4 * state.buf.pos_x.numel() * 4 / 1e9:.2f} GB, setup {setup:.2f} s; graph vs eager "
          f"({REFDEMO_COMPARE_FRAMES} frames from one start state) differ in "
          f"{unequal or 'nothing'}; then {REFDEMO_FRAMES} graph frames, {wall:.4f} ms wall a "
          f"frame; launches {counts}; graphs {graph.stats}; drop counters summed {drops}; "
          f"last frame pairs_used {pairs} (pair_budget {params.pair_budget}); occupied share "
          f"{occupied:.4f}")
    if unequal:
        raise AssertionError(f"refdemo graph frames differ from eager ones in {unequal}")
    if (counts["collision"] != 4 * REFDEMO_FRAMES or counts["band"] != REFDEMO_FRAMES
            or counts["pixel_pass"] != REFDEMO_FRAMES):
        raise AssertionError(f"refdemo launches {counts}, expected 4x / 1x / 1x {REFDEMO_FRAMES}")
    if any(drops.values()) or pairs > params.pair_budget:
        raise AssertionError(f"refdemo drops {drops}, pairs {pairs} of {params.pair_budget}")
    if not torch.isfinite(img).all() or occupied <= 0.0 or not torch.isfinite(p.pos).all():
        raise AssertionError("refdemo image or positions not finite, or all background")
    cam = fused.camera_of(state.frame_in)
    when = f"refdemo, after {REFDEMO_COMPARE_FRAMES + REFDEMO_FRAMES} frames"
    errs = {"pixel_pass": check_pixel(p, objects, state.buf, cam, params, headline.WIDTH,
                                      headline.HEIGHT, when),
            "band": check_band(state.buf, cam, params, when),
            "collision": time_collision(p, model)}
    return state, model, objects, params, errs, counts


def check_segments(state, objects, params):
    """At refdemo scale, on the final state: the frame at its `segments`
    (segment_dropped 0) against the uncompacted one (segments 0) under the
    pixel gate, the pairs equal; the drops at segments 2 counted; the
    particles by valid crossings; and the drop counters at the reference
    demo's own bin_capacity and segments."""
    from spacetime_tpu_torch import fused, headline
    from spacetime_tpu_torch.ops import raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    p, buf = state.particles, state.buf
    cam = fused.camera_of(state.frame_in)
    out = {}
    for k in sorted({params.segments, 0, 2}):
        pk = dataclasses.replace(params, segments=k)
        img, diag = raytrace.render_retarded_with_diag(
            buf, p.object_index, objects, cam, headline.WIDTH, headline.HEIGHT, pk, planar=True,
            boundary=wl.boundary_mask(p))
        out[k] = (img, diag)
    img, diag = out[params.segments]
    img0, diag0 = out[0]
    dropped = {k: (None if d.segment_dropped is None else int(d.segment_dropped))
               for k, (_, d) in out.items()}
    share = ((img - img0).abs().amax(dim=0) > PIXEL_TOL).float().mean().item()
    # valid crossings a particle, and the drops at tools/refdemo.py's own
    # params (bin_capacity 96, segments 2), which the refdemo row changes
    raw = raytrace._band_pairs(buf, p.object_index, objects, cam, wl.newest_time(buf),
                               headline.WIDTH, headline.HEIGHT,
                               dataclasses.replace(params, segments=0))[0]
    hist = torch.bincount(raw.pair_valid.reshape(-1, params.band).sum(dim=1)).tolist()
    ref = dataclasses.replace(params, bin_capacity=96, segments=2)
    _, rdiag = raytrace.render_retarded_with_diag(
        buf, p.object_index, objects, cam, headline.WIDTH, headline.HEIGHT, ref, planar=True,
        boundary=wl.boundary_mask(p))
    rdrops = {f: int(getattr(rdiag, f)) for f in ("bin_dropped", "segment_dropped",
                                                  "entry_dropped", "pairs_used")}
    print(f"segments at refdemo scale: segment_dropped by segments {dropped}; pairs_used "
          f"{ {k: int(d.pairs_used) for k, (_, d) in out.items()} }; segments="
          f"{params.segments} vs 0: pixel share > {PIXEL_TOL:g}: {share:.2e} (limit "
          f"{PIXEL_SHARE:g}), bit-equal {torch.equal(img, img0)}; particles by valid "
          f"crossings (0, 1, 2, ...) {hist}; at the reference demo's bin_capacity 96 and "
          f"segments 2: {rdrops}")
    if dropped[params.segments] != 0 or int(diag.pairs_used) != int(diag0.pairs_used) \
            or share > PIXEL_SHARE:
        raise AssertionError("the compacted refdemo frame disagrees with the uncompacted one")


def check_views(eng):
    """Engine.render_views with three cameras on the Engine's ring: bit-equal
    to three single renders at its render params, with 3 band and 3 pixel
    launches."""
    from spacetime_tpu_torch import kernels
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.ops import raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    cfg, dev = eng.config, eng.device
    x, y = eng.camera.pos.tolist()
    zoom = float(eng.camera.zoom)
    cams = [Camera.create(pos=(x, y), zoom=zoom, device=dev),
            Camera.create(pos=(x - 0.1, y + 0.05), zoom=0.8 * zoom, device=dev),
            Camera.create(pos=(x + 0.05, y), zoom=zoom, vel=(0.3, 0.0), device=dev)]
    kernels.reset_launch_counts()
    batch = eng.render_views(cams)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    params, p = eng._render_params(), eng.particles
    singles = [raytrace.render_retarded(eng.worldline, p.object_index, eng.objects, c, cfg.width,
                                        cfg.height, params, boundary=wl.boundary_mask(p))
               for c in cams]
    equal = [torch.equal(batch[i], s) for i, s in enumerate(singles)]
    print(f"render_views ({cfg.width}x{cfg.height}, 3 cameras on the flagship ring): "
          f"shape {tuple(batch.shape)}, launches {counts}, each view bit-equal to its single "
          f"render {equal}, lit shares {[round(_lit(s, params), 4) for s in singles]}")
    if batch.shape != (3, cfg.height, cfg.width, 3) or not all(equal):
        raise AssertionError("render_views differs from single renders")
    if counts["band"] != 3 or counts["pixel_pass"] != 3:
        raise AssertionError(f"render_views launches {counts}, expected 3 band and 3 pixel")


def graph_vs_eager(eng, frames=REFDEMO_COMPARE_FRAMES):
    """The Engine's frame stages at its current render params (its mode,
    defects, view parameters and aloof bodies) for `frames` frames from
    copies of its state: as CUDA graph replays and run eagerly.  Returns
    the frames whose image or counters differ and the state tensors that
    differ after them (empty when bit-equal)."""
    from spacetime_tpu_torch import fused

    cfg = eng.config
    a, b = fused.copy_state(eng._state), fused.copy_state(eng._state)
    params = eng._render_params()
    defects = eng._defects if cfg.render_mode == "conical" else None
    hole = eng._btz_hole() if cfg.render_mode == "btz" else None
    stages = lambda st: fused.frame_stages(eng.model, eng.materials, st, eng.objects, cfg.width,
                                           cfg.height, params, cfg.render_mode, cfg.physics.h,
                                           aloof=eng._aloof, present=eng.present,
                                           defects=defects, wl3d=cfg.wl3d, hole=hole,
                                           mesh=eng.mesh, object_index=eng._object_index)
    order = fused.schedule(cfg.steps_per_frame)
    graph, eager = fused.FusedFrame(stages(a), order, eng.device), stages(b)
    # a capture instantiates its graph in the driver's memory, outside
    # PyTorch's cache (btz_extremal's 541,170 nodes beside the Engine's own):
    # the blocks the earlier phases left cached go back to the driver first
    torch.cuda.empty_cache()
    unequal = []
    for i in range(frames):
        (ig, cg), (ie, ce) = graph(), fused.run_stages(eager, order)
        if not torch.equal(ig, ie) or not torch.equal(cg, ce):
            unequal.append(i)
    return unequal + _state_diff(a, b)


def engine_conical(device):
    """`conical_defect` through the CLI's code path (two 3,000-particle discs
    passing a defect of deficit 1.2, 512x512, history 512): CONICAL_FRAMES
    fused frames with 4 collision and 1 band launch a frame (route 1 on the
    band kernel; the route-2 sweep, the retinas and the route pass are
    plain torch) and no pixel launch, every drop 0 once the adaptation has
    settled; then its stages as graphs bit-equal to eager for
    REFDEMO_COMPARE_FRAMES frames from the final state, and the route-1
    band window (the Euclidean route at the Engine's params) against the
    plain sweep, exactly, and the collision kernel against plain at the
    final state (check_collision_state).  Returns (band check, collision
    error, seconds)."""
    t0 = time.perf_counter()
    eng, _, summary = engine_via_cli(
        ["--config", "conical_defect", "--frames", str(CONICAL_FRAMES), "--stats"],
        CONICAL_FRAMES, {"collision": 4, "band": 1}, drops="gate_after_boost")
    unequal = graph_vs_eager(eng)
    band = check_band(eng.worldline, eng.camera, eng._render_params(),
                      "engine conical_defect, final state, route 1")
    coll = check_collision_state(eng.particles, eng.model, "conical_defect's final state")
    seconds = time.perf_counter() - t0
    print(f"engine conical_defect: frame median {summary['frame_median_ms']:.4f} ms; graph vs "
          f"eager ({REFDEMO_COMPARE_FRAMES} frames from the final state) differ in "
          f"{unequal or 'nothing'}; phase {seconds:.2f} s")
    if unequal:
        raise AssertionError(f"conical graph frames differ from eager ones in {unequal}")
    return band, coll, seconds


def engine_selfgravity(device):
    """`selfgravity` through the CLI's code path (two 3,000-particle discs
    colliding, each sourcing a defect at its retarded centre of energy):
    SELFGRAVITY_FRAMES fused frames, 4 collision and 1 band launch a frame,
    the adaptation and the drops printed (three routes' pairs fill the
    view bins past the adaptation's bin_capacity ceiling of 384, and the
    impact truncates bands: this config drops work in the JAX package's
    algorithm too, so its drops are reported, not gated); then the two
    defects the last graph frame used (the render stage's own tensors,
    rewritten by each replay) against gravity.source_defects run eagerly
    on the final state, bit-equal, the stages as graphs bit-equal to
    eager for REFDEMO_COMPARE_FRAMES frames, and the collision kernel
    against plain at the final, post-impact state, where many particles
    move near c (check_collision_state).  Returns (collision error,
    seconds)."""
    from spacetime_tpu_torch.ops import gravity

    t0 = time.perf_counter()
    eng, _, summary = engine_via_cli(
        ["--config", "selfgravity", "--frames", str(SELFGRAVITY_FRAMES), "--stats"],
        SELFGRAVITY_FRAMES, {"collision": 4, "band": 1}, drops="report")
    cfg, params = eng.config, eng._render_params()
    captures = eng.graph_stats["captures"]
    used = eng._fused_frame_fn(params).stages["render"].defects
    again = gravity.source_defects(cfg.defect_source, eng.particles, eng.worldline, eng.camera,
                                   cfg.physics.h, cfg.defect_G, cfg.defect_retarded,
                                   max_age=params.max_age)
    equal = [torch.equal(u.center, a.center) and torch.equal(u.deficit, a.deficit)
             for u, a in zip(used, again)]
    unequal = graph_vs_eager(eng)
    coll = check_collision_state(eng.particles, eng.model,
                                 "selfgravity's final state (after the impact)")
    seconds = time.perf_counter() - t0
    print(f"engine selfgravity: frame median {summary['frame_median_ms']:.4f} ms; defects of "
          f"the last graph frame {[(u.center.tolist(), float(u.deficit)) for u in used]}, "
          f"recomputed eagerly bit-equal {equal}; graph vs eager ({REFDEMO_COMPARE_FRAMES} "
          f"frames from the final state) differ in {unequal or 'nothing'}; phase "
          f"{seconds:.2f} s")
    if eng.graph_stats["captures"] != captures or len(used) != 2 or not all(equal):
        raise AssertionError("the selfgravity graph's defects differ from the eager ones")
    if unequal:
        raise AssertionError(f"selfgravity graph frames differ from eager ones in {unequal}")
    return coll, seconds


def engine_worldline3d(device):
    """`worldline3d` through the CLI's code path (two 2,000-particle discs
    colliding, the ring drawn as an (x, y, t) block, 384 ticks):
    WL3D_FRAMES fused frames with 4 collision launches a frame and nothing
    else (the view is plain torch: one scatter_reduce_ amin), then its
    stages as graphs bit-equal to eager for REFDEMO_COMPARE_FRAMES frames,
    and the collision kernel against plain at the final state
    (check_collision_state).  Returns (collision error, seconds)."""
    t0 = time.perf_counter()
    eng, _, summary = engine_via_cli(
        ["--config", "worldline3d", "--frames", str(WL3D_FRAMES), "--stats"], WL3D_FRAMES,
        {"collision": 4}, drops="gate")
    unequal = graph_vs_eager(eng)
    coll = check_collision_state(eng.particles, eng.model, "worldline3d's final state")
    seconds = time.perf_counter() - t0
    print(f"engine worldline3d: frame median {summary['frame_median_ms']:.4f} ms; graph vs "
          f"eager ({REFDEMO_COMPARE_FRAMES} frames) differ in {unequal or 'nothing'}; phase "
          f"{seconds:.2f} s")
    if unequal:
        raise AssertionError(f"worldline3d graph frames differ from eager ones in {unequal}")
    return coll, seconds


def check_horizon(eng, img) -> int:
    """The pixels of `img` (H, W, 3) whose centres lie inside the Engine's
    BTZ horizon disc, and how many of them are black; fails if none is."""
    from spacetime_tpu_torch.camera import pixel_centers

    cfg, hole = eng.config, eng._btz_hole()
    pc = pixel_centers(cfg.width, cfg.height, eng.camera)
    d = pc - hole.center
    inside = (d * d).sum(dim=-1) < hole.r_h ** 2
    black = inside & (img.amax(dim=-1) == 0.0)
    n_in, n_black = int(inside.sum()), int(black.sum())
    if n_black == 0:
        raise AssertionError(f"{cfg.name}: no black pixel among the {n_in} inside the horizon")
    return n_in, n_black


def fallback_share(eng):
    """The exact solver's fallback share over route 0's band-sweep points of
    the Engine's ring: every stored position of an active particle, as the
    sweep evaluates them.  Returns (share, share outside the horizon,
    points)."""
    from spacetime_tpu_torch.ops import btz_exact

    buf, act, cam = eng.worldline, eng.particles.active, eng.camera
    hole = eng._btz_hole()
    qx, qy = buf.pos_x[:buf.capacity][:, act], buf.pos_y[:buf.capacity][:, act]
    fb = btz_exact.exact_route_optics_xy(qx, qy, cam.pos[0], cam.pos[1], hole, 0)[4]
    d2 = (qx - hole.center[0]) ** 2 + (qy - hole.center[1]) ** 2
    outside = d2 > hole.r_h ** 2
    n = fb.numel()
    return (fb.float().mean().item(), (fb & outside).float().sum().item() / max(n, 1), n)


def sweep_truncations(eng):
    """Each route's band sweep over the Engine's ring (a slow-rotation
    config), at the Engine's band and at its config's: the particles whose
    band truncates with the f32 route delays a frame uses, and with the
    same closed forms evaluated in float64.  Returns {band: [(f32, f64)
    for each route]}."""
    import dataclasses

    from spacetime_tpu_torch.ops import band_cuda, btz

    params, cam, hole = eng._render_params(), eng.camera, eng._btz_hole()
    hole64 = btz.BTZBlackHole(*(getattr(hole, f).double()
                                for f in ("center", "mass", "ads_l", "spin")))
    cx, cy = cam.pos.double()
    out = {}
    for band in sorted({params.band, eng.config.render.band}):
        p = dataclasses.replace(params, band=band)
        counts = []
        for r in btz.route_ids(p):
            f32 = lambda qx, qy, r=r: btz.route_delay_xy(qx, qy, cam.pos[0], cam.pos[1], hole, r)
            f64 = lambda qx, qy, r=r: btz.route_delay_xy(qx.double(), qy.double(), cx, cy, hole64,
                                                         r)
            counts.append(tuple(int(band_cuda.cone_band_window_plain(
                eng.worldline, p, cam, route_lengths=fn).truncated) for fn in (f32, f64)))
        out[band] = counts
    return out


def engine_btz(name, frames, drops):
    """A BTZ config through the CLI's code path (two 3,000-particle discs,
    512x512, every route on the plain sweep): `frames` fused frames with 4
    collision launches a frame and nothing else, the drops held by `drops`
    (engine_via_cli); then its stages as graphs bit-equal to eager for
    REFDEMO_COMPARE_FRAMES frames from the final state, the collision
    kernel against plain at that state (check_collision_state), a black
    pixel inside the horizon of an eager render there, and for the exact
    solver its fallback share, else each route's band truncations at that
    state with f32 and with float64 delays (sweep_truncations: where they
    differ, the f32 closed form cancels).  The frames after the last boost
    are set beside the JAX package's bin-drop tolerance (drop_envelope).
    Returns (collision launches, collision error, frame median ms,
    seconds)."""
    t0 = time.perf_counter()
    eng, counts, summary = engine_via_cli(["--config", name, "--frames", str(frames), "--stats"],
                                          frames, {"collision": 4}, drops=drops, envelope=True)
    unequal = graph_vs_eager(eng)
    coll = check_collision_state(eng.particles, eng.model, f"{name}'s final state")
    n_in, n_black = check_horizon(eng, eng.render())
    extra = ""
    if eng.config.render.btz_exact_spin:
        share, share_out, n = fallback_share(eng)
        extra = (f"; exact-solver fallbacks over route 0's {n} sweep points {share:.6f} "
                 f"({share_out:.6f} outside the horizon)")
    else:
        trunc = sweep_truncations(eng)
        extra = ("; band truncations of each route's sweep at the final state, (f32, float64): "
                 + ", ".join(f"band {b} {c}" for b, c in trunc.items()))
    seconds = time.perf_counter() - t0
    print(f"engine {name}: frame median {summary['frame_median_ms']:.4f} ms; graph vs eager "
          f"({REFDEMO_COMPARE_FRAMES} frames from the final state) differ in "
          f"{unequal or 'nothing'}; horizon {n_black} of {n_in} pixels black{extra}; phase "
          f"{seconds:.2f} s")
    if unequal:
        raise AssertionError(f"{name} graph frames differ from eager ones in {unequal}")
    return counts["collision"], coll, summary["frame_median_ms"], seconds


def engine_aloof(device):
    """flagship_1080p with an aloof disc on a circular trajectory through the
    view: its frame's stages as graph replays bit-equal to the same stages
    run eagerly from copies of the Engine's state (REFDEMO_COMPARE_FRAMES
    frames); then ALOOF_FRAMES fused Engine frames: one capture, 4 / 1 / 1
    launches a frame, the aloof slots at state_at(the device clock)."""
    from spacetime_tpu_torch import kernels
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.models.aloofbody import AloofBody, circular_trajectory, disc_template
    from spacetime_tpu_torch.utils.config import get_config

    cfg = get_config("flagship_1080p")
    body = AloofBody(disc_template(20), circular_trajectory((0.7, 0.5), 0.15, 0.3),
                     object_index=2)
    eng = Engine(cfg, device=device, aloof_bodies=[body])
    lo, hi = eng._aloof_slice
    params = eng._render_params()
    unequal = graph_vs_eager(eng)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = eng.run(ALOOF_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    t = eng._state.frame_in[5]
    pos, vel = body.state_at(t)
    at_clock = torch.equal(eng.particles.pos[lo:hi], pos) and torch.equal(
        eng.particles.vel[lo:hi], vel)
    img = eng.render()
    print(f"engine aloof (flagship_1080p + a {body.num_points}-point disc, circular): slots "
          f"{lo}-{hi} of {eng.particles.capacity}; graph vs eager ({REFDEMO_COMPARE_FRAMES} "
          f"frames) differ in {unequal or 'nothing'}; {ALOOF_FRAMES} fused frames in "
          f"{wall:.2f} s, launches {counts}, graphs {eng.graph_stats}; slots at state_at(clock "
          f"{float(t):.4f}) {at_clock}; lit share {_lit(img, params):.4f}")
    print(f"  summary {json.dumps(summary)}")
    if unequal or not at_clock:
        raise AssertionError(f"aloof frame: graph vs eager differ in {unequal}, slots at the "
                             f"clock {at_clock}")
    # moved to the front, the padded lattice's bonds lose their constant
    # offsets: the row-gather physics, the bond-excluding collision variant
    coll = "collision" if eng.model.spring_offsets is not None else "collision_exclude"
    want = {coll: 4, "band": 1, "pixel_pass": 1}
    g = eng.graph_stats
    keys = len(eng._fused_cache)
    if any(counts[k] != want.get(k, 0) * ALOOF_FRAMES for k in counts) \
            or g["captures"] != keys or g["captures"] + g["replays"] != ALOOF_FRAMES:
        raise AssertionError(f"aloof engine launches {counts}, graphs {g} for {keys} keys")


def check_euler(device):
    """SoftbodyModel(integrator="euler"): EULER_STEPS steps of the headline
    scene on the card with one collision launch a step; and the small
    two-disc scene of check_small_vs_cpu through its impact on the card
    against the CPU path."""
    from spacetime_tpu_torch import headline, kernels, scene
    from spacetime_tpu_torch.models.softbody import SoftbodyModel
    from spacetime_tpu_torch.ops import forces

    model, p, _, _, _, _ = headline.build(device)
    euler = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.cpu().numpy()),
                          device=device, integrator="euler")
    kernels.reset_launch_counts()
    for _ in range(EULER_STEPS):
        p, aux = euler.step(p)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    out = {}
    for dev in ("cpu", "cuda"):
        sb = scene.SceneBuilder()
        sb.add(scene.disc_softbody(6, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True))
        sb.add(scene.disc_softbody(6, 1, (0.395, 0.41), (-0.25, -0.05), lattice_pad=True))
        q, _ = sb.build(device=dev)
        m = SoftbodyModel(q.capacity, forces.derive_spring_offsets(q.neighbors.cpu().numpy()),
                          device=dev, integrator="euler")
        for _ in range(SMALL_FRAMES):
            q, qaux = m.step(q)
        out[dev] = (q.pos[q.active].cpu(), q.vel[q.active].cpu(), int(qaux.bonds_broken))
    pos_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
    vel_err = (out["cpu"][1] - out["cuda"][1]).abs().max().item()
    print(f"euler: {EULER_STEPS} headline steps, launches {counts}, bonds broken (last) "
          f"{int(aux.bonds_broken)}; small scene GPU vs CPU after {SMALL_FRAMES} steps: max "
          f"position err {pos_err:.3e}, velocity err {vel_err:.3e}")
    if counts["collision"] != EULER_STEPS or sum(counts.values()) != EULER_STEPS:
        raise AssertionError(f"euler launches {counts}, expected {EULER_STEPS} collision")
    if pos_err > 1e-4 or vel_err > 1e-3 or out["cuda"][2] != 0 or not torch.isfinite(p.pos).all():
        raise AssertionError("euler on the card disagrees with the CPU path")


def _io_launches(fn):
    """(fn()'s result, the launch counts it made), the counts reset just
    before it."""
    from spacetime_tpu_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launches)


def io_png_demo(tmp):
    """(a): png_demo through the CLI with --out; returns its launches."""
    import os

    from spacetime_tpu_torch import cli
    from spacetime_tpu_torch.utils import png

    out = os.path.join(tmp, "png_demo")
    seen = {}
    argv = ["--config", "png_demo", "--frames", str(IO_PNG_FRAMES), "--out", out, "--every",
            str(IO_EVERY)]
    t0 = time.perf_counter()
    (eng, _, summary), counts = _io_launches(lambda: cli.run(
        argv, on_frame=lambda i, img: seen.update({i: img}) if i % IO_EVERY == 0 else None))
    wall = time.perf_counter() - t0
    names = sorted(os.listdir(out))
    want = [f"frame_{i:08d}.png" for i in range(0, IO_PNG_FRAMES, IO_EVERY)]
    unequal = [i for i in seen
               if not np.array_equal(png.read_png(os.path.join(out, f"frame_{i:08d}.png")),
                                     (np.clip(seen[i].cpu().numpy(), 0.0, 1.0) * 255.0)
                                     .astype(np.uint8))]
    lit = float((seen[max(seen)].min(dim=-1).values < 0.9).float().mean())
    print(f"io (a) png_demo --out --every {IO_EVERY}: {len(names)} PNGs {names[0]}..{names[-1]} "
          f"({summary['sinks']['out']} FrameSink), read back unequal at frames {unequal or 'none'}"
          f"; {int(eng.particles.active.sum())} particles, lit share {lit:.4f}; launches "
          f"{counts}; graphs {eng.graph_stats}; {wall:.2f} s")
    if names != want or unequal or lit <= 0.0:
        raise AssertionError(f"png_demo frames: {names}, unequal at {unequal}, lit {lit}")
    if counts != {**{k: 0 for k in counts}, "collision": 4 * IO_PNG_FRAMES,
                  "band": IO_PNG_FRAMES, "pixel_pass": IO_PNG_FRAMES}:
        raise AssertionError(f"png_demo launches {counts}")
    return counts


def _http(port, target, stream=False):
    """GET `target` on loopback: the status, or the first JPEG part of a
    multipart stream."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=IO_TIMEOUT)
    try:
        c.request("GET", target)
        r = c.getresponse()
        if not stream:
            r.read()
            return r.status
        if r.fp.readline().strip() != b"--spacetimeframe":
            raise AssertionError("stream part has no boundary")
        length = None
        while (line := r.fp.readline().strip()):
            k, v = line.decode().split(":", 1)
            if k.strip().lower() == "content-length":
                length = int(v)
        return r.fp.read(length)
    finally:
        c.close()


def io_serve():
    """(b): flagship_1080p through the CLI with --serve 0, steered by a
    loopback client; returns its launches."""
    from spacetime_tpu_torch import cli, kernels
    from spacetime_tpu_torch.camera import CameraController

    eng, args = cli.build(["--config", "flagship_1080p", "--frames", str(IO_SERVE_LIMIT),
                           "--serve", "0"])
    sinks = cli.Sinks(args, eng)
    # the client acts inside frame i's callback; the Engine polls what it
    # posted at the start of frame i + 1
    posts = {3: ("d", 1), 8: ("d", 0), 10: ("o", 1), 14: ("q", 1)}
    got = {}

    def client(i, img):
        port = sinks.stream.port
        if i == 2:
            got["jpeg"] = _http(port, "/stream", stream=True)
        if i in posts:
            key, down = posts[i]
            got.setdefault("status", []).append(_http(port, f"/key?d={down}&k={key}"))
        if i == 10:
            got["before_o"] = dict(kernels.launches)
            got["frame"] = img

    pos0, zoom0 = eng._cam_pos.copy(), eng._cam_zoom
    t0 = time.perf_counter()
    summary, counts = _io_launches(lambda: cli.drive(eng, args, sinks, on_frame=client))
    wall = time.perf_counter() - t0
    # the same keys on the host: right held in frames 4-8
    ctl, pos, zoom = CameraController(), pos0, zoom0
    for _ in range(5):
        pos, zoom = ctl.update(pos, zoom, {"right": True},
                               eng.config.physics.h * eng.config.steps_per_frame)
    cam = eng.camera.pos.cpu().numpy()
    jpeg = got["jpeg"]
    after = counts["pixel_pass_camera_frame"] - got["before_o"]["pixel_pass_camera_frame"]
    print(f"io (b) flagship_1080p --serve 0 ({summary['sinks']['serve']} StreamSink): first "
          f"part {len(jpeg)} bytes, SOI {jpeg[:2].hex()} EOI {jpeg[-2:].hex()}; key posts "
          f"{got['status']}; camera x {pos0[0]:.6f} -> {cam[0]:.6f} (host controller "
          f"{pos[0]:.6f}); camera_frame {eng.config.render.camera_frame}, camera-frame "
          f"launches after o {after}; q ended the run at frame {eng.frame} of "
          f"{IO_SERVE_LIMIT}; launches {counts}; graphs {eng.graph_stats}; {wall:.2f} s")
    if jpeg[:2] != b"\xff\xd8" or jpeg[-2:] != b"\xff\xd9" or len(jpeg) < 5_000:
        raise AssertionError("the served part is not a whole JPEG frame")
    if got["status"] != [204] * 4 or not np.array_equal(cam, pos) or cam[0] <= pos0[0]:
        raise AssertionError(f"served keys: {got['status']}, camera {cam} vs host {pos}")
    if eng.frame != 15 or not eng.config.render.camera_frame or after != eng.frame - 11:
        raise AssertionError(f"served run: frame {eng.frame}, camera-frame launches {after}")
    return counts, got["frame"]


def io_sink_costs(img, tmp):
    """The host time of FrameSink.submit and StreamSink.submit on the
    frame `img` (a served 1080p frame) on each path the sink has here,
    the Python one forced too; the FrameSink's close (its drain) apart."""
    import os

    from spacetime_tpu_torch.utils import framesink, streamsink

    arr = framesink.quantize(img)  # as the CLI's sinks get it
    h, w, _ = arr.shape
    for path in ("native", "python"):
        saved = framesink._load, streamsink._load
        if path == "python":
            framesink._load = streamsink._load = lambda: None
        try:
            fs = framesink.FrameSink(os.path.join(tmp, f"costs_{path}"), w, h)
            ss = streamsink.StreamSink(0, w, h)
            if (fs.native, ss.native) == (False, False) and path == "native":
                fs.close()
                ss.close()
                continue
            t = []
            for i in range(8):
                t0 = time.perf_counter()
                fs.submit(i, arr)
                t.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fs_native = fs.native
            fs.close()
            drain = time.perf_counter() - t0
            u = []
            for _ in range(4):
                t0 = time.perf_counter()
                ss.submit(arr)
                u.append(time.perf_counter() - t0)
            ss_native = ss.native
            ss.close()
        finally:
            framesink._load, streamsink._load = saved
        print(f"  sink host cost at {w}x{h} ({path} paths asked; FrameSink native {fs_native}, "
              f"StreamSink native {ss_native}): FrameSink.submit median "
              f"{np.median(t) * 1e3:.3f} ms (max {max(t) * 1e3:.3f}), close after 8 frames "
              f"{drain * 1e3:.1f} ms; StreamSink.submit median {np.median(u) * 1e3:.3f} ms "
              f"(max {max(u) * 1e3:.3f})")


def io_replay(tmp):
    """(c): bench --record then --replay of flagship_1080p, bit-equal;
    returns the launches of both."""
    import os

    from spacetime_tpu_torch import bench

    path = os.path.join(tmp, "session.jsonl")
    (rec, rperf, rimg), rcounts = _io_launches(
        lambda: bench.record_session("flagship_1080p", IO_REPLAY_FRAMES, path))
    (rep, pperf, pimg), pcounts = _io_launches(lambda: bench.replay_session(path))
    unequal = _state_diff(rec._state, rep._state)
    if not torch.equal(rimg, pimg):
        unequal.append("image")
    print(f"io (c) flagship_1080p record / replay, {IO_REPLAY_FRAMES} frames of the bench's "
          f"scripted keys: recording {rperf['fps_avg']:.2f} fps (graphs {rec.graph_stats}), "
          f"replay {pperf['fps_avg']:.2f} fps (graphs {rep.graph_stats}) on {card_line()}; "
          f"zoom {float(rec.camera.zoom):.6f} / {float(rep.camera.zoom):.6f}; differ in "
          f"{unequal or 'nothing'}; launches {rcounts} / {pcounts}")
    if unequal:
        raise AssertionError(f"replay differs from the recording in {unequal}")
    return {k: rcounts[k] + pcounts[k] for k in rcounts}


def io_realtime():
    """(d): png_demo with --realtime at a live max_fps of IO_REALTIME_FPS."""
    from spacetime_tpu_torch import cli

    eng, args = cli.build(["--config", "png_demo", "--frames", str(IO_REALTIME_FRAMES),
                           "--realtime"])
    eng.hotswap["max_fps"] = IO_REALTIME_FPS
    stamps = []
    t0 = time.perf_counter()
    _, counts = _io_launches(lambda: cli.drive(eng, args, cli.Sinks(args, eng),
                                               on_frame=lambda i, img: stamps.append(
                                                   time.perf_counter())))
    wall = time.perf_counter() - t0
    gaps = np.diff(stamps)
    need = IO_REALTIME_FRAMES / IO_REALTIME_FPS
    print(f"io (d) png_demo --realtime at max_fps {IO_REALTIME_FPS}: {IO_REALTIME_FRAMES} "
          f"frames in {wall:.3f} s (at least {0.9 * need:.3f}); frame gaps after the first "
          f"{gaps[1:].min():.4f}-{gaps[1:].max():.4f} s; launches {counts}")
    # each frame is padded to 1 / fps from its start, so the gap from one
    # frame's callback to the next holds a whole budget after the first
    if wall < 0.9 * need or gaps[1:].min() < 0.9 / IO_REALTIME_FPS:
        raise AssertionError("--realtime did not pace the frames")
    return counts


def io_capacity():
    """(e): the capacity row with its frame, then band and pixel kernels
    against plain on its final state; returns its launches and checks."""
    from spacetime_tpu_torch import bench, fused, headline

    t0 = time.perf_counter()
    (row, state, objects, params), counts = _io_launches(lambda: bench.capacity_rows(True))
    wall = time.perf_counter() - t0
    print(f"io (e) capacity (2^20): {json.dumps(row)}")
    print(f"  launches {counts}; {wall:.2f} s")
    if row["particles"] != 1 << 20 or not np.isfinite(row["frame_ms"]):
        raise AssertionError(f"capacity row: {row}")
    cam = fused.camera_of(state.frame_in)
    band = check_band(state.buf, cam, params, "capacity, after its frames")
    pix = check_pixel(state.particles, objects, state.buf, cam, params,
                      headline.CAPACITY_WIDTH, headline.CAPACITY_HEIGHT,
                      "capacity, after its frames")
    return counts, band[0], pix[0]


def io_phase():
    """Phases (a)-(e) (see the module docstring): {path: launches}, the
    band and pixel errors at 2^20."""
    import shutil
    import tempfile

    from spacetime_tpu_torch.utils import native

    print(f"io phase: device memory at its start {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated, {torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_io_")
    try:
        launches = {"png_demo": io_png_demo(tmp)}
        launches["serve"], frame = io_serve()
        io_sink_costs(frame, tmp)
        launches["record_replay"] = io_replay(tmp)
        launches["realtime"] = io_realtime()
        launches["capacity"], band_err, pix_err = io_capacity()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"io phase: {time.perf_counter() - t0:.2f} s; native sink builds failed: "
          f"{native.build_errors or 'none'}")
    return launches, band_err, pix_err


def _shares(n: int, parts: int):
    """(first, count) of each of `parts` ranks' shares of n rows, as a mesh
    splits them (parallel/comm.block)."""
    from spacetime_tpu_torch.parallel import comm

    return [comm.block(n, r, parts) for r in range(parts)]


def check_collision_shares(particles, model, exclude=False):
    """The collision kernel over SHARES ranges of sorted rows (a mesh
    rank's launch) at RK4 stage 3's inputs of a path's final state: the
    shares' forces summed equal the whole launch's exactly (each particle
    has one nonzero contributor), and each share's launch is timed.
    Returns {parts: [ms of each share]}."""
    from spacetime_tpu_torch.ops import forces_cuda

    P = model.params
    act = particles.active
    nbr = particles.neighbors.contiguous() if exclude else None
    order, stages = collision_inputs(particles, model)
    moved, disp = stages[3]
    run = lambda rows=None: forces_cuda.collision_forces(  # noqa: E731
        moved, act, order, P.collision_distance, P.collision_repulsion_coefficient, disp,
        neighbors=nbr, rows=rows)
    whole, whole_ms = run(), cuda_ms(run)
    out = {}
    for parts in SHARES:
        ranges = _shares(particles.capacity, parts)
        got = [run(r) for r in ranges]
        total = got[0]
        for g in got[1:]:
            total = total + g
        if not torch.equal(total, whole):
            raise AssertionError(f"collision over {parts} row ranges differs from the whole "
                                 f"launch by {(total - whole).abs().max().item():.3e}")
        out[parts] = [cuda_ms(lambda r=r: run(r)) for r in ranges]
    name = "collision_exclude" if exclude else "collision"
    print(f"{name} row ranges (headline, after the main path, stage 3): summed shares "
          f"bit-equal to the whole launch for {list(SHARES)} ranges; whole {whole_ms:.4f} ms, "
          f"shares (ms) {out}")
    return whole_ms, out


def check_pixel_bands(particles, objects, buf, cam, params, width, height, when):
    """The pixel kernel over SHARES bands of view-cell rows (a mesh rank's
    launch) on a path's CSR: the bands stacked equal the whole image
    exactly; each band's launch is timed.  Returns (whole ms, {parts: [ms
    of each band]})."""
    from spacetime_tpu_torch.ops import render_cuda

    inputs, _ = pixel_inputs(particles, objects, buf, cam, params, width, height)
    run = lambda rows=None: render_cuda.pixel_pass(inputs, params, width=width,  # noqa: E731
                                                   height=height, rows=rows)
    whole, whole_ms = run(), cuda_ms(run)
    k, hc = params.cell_px, inputs.hc_img
    out = {}
    for parts in SHARES:
        per = -(-hc // parts)
        bands = [(row0, count, per * k) for row0, count in _shares(hc, parts)]
        img = torch.cat([run(b) for b in bands], dim=1)[:, :height]
        if not torch.equal(img, whole):
            raise AssertionError(f"pixel kernel over {parts} cell-row bands ({when}) differs "
                                 "from the whole launch")
        out[parts] = [cuda_ms(lambda b=b: run(b)) for b in bands]
    print(f"pixel cell-row bands ({when}; camera_frame {params.camera_frame}): stacked bands "
          f"bit-equal to the whole image for {list(SHARES)} bands; whole {whole_ms:.4f} ms, "
          f"bands (ms) {out}")
    return whole_ms, out


def check_points_blocks(eng):
    """The points kernel's winner pass over SHARES particle blocks with
    global indices (a mesh rank's launch), the planes MIN-reduced and
    resolved, against the whole render, exactly; each block's winner pass
    and the resolve pass are timed.  Returns (whole ms, {parts: [ms of
    each block's pass]}, resolve ms)."""
    from spacetime_tpu_torch.ops import points_cuda

    p, cfg, cam = eng.particles, eng.config, eng.camera
    w, h = cfg.width, cfg.height
    whole_run = lambda: points_cuda.render_points(p, eng.objects, cam, w, h)  # noqa: E731
    whole, whole_ms = whole_run(), cuda_ms(whole_run)
    out, resolve_ms = {}, None
    for parts in SHARES:
        if p.capacity % parts:
            raise AssertionError(f"capacity {p.capacity} does not split into {parts} blocks")
        b = p.capacity // parts
        blocks = [dataclasses.replace(p, pos=p.pos[r * b:(r + 1) * b].contiguous(),
                                      active=p.active[r * b:(r + 1) * b].contiguous())
                  for r in range(parts)]
        win = lambda r: points_cuda.points_winners(blocks[r], cam, w, h, r * b)  # noqa: E731
        merged = torch.stack([win(r) for r in range(parts)]).amin(0)
        resolve = lambda: points_cuda.points_resolve(merged, p.object_index,  # noqa: E731
                                                     eng.objects, w, h)
        if not torch.equal(resolve(), whole):
            raise AssertionError(f"points over {parts} blocks, MIN-reduced, differ from the "
                                 "whole render")
        out[parts] = [cuda_ms(lambda r=r: win(r)) for r in range(parts)]
        resolve_ms = cuda_ms(resolve)
    print(f"points blocks (refdemo, final state): winner planes MIN-reduced and resolved "
          f"bit-equal to the whole render for {list(SHARES)} blocks; whole {whole_ms:.4f} ms, "
          f"winner passes (ms) {out}, resolve of a merged plane {resolve_ms:.4f} ms")
    return whole_ms, out, resolve_ms


def _mesh_vs_single(cfg, mesh, device, frames, expect):
    """`cfg` for `frames` fused frames on one device, then on `mesh`, each
    Engine from its own scene build: the mesh run's launches (`expect`
    per frame), its graphs, its last image against the single run's
    (bit-equal, else the pixel gate), its state and its drops (equal).
    Returns (mesh Engine, its launches, its summary, the single summary)."""
    from spacetime_tpu_torch import kernels
    from spacetime_tpu_torch.engine import Engine

    ref, last = {}, {}
    single = Engine(cfg, device=device)
    single_summary = single.run(frames, on_frame=lambda i, img: ref.__setitem__("img", img))
    kernels.reset_launch_counts()
    meshed = Engine(cfg, mesh=mesh)
    t0 = time.perf_counter()
    summary = meshed.run(frames, on_frame=lambda i, img: last.__setitem__("img", img))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    want = {k: expect.get(k, 0) * frames for k in counts}
    g = meshed.graph_stats
    img, ref_img = last["img"], ref["img"]
    same = torch.equal(img, ref_img)
    share = ((img - ref_img).abs().amax(dim=-1) > PIXEL_TOL).float().mean().item()
    state_same = all(torch.equal(getattr(meshed.particles, f.name),
                                 getattr(single.particles, f.name))
                     for f in dataclasses.fields(meshed.particles)
                     if getattr(meshed.particles, f.name) is not None)
    print(f"mesh phase ({cfg.name}, {cfg.render_mode}, one-rank NCCL group, {frames} fused "
          f"frames): {wall:.2f} s wall; launches {counts}; graphs {g}; last image bit-equal "
          f"to the single-device Engine's: {same} (pixel share > {PIXEL_TOL:g}: {share:.2e}); "
          f"state bit-equal: {state_same}; drops {summary['drops']} (single device "
          f"{single_summary['drops']}); frame median {summary['frame_median_ms']:.4f} ms "
          f"(single device {single_summary['frame_median_ms']:.4f} ms)")
    if counts != want:
        raise AssertionError(f"mesh engine launches {counts}, expected {want}")
    if not 1 <= g["captures"] <= 8 or g["captures"] + g["replays"] != frames:
        raise AssertionError(f"mesh engine graphs {g} over {frames} frames")
    if not same and share > PIXEL_SHARE:
        raise AssertionError(f"mesh image differs from the single-device one on {share:.2e} of "
                             "pixels")
    if not state_same or summary["drops"] != single_summary["drops"]:
        raise AssertionError(f"mesh state differs, or its drops {summary['drops']} differ from "
                             f"the single device's {single_summary['drops']}")
    if not torch.isfinite(img).all() or _lit(img, meshed._render_params()) <= 0.0:
        raise AssertionError("mesh image not finite or shows no matter")
    return meshed, counts, summary, single_summary


def mesh_phase(device):
    """The Engine on a one-rank NCCL mesh (see the module docstring):
    flagship_1080p in retarded mode for MESH_FRAMES frames (then graph vs
    eager from its final state, and the collectives of one eager frame
    counted), in points mode for MESH_FRAMES, and conical_defect for
    MESH_CONICAL_FRAMES.  Returns the launches summed over the three mesh
    runs."""
    import socket

    import torch.distributed as dist

    from spacetime_tpu_torch.mesh_run import collectives_of_one_frame
    from spacetime_tpu_torch.parallel import mesh as mesh_mod
    from spacetime_tpu_torch.utils.config import get_config

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, device_id=device)
    try:
        mesh = mesh_mod.make_mesh()
        cfg = get_config("flagship_1080p")
        meshed, counts, _, _ = _mesh_vs_single(cfg, mesh, device, MESH_FRAMES,
                                               {"collision": 4, "band": 1, "pixel_pass": 1})
        unequal = graph_vs_eager(meshed)
        del meshed
        # the collectives of one eager mesh frame (the graphs replay the same)
        by_kind = collectives_of_one_frame(cfg, mesh)
        print(f"  flagship_1080p on the mesh: graph vs eager from the final state differs in "
              f"{unequal or 'nothing'}; collectives of one frame: "
              f"{sum(c for c, _ in by_kind.values())} calls, "
              f"{sum(b for _, b in by_kind.values())} bytes; by kind [calls, bytes] {by_kind}")
        if unequal:
            raise AssertionError(f"mesh graphs differ from eager in {unequal}")
        total = dict(counts)
        for c, mode, frames, expect in (
                (dataclasses.replace(cfg, render_mode="points"), "points", MESH_FRAMES,
                 {"collision": 4, "points": 1}),
                (get_config("conical_defect"), "conical", MESH_CONICAL_FRAMES,
                 {"collision": 4, "band": 1})):
            meshed, c_counts, _, _ = _mesh_vs_single(c, mesh, device, frames, expect)
            del meshed
            for k, v in c_counts.items():
                total[k] += v
        print(f"  mesh phase: {time.perf_counter() - t0:.2f} s")
        return total
    finally:
        dist.destroy_process_group()


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
    big_err = check_pixel(particles, objects, buf, cam,
                          dataclasses.replace(params, bin_capacity=BIG_BIN_CAPACITY),
                          headline.WIDTH, headline.HEIGHT, "headline, after the main path")[0]
    coll_err2, coll_ms, coll_plain_ms, coll_bnd = time_collision(particles, model)
    SHARD_MS["collision"] = check_collision_shares(particles, model)
    SHARD_MS["collision_exclude_bonds"] = check_collision_shares(particles, model, exclude=True)
    SHARD_MS["pixel_pass"] = check_pixel_bands(particles, objects, buf, cam, params,
                                               headline.WIDTH, headline.HEIGHT,
                                               "headline, after the main path")
    coll_err = max(coll_err, coll_err2)
    del model, particles, objects, buf
    graph_ms, eager_ms = check_graph_vs_eager(device)

    # the Engine, fused by default (each path with its launch counts reset
    # just before it)
    eng, _, fused_summary = engine_via_cli(
        ["--config", "flagship_1080p", "--frames", str(ENGINE_FRAMES), "--stats"],
        ENGINE_FRAMES, {"collision": 4, "pixel_pass": 1, "band": 1})
    retarded_errs = check_engine_kernels(eng)
    check_profile_stages(eng)
    check_views(eng)
    del eng
    eng, _, timed_summary = engine_via_cli(
        ["--config", "flagship_1080p", "--frames", str(ENGINE_FRAMES), "--stats",
         "--stage-timing"], ENGINE_FRAMES, {"collision": 4, "pixel_pass": 1, "band": 1})
    del eng
    print(f"flagship_1080p, {ENGINE_FRAMES} frames: frame_avg_ms fused (CUDA graphs) "
          f"{fused_summary['frame_avg_ms']:.4f} (median {fused_summary['frame_median_ms']:.4f}), "
          f"eager with --stage-timing {timed_summary['frame_avg_ms']:.4f} (median "
          f"{timed_summary['frame_median_ms']:.4f}); "
          f"headline frame wall: graph {graph_ms:.4f} ms, eager {eager_ms:.4f} ms")
    eng, _, _ = engine_via_cli(["--config", "flagship_1080p", "--frames", str(INSTANT_FRAMES),
                                "--mode", "instant"], INSTANT_FRAMES,
                               {"collision": 4, "pixel_pass": 1, "band": 0})
    instant_errs = check_engine_kernels(eng)
    del eng
    check_graph_cache(device)
    run_bench()
    pix_err = max(pix_err, retarded_errs["pixel_pass"][0], instant_errs["pixel_pass"][0], big_err)
    band_err = max(band_err0, band_err, retarded_errs["band"][0])
    pts_launches, pts_err, pts_ms, pts_plain_ms, pts_bnd, pts_lib_ms = engine_points(device)

    # the paths of this slice, each with its launch counts reset just before
    eng, boosted_counts, _ = engine_via_cli(
        ["--config", "boosted_observer", "--frames", str(BOOSTED_FRAMES), "--stats"],
        BOOSTED_FRAMES, {"collision": 4, "pixel_pass_camera_frame": 1, "band": 1},
        drops="gate")
    boosted_errs = check_engine_kernels(eng)
    SHARD_MS["pixel_pass_camera_frame"] = check_pixel_bands(
        eng.particles, eng.objects, eng.worldline, eng.camera, eng._render_params(),
        eng.config.width, eng.config.height, "engine boosted_observer, final state")
    cf_err, cf_ms, cf_plain_ms, cf_bnd = boosted_errs["pixel_pass"]
    band_err = max(band_err, boosted_errs["band"][0])
    big_cf_err = check_pixel(
        eng.particles, eng.objects, eng.worldline, eng.camera,
        dataclasses.replace(eng._render_params(), bin_capacity=BIG_BIN_CAPACITY),
        eng.config.width, eng.config.height, "engine boosted_observer, final state")[0]
    del eng
    eng, _, _ = engine_via_cli(["--config", "plastic_collision", "--frames", str(PLASTIC_FRAMES),
                             "--stats"], PLASTIC_FRAMES,
                            {"collision": 4, "pixel_pass": 1, "band": 1})
    check_plastic(eng)
    del eng
    cf_err = max(cf_err, big_cf_err)
    ex_launches, ex_err, ex_ms, ex_plain_ms, ex_bnd = engine_rows(device)
    check_small_vs_cpu()
    check_small_engine_vs_cpu()

    # the paths of this slice: the reference demo's retarded frame, the
    # segments check at its scale, the retina mode, aloof bodies and Euler
    state, _, objects, rd_params, rd_errs, _ = refdemo_frame(device)
    check_segments(state, objects, rd_params)
    pix_err = max(pix_err, rd_errs["pixel_pass"][0])
    band_err = max(band_err, rd_errs["band"][0])
    coll_err = max(coll_err, rd_errs["collision"][0])
    del state, objects
    engine_via_cli(["--config", "accelerated_camera", "--mode", "retina", "--frames",
                    str(RETINA_FRAMES), "--stats"], RETINA_FRAMES, {"collision": 4, "band": 1})
    engine_aloof(device)
    check_euler(device)

    # the paths of this slice: the conical mode (a static defect and
    # matter-sourced ones) and the worldline3d view
    (conical_band, conical_coll, conical_s), (sg_coll, selfgravity_s), (wl3d_coll, wl3d_s) = (
        engine_conical(device), engine_selfgravity(device), engine_worldline3d(device))
    band_err = max(band_err, conical_band[0])
    coll_err = max(coll_err, conical_coll, sg_coll, wl3d_coll)
    print(f"this slice's phases: conical_defect {conical_s:.2f} s, selfgravity "
          f"{selfgravity_s:.2f} s, worldline3d {wl3d_s:.2f} s, together "
          f"{conical_s + selfgravity_s + wl3d_s:.2f} s")

    # the paths of this slice: the btz mode, its five configs
    btz_runs = {name: engine_btz(name, frames, drops) for name, frames, drops in (
        ("btz_hole", BTZ_HOLE_FRAMES, "report"),
        ("btz_reflected", BTZ_FRAMES, "report"),
        ("btz_spinning", BTZ_FRAMES, "report"),
        ("btz_photon_ring", BTZ_FRAMES, "report"),
        ("btz_extremal", BTZ_EXTREMAL_FRAMES, "report"))}
    coll_err = max(coll_err, *(r[1] for r in btz_runs.values()))
    print("this slice's phases: " + ", ".join(
        f"{name} {r[3]:.2f} s (frame median {r[2]:.4f} ms)" for name, r in btz_runs.items())
        + f", together {sum(r[3] for r in btz_runs.values()):.2f} s")

    # the paths of this slice: I/O and tooling
    io_launches, io_band_err, io_pix_err = io_phase()
    band_err = max(band_err, io_band_err)
    pix_err = max(pix_err, io_pix_err)

    # the path of this slice: the Engine on a one-rank NCCL mesh
    mesh_counts = mesh_phase(device)

    record = lambda name, src, replaces, launches, err, ms, plain_ms, bnd, lib=None: {
        "name": name, "route": "cuda", "source": f"spacetime_tpu_torch/csrc/{src}",
        "replaces": replaces, "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": lib}
    # `launches` counts the headline main path; the btz configs' own runs
    # beside it
    collision = record("collision", "collision.cu", "spacetime_tpu/ops/forces_pallas.py:52",
                       counts["collision"], coll_err, coll_ms, coll_plain_ms, coll_bnd)
    collision["launches_btz"] = {name: r[0] for name, r in btz_runs.items()}
    rows = [
        collision,
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
    ]
    # the I/O phase's launches by path and the mesh phase's, beside each
    # kernel's main-path count; the share launches' times beside the whole
    # launch's (the band kernel runs unchanged on a rank's ring columns)
    for row, key in zip(rows, ("collision", "pixel_pass", "band", "points",
                               "collision_exclude", "pixel_pass_camera_frame")):
        row["launches_io"] = {path: c[key] for path, c in io_launches.items()}
        row["launches_mesh"] = mesh_counts[key]
        whole, shares = SHARD_MS.get(row["name"], (None, None))
        row["shard_ms"] = None if whole is None else {"whole": whole, **{
            str(k): v for k, v in shares.items()}}
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
