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
  * small scenes on the GPU against the port's CPU path (which the tier-1
    tests hold against the JAX package): the headline frame's pieces and
    the Engine in all three modes.

Output: one line per phase, then a JSON line of per-kernel results, the
card's name and power limit from nvidia-smi, and as the last line
{"ok": true, "device": {...}}.  Any failure raises (non-zero exit, no
result line).  Needs CUDA: without it the script exits 1.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

FRAMES = 200  # the discs meet at about frame 170
ENGINE_FRAMES = 200  # flagship_1080p: the discs meet at about frame 120
INSTANT_FRAMES = 20
POINTS_FRAMES = 100
SMALL_FRAMES = 5  # frames of the small GPU-vs-CPU scene, through its impact
SMALL_ENGINE_FRAMES = 15  # frames of the tiny Engine config, GPU vs CPU
PIXEL_TOL = 1e-3  # per-pixel difference counted as a mismatch
PIXEL_SHARE = 1e-3  # largest share of mismatched pixels, kernel vs plain


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `reps` runs, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_collision(device):
    """Kernel vs plain on the overlapping two-disc scene of
    tests/test_forces_pallas.py, scaled to the bench's disc size: at the
    positions the cells were built from (the scan of RK4 stage 0), and after
    every particle moved by up to 0.3c x h per axis with the matching
    `max_disp` (the widened scan of stages 1-3)."""
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
    cell, _ = grid.cell_ids(pos, act, bres, bdim)
    order = forces_cuda.build_cell_order(cell, (bdim + 2) ** 2, bdim + 2, bres)
    disp = 0.3 * P.h
    step = rng.uniform(-disp, disp, tuple(pos.shape)).astype(np.float32)
    moved = (pos + torch.from_numpy(step).to(device) * act[:, None]).contiguous()
    errs = []
    for name, at, max_disp in (("still", pos, 0.0), ("moved", moved, float(np.abs(step).max()))):
        f_kernel = forces_cuda.collision_forces(
            at, act, order, P.collision_distance, P.collision_repulsion_coefficient,
            torch.tensor(max_disp, dtype=torch.float32, device=device))
        f_plain = forces_cuda.collision_forces_plain(
            at, act, P.collision_distance, P.collision_repulsion_coefficient)
        torch.cuda.synchronize()
        err = (f_kernel - f_plain)[act].abs().max().item()
        fmax = f_plain[act].abs().max().item()
        torch.testing.assert_close(f_kernel[act], f_plain[act], rtol=1e-4, atol=1e-3)
        if not fmax > 1.0:
            raise AssertionError(f"no contact in the collision check scene (max|f| = {fmax})")
        print(f"collision check ({name}, max_disp {max_disp:.3e}): {int(act.sum())} active, "
              f"max|f| {fmax:.3f}, max abs err {err:.3e} (rtol 1e-4, atol 1e-3)")
        errs.append(err)
    return max(errs)


def check_pixel(particles, objects, buf, cam, params, width, height, when):
    """Kernel vs plain on the CSR that `params` builds from `buf` (the
    path's own render params, so its cell size, bin capacity and retarded
    flag).  Returns (max abs err, ms, plain ms)."""
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
    print(f"pixel check ({when}; {width}x{height}, cell_px {params.cell_px}, bin_capacity "
          f"{params.bin_capacity}, retarded {params.retarded}): {inputs.entries.shape[0]} "
          f"entries, pairs {int(diag.pairs_used)}, max abs err {err:.3e}, share > "
          f"{PIXEL_TOL:g}: {share:.2e} (limit {PIXEL_SHARE:g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if share > PIXEL_SHARE:
        raise AssertionError(f"pixel kernel disagrees with plain on {share:.2e} of pixels")
    return err, ms, plain_ms


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
    truncated, every window value and age exactly equal.  Returns (max abs
    err, ms, plain ms)."""
    from spacetime_tpu_torch.ops import band_cuda

    run_kernel = lambda: band_cuda.cone_band_window(buf, params, cam)
    run_plain = lambda: band_cuda.cone_band_window_plain(buf, params, cam)
    ours, plain = run_kernel(), run_plain()
    torch.cuda.synchronize()
    names = ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages")
    unequal = [n for n in names if not torch.equal(getattr(ours, n), getattr(plain, n))]
    err = max((getattr(ours, n).double() - getattr(plain, n).double()).abs().max().item()
              for n in names)
    entered = int((plain.a0 <= plain.hi0).sum())
    ms, plain_ms = cuda_ms(run_kernel), cuda_ms(run_plain, reps=5)
    print(f"band check ({when}; band {params.band}, max_age {params.max_age}): "
          f"{entered} particles in the cone band, truncated "
          f"{int(plain.truncated)}, max abs err {err:.3e} (exact required); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if unequal or ours.hi0 != plain.hi0 or entered == 0:
        raise AssertionError(f"band kernel differs from plain in {unequal} ({entered} entered)")
    return err, ms, plain_ms


def _lit(img, params) -> float:
    """Share of pixels that show matter: neither background nor shadow."""
    return ((img != 1.0) & (img != np.float32(params.shadow))).any(dim=-1).float().mean().item()


def engine_via_cli(argv, frames, expect):
    """The Engine through the CLI's code path; `expect` maps a kernel name to
    its launches per frame."""
    from spacetime_tpu_torch import cli, kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    eng, img, summary = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    lit = _lit(img, eng._render_params())
    boosts = {f: getattr(eng, f) for f in eng._ADAPT_FIELDS}
    print(f"engine {' '.join(argv)}: {wall:.2f} s wall incl. setup; launches {counts}; "
          f"lit share {lit:.4f}; boosts {boosts}")
    print(f"  summary {json.dumps(summary)}")
    want = {k: v * frames for k, v in expect.items()}
    if any(counts[k] != n for k, n in want.items()):
        raise AssertionError(f"engine launches {counts}, expected {want}")
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
    retarded=False).  Returns {kernel name: max abs err}."""
    cfg = eng.config
    p = eng._render_params()
    when = f"engine {cfg.render_mode}, final state"
    errs = {}
    if cfg.render_mode == "instant":
        p = dataclasses.replace(p, opaque=False, retarded=False)
    else:
        errs["band"] = check_band(eng.worldline, eng.camera, p, when)[0]
    errs["pixel_pass"] = check_pixel(eng.particles, eng.objects, eng.worldline, eng.camera, p,
                                     cfg.width, cfg.height, when)[0]
    return errs


def engine_points(device):
    """The reference demo scene in points mode: POINTS_FRAMES frames through
    the Engine, then its last frame against the plain renderer on the same
    state (bit-equal).  Returns (launches, max abs err, ms, plain ms)."""
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
    print(f"engine points (refdemo): {int(p.active.sum())} active of {p.capacity}, setup "
          f"{setup:.2f} s, {POINTS_FRAMES} frames in {wall:.2f} s; points launches {launches}; "
          f"{covered} pixels covered; kernel vs plain max abs err {err:.3e} (bit-equal "
          f"required); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    print(f"  summary {json.dumps(summary)}")
    if launches != POINTS_FRAMES:
        raise AssertionError(f"{launches} points launches, expected {POINTS_FRAMES}")
    if not torch.equal(img, plain) or covered == 0:
        raise AssertionError("points kernel image differs from the plain renderer")
    return launches, err, ms, plain_ms


def check_small_engine_vs_cpu():
    """The tiny Engine config of tests/test_engine.py in each ported mode,
    on the GPU and on the port's CPU path: positions to 1e-4 and at most
    PIXEL_SHARE of pixels off by > PIXEL_TOL."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.ops.raytrace import RenderParams
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    for mode in ("retarded", "instant", "points"):
        out = {}
        for dev in ("cpu", "cuda"):
            cfg = EngineConfig(
                scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0),
                                         (0.2, 0.2, 1.0)),), capacity=256),
                render=RenderParams(num_rays=256), width=48, height=48, history=32,
                render_mode=mode)
            eng = Engine(cfg, device=dev)
            imgs = []
            eng.run(SMALL_ENGINE_FRAMES, on_frame=lambda i, img: imgs.append(img))
            out[dev] = (eng.particles.pos[eng.particles.active].cpu(), imgs[-1].cpu())
        pos_err = (out["cpu"][0] - out["cuda"][0]).abs().max().item()
        share = ((out["cpu"][1] - out["cuda"][1]).abs().amax(dim=-1) > PIXEL_TOL).float() \
            .mean().item()
        print(f"small engine ({mode}), GPU vs CPU path after {SMALL_ENGINE_FRAMES} frames: "
              f"max position err {pos_err:.3e}, pixel share > {PIXEL_TOL:g}: {share:.2e}")
        if pos_err > 1e-4 or share > PIXEL_SHARE:
            raise AssertionError(f"GPU Engine disagrees with the CPU path in {mode} mode")


def time_collision(particles, model):
    """Kernel vs plain time at the main path's shapes (its final state).
    The kernel is timed at RK4 stage 3's positions, pos + vel h, with the
    matching `max_disp`: the widened scan that 3 of a step's 4 launches run
    (stage 0 scans R = 1, also printed)."""
    from spacetime_tpu_torch.ops import forces_cuda, grid

    P = model.params
    act = particles.active
    bdim = int(round(model.grid_dim * P.grid_resolution / model.bin_resolution))
    cell, _ = grid.cell_ids(particles.pos, act, model.bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, (bdim + 2) ** 2, bdim + 2, model.bin_resolution)
    cd, rep = P.collision_distance, P.collision_repulsion_coefficient
    moved = particles.pos + particles.vel * P.h
    max_disp = torch.where(act[:, None], (moved - particles.pos).abs(), 0.0).amax()
    still = torch.zeros((), dtype=torch.float32, device=particles.pos.device)
    ms = cuda_ms(lambda: forces_cuda.collision_forces(moved, act, order, cd, rep, max_disp))
    still_ms = cuda_ms(lambda: forces_cuda.collision_forces(
        particles.pos, act, order, cd, rep, still))
    plain_ms = cuda_ms(lambda: forces_cuda.collision_forces_plain(moved, act, cd, rep), reps=5)
    print(f"collision timing at the main path's final state: kernel {ms:.4f} ms at stage 3's "
          f"positions (max_disp {max_disp.item():.3e}), {still_ms:.4f} ms at stage 0's; "
          f"plain {plain_ms:.4f} ms")
    return ms, plain_ms


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

    coll_err = check_collision(device)
    model, particles, objects, buf, cam, params = headline.build(device)
    pix_err, pix_ms, pix_plain_ms = check_pixel(particles, objects, buf, cam, params,
                                                headline.WIDTH, headline.HEIGHT,
                                                "headline, prefilled ring")
    band_err0, _, _ = check_band(buf, cam, params, "headline, prefilled ring")
    particles, buf, counts = main_path(model, particles, objects, buf, cam, params)
    band_err, band_ms, band_plain_ms = check_band(buf, cam, params,
                                                  "headline, after the main path")
    coll_ms, coll_plain_ms = time_collision(particles, model)
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
    pix_err = max(pix_err, retarded_errs["pixel_pass"], instant_errs["pixel_pass"])
    band_err = max(band_err0, band_err, retarded_errs["band"])
    pts_launches, pts_err, pts_ms, pts_plain_ms = engine_points(device)
    check_small_vs_cpu()
    check_small_engine_vs_cpu()

    print(json.dumps({"kernels": [
        {"name": "collision", "route": "cuda",
         "source": "spacetime_tpu_torch/csrc/collision.cu",
         "replaces": "spacetime_tpu/ops/forces_pallas.py:52",
         "launches": counts["collision"], "max_abs_err": coll_err,
         "ms": coll_ms, "plain_ms": coll_plain_ms},
        {"name": "pixel_pass", "route": "cuda",
         "source": "spacetime_tpu_torch/csrc/pixel_pass.cu",
         "replaces": "spacetime_tpu/ops/render_pallas.py:57",
         "launches": counts["pixel_pass"], "max_abs_err": pix_err,
         "ms": pix_ms, "plain_ms": pix_plain_ms},
        {"name": "band", "route": "cuda",
         "source": "spacetime_tpu_torch/csrc/band.cu",
         "replaces": "spacetime_tpu/ops/band_pallas.py:52",
         "launches": counts["band"], "max_abs_err": band_err,
         "ms": band_ms, "plain_ms": band_plain_ms},
        {"name": "points", "route": "cuda",
         "source": "spacetime_tpu_torch/csrc/points.cu",
         "replaces": "spacetime_tpu/ops/points_pallas.py:58",
         "launches": pts_launches, "max_abs_err": pts_err,
         "ms": pts_ms, "plain_ms": pts_plain_ms},
    ]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
