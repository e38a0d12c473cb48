"""Time the port's kernels beside other trees', on one card: the one tool
for kernel times and their bounds (PERF.md, the kernel table).

    python3 -m spacetime_tpu_torch.compare_kernels [--other DIR ...]

Builds the inputs once with this package: the headline frame (headline.py)
stepped and pushed FRAMES times, through the discs' impact;
`flagship_1080p` with `lattice_pad=False` stepped ROWS_FRAMES times;
`boosted_observer` run BOOSTED_FRAMES frames through the Engine; the 116k
reference demo (`headline.refdemo_config`) run POINTS_FRAMES frames in
points mode; its retarded world (`headline.build_refdemo`) stepped and
pushed REFDEMO_FRAMES times; and the 2^20 capacity scene as
`checks.capacity_frames` leaves it, then stepped on to STEP_CAPACITY_STEPS
steps.  From their final states it times, with the host out of the
reading (utils/timing.cuda_ms):

  * the collision kernel's include variant (headline) and exclude variant
    (unpadded flagship) at RK4 stage 3's and stage 0's inputs
    (`collision_inputs`);
  * the band kernel on the headline's ring with the headline's render
    params, with the ring in L2 (repeated calls) and with the L2 evicted
    before each call (as a frame finds the ring), and on the 2^20 ring,
    evicted;
  * the pixel kernel on the headline's CSR (1920x1080, cell_px 16,
    bin_capacity 64) and the 2^20 frame's (960x540), and its CAMERA_FRAME
    branch on the boosted Engine's CSR at the render params its last frame
    used (`checks.pixel_inputs`);
  * the points kernel on the reference demo's state at 1920x1080;
  * `bond_stage` at RK4 stage 3's shape and at the first evaluation (with
    breaking), and `step_finish`, on the 2^20 state's own planes;
  * the retina kernel's launch at the refdemo_116k and capacity_2p20
    cells' 4,096 rays x 16,384 pair rows, on the refdemo and 2^20 frames'
    boundary pairs (`checks.frame_retina`), warm;
  * the pair-rows kernel on the same two frames' band windows at their
    cells' render budgets (`checks.frame_pairs`), warm on the refdemo
    frame (its window fits the L2) and with the L2 evicted at 2^20 (a
    frame finds its 105 MB window there in device memory).

Each `--other DIR` loads `DIR/spacetime_tpu_torch` as another package, its
kernels built from its own sources under DIR/build/: a parent commit
unpacked with `git archive`, or a copy whose launch-shape constants were
edited to re-tune them (`kLanesInclude`, `kLanesExclude`, `kThreads` in
csrc/collision.cu; `kSlices` in csrc/band.cu; `kLanesGround`,
`kLanesCamera`, `kWarps` in csrc/pixel_pass.cu: lanes per run of 4 pixels
in each branch, warps per block).  A tree without a kernel's module (one
from before the kernel came in: `ops/step_cuda.py`, `ops/retina_cuda.py`,
`ops/pairs_cuda.py`)
reads "absent" on that row.  Every reading is taken in the order: the
other trees, this tree twice, the other trees in reverse.  Every tree's
result is first held against the plain version by chip_smoke.py's checks
(checks.py: `collision_error`, `band_unequal`, `pixel_share`; points,
retina, pair rows and the step's accumulators bit-equal).  Prints the card, the
launch floor, one line per reading, one line per row with the plain
version's time, the library call's where one stands for part of the work,
and the bound (utils/roofline.py) with this tree's roofline share, and,
last, a JSON object of all readings and rows.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from .checks import (CAPACITY_FRAMES, CAPACITY_STEPS, band_unequal, capacity_frames,
                     collision_error, collision_inputs, frame_pairs, frame_retina, pairs_unequal,
                     pixel_inputs, pixel_share, step_planes)

FRAMES = 200  # the headline discs meet at about frame 170
ROWS_FRAMES = 200  # the unpadded flagship discs meet near frame 120
BOOSTED_FRAMES = 300  # chip_smoke.py's boosted_observer run
POINTS_FRAMES = 100  # chip_smoke.py's points run
REFDEMO_FRAMES = 70  # chip_smoke.py's refdemo frames (the discs meet near frame 350)
STEP_CAPACITY_STEPS = 130  # the capacity boxes touch in step 119
RETINA_ROWS = 16384  # the retarded cells' retina_budget
# the refdemo_116k cell's render budgets (benchmark/configs/refdemo_116k.json)
REFDEMO_CELL = dict(band=6, segments=6, pair_budget=262144, retina_budget=RETINA_ROWS)
REPS = 50
PLAIN_REPS = 5


def load_other(root: str, name: str):
    """The `spacetime_tpu_torch` package of another tree, imported as
    `name` (its modules import each other relatively)."""
    init = Path(root).resolve() / "spacetime_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(name, init,
                                                  submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def tree_module(pkg: str, name: str):
    """Module `name` of the tree imported as `pkg`, or None where that tree
    has no such module (a tree from before its kernel came in)."""
    if importlib.util.find_spec(f"{pkg}.{name}") is None:
        return None
    return importlib.import_module(f"{pkg}.{name}")


def read_row(label, runs, order, timer, plain=None, library=None, bound=None) -> tuple:
    """One row of the table: `timer(run, reps)` of each tree's run in
    `order` (a tree whose run is None reads absent), then the plain
    version's and the library call's times, and the bound (bound_ms,
    bound_by) with its share of this tree's mean time.  Prints a line per
    reading and one for the row; returns (readings, row)."""
    readings = []
    for tree in order:
        run = runs.get(tree)
        ms = None if run is None else timer(run, REPS)
        print(f"  {label:<44} {tree:<24} " + ("absent" if ms is None else f"{ms:.5f} ms"))
        readings.append({"kernel": label, "tree": tree, "ms": ms})
    this = [r["ms"] for r in readings if r["tree"] == "this" and r["ms"] is not None]
    row = {"kernel": label, "ms": sum(this) / len(this) if this else None,
           "plain_ms": None if plain is None else timer(plain, PLAIN_REPS),
           "library_ms": None if library is None else timer(library, REPS),
           "bound_ms": None if bound is None else bound[0],
           "bound_by": None if bound is None else bound[1]}
    row["roofline"] = (row["bound_ms"] / row["ms"]
                       if row["bound_ms"] is not None and row["ms"] else None)
    text = [f"plain {row['plain_ms']:.4f} ms" if plain is not None else "",
            f"library {row['library_ms']:.4f} ms" if library is not None else "",
            f"bound {bound[0]:.6f} ms ({bound[1]})" if bound is not None else "",
            f"roofline {100 * row['roofline']:.1f}%" if row["roofline"] is not None else ""]
    print(f"  {label:<44} {'(row)':<24} " + "; ".join(t for t in text if t))
    return readings, row


def states(device):
    """{"headline": (model, particles, objects, ring, cam, params), "rows":
    (model, particles), "boosted": Engine, "points": Engine, "refdemo":
    (particles, objects, ring, cam, params), "capacity": (model, objects,
    params, fused state, its particles stepped on to STEP_CAPACITY_STEPS
    steps)}, each run to its final state."""
    from . import headline
    from .engine import Engine
    from .ops import worldline as wl
    from .utils.config import get_config

    model, p, objects, buf, cam, params = headline.build(device)
    for i in range(FRAMES):
        p, _ = model.step(p)
        wl.push_frame(buf, p, model.params.h * (i + 1))
    cfg = get_config("flagship_1080p")
    cfg = dataclasses.replace(cfg, scene=dataclasses.replace(cfg.scene, lattice_pad=False))
    eng = Engine(cfg, device=device)
    rows = eng.particles
    for _ in range(ROWS_FRAMES):
        rows, _ = eng.model.step(rows, eng.materials)
    boosted = Engine(get_config("boosted_observer"), device=device)
    boosted.run(BOOSTED_FRAMES)
    points = Engine(headline.refdemo_config(), device=device)
    points.run(POINTS_FRAMES)
    rmodel, rp, robjects, rbuf, rcam, rparams = headline.build_refdemo(device)
    for i in range(REFDEMO_FRAMES):
        rp, _ = rmodel.step(rp)
        wl.push_frame(rbuf, rp, rmodel.params.h * (i + 1))
    cmodel, cobjects, cparams, cstate = capacity_frames(device)[:4]
    stepped, _ = cmodel.step_n(cstate.particles,
                               STEP_CAPACITY_STEPS - CAPACITY_STEPS - CAPACITY_FRAMES)
    torch.cuda.synchronize()
    return {"headline": (model, p, objects, buf, cam, params), "rows": (eng.model, rows),
            "boosted": boosted, "points": points,
            "refdemo": (rp, robjects, rbuf, rcam, rparams),
            "capacity": (cmodel, cobjects, cparams, cstate, stepped)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="root of another tree to time beside this one (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from . import fused, headline, kernels
    from .camera import world_to_pixel
    from .device import card_line
    from .ops import (band_cuda, forces_cuda, pairs_cuda, points_cuda, raytrace, render_cuda,
                      retina_cuda, rk4)
    from .utils import roofline
    from .utils.timing import cuda_ms, launch_floor_ms

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels.library()
    trees = {"this": __package__}
    for k, root in enumerate(args.other):
        trees[root] = load_other(root, f"other{k}_spacetime_tpu_torch").__name__
        importlib.import_module(trees[root] + ".kernels").library()
    floor = launch_floor_ms()
    print(f"launch floor: {floor:.5f} ms a launch")
    st = states(device)
    hmodel, hp, hobjects, buf, cam, params = st["headline"]
    rmodel, rp = st["rows"]
    boosted, points = st["boosted"], st["points"]
    cmodel, cobjects, cparams, cstate, stepped = st["capacity"]
    cp = cstate.particles
    print(f"headline after {FRAMES} frames: {int(hp.active.sum())} active of {hp.capacity}; "
          f"unpadded flagship after {ROWS_FRAMES} frames: {int(rp.active.sum())} active of "
          f"{rp.capacity}; boosted_observer after {BOOSTED_FRAMES} frames, refdemo after "
          f"{POINTS_FRAMES} (points) and {REFDEMO_FRAMES} (retarded): "
          f"{int(points.particles.active.sum())} active of {points.particles.capacity}; "
          f"capacity: {int(cp.active.sum())} active")
    out = {"card": card, "launch_floor_ms": floor, "readings": [], "rows": []}
    order = [*args.other, "this", "this", *reversed(args.other)]

    def row(label, module, make_run, check, cold=False, **extra):
        """Every tree's run of a kernel whose module is `module` (absent
        where the tree has none), each first checked, then read_row."""
        runs = {}
        for tree, pkg in trees.items():
            runs[tree] = None if tree_module(pkg, module) is None else make_run(pkg)
            if runs[tree] is not None:
                check(tree, runs[tree]())
        readings, summary = read_row(
            label, runs, order, lambda fn, reps: cuda_ms(fn, reps=reps, cold=cold), **extra)
        out["readings"] += readings
        out["rows"].append(summary)

    def imported(pkg, name):
        return importlib.import_module(f"{pkg}.{name}")

    for state, (model, p), exclude in (("include", (hmodel, hp), False),
                                       ("exclude", (rmodel, rp), True)):
        P = model.params
        cd, rep = P.collision_distance, P.collision_repulsion_coefficient
        cells, stages = collision_inputs(p, model)
        nbr = p.neighbors.contiguous() if exclude else None
        for stage, (pos, disp) in sorted(stages.items(), reverse=True):
            plain = forces_cuda.collision_forces_plain(pos, p.active, cd, rep, nbr)
            row(f"collision {state}, stage {stage}", "ops.forces_cuda",
                lambda pkg: lambda: imported(pkg, "ops.forces_cuda").collision_forces(
                    pos, p.active, cells, cd, rep, disp, neighbors=nbr),
                lambda tree, ours: collision_error(ours, plain, p.active),
                plain=lambda: forces_cuda.collision_forces_plain(pos, p.active, cd, rep, nbr),
                bound=roofline.collision_bound(pos, p.active, cells, cd, max(disp.tolist()),
                                               nbr))

    ccam = fused.camera_of(cstate.frame_in)
    for label, (ring, rparams, rcam), colds in (
            ("band, headline", (buf, params, cam), (False, True)),
            ("band, 2^20", (cstate.buf, cparams, ccam), (True,))):
        band_plain = band_cuda.cone_band_window_plain(ring, rparams, rcam)

        def band_check(tree, ours):
            unequal = band_unequal(ours, band_plain)
            if unequal:
                raise AssertionError(f"band kernel of {tree} differs from plain in {unequal}")

        for cold in colds:
            row(label + (", L2 evicted" if cold else ""), "ops.band_cuda",
                lambda pkg: lambda: imported(pkg, "ops.band_cuda").cone_band_window(
                    ring, rparams, rcam),
                band_check, cold=cold,
                plain=lambda: band_cuda.cone_band_window_plain(ring, rparams, rcam),
                bound=roofline.band_bound(ring, rparams))

    bcfg = boosted.config
    for label, frame in (
            ("pixel, headline", (hp, hobjects, buf, cam, params, headline.WIDTH,
                                 headline.HEIGHT)),
            ("pixel, 2^20", (cp, cobjects, cstate.buf, ccam, cparams, headline.CAPACITY_WIDTH,
                             headline.CAPACITY_HEIGHT)),
            ("pixel, camera frame (boosted)",
             (boosted.particles, boosted.objects, boosted.worldline, boosted.camera,
              boosted._render_params(), bcfg.width, bcfg.height))):
        rparams, width, height = frame[4:]
        inputs, _ = pixel_inputs(*frame)
        plain = render_cuda.pixel_pass_plain(inputs, rparams, width=width, height=height)
        row(label, "ops.render_cuda",
            lambda pkg: lambda: imported(pkg, "ops.render_cuda").pixel_pass(
                inputs, rparams, width=width, height=height),
            lambda tree, ours: pixel_share(ours, plain),
            plain=lambda: render_cuda.pixel_pass_plain(inputs, rparams, width=width,
                                                       height=height),
            bound=roofline.pixel_bound(inputs, rparams, width, height))

    pcfg, pp = points.config, points.particles
    pts = (pp, points.objects, points.camera, pcfg.width, pcfg.height)
    pts_plain = points_cuda.render_points_plain(*pts)

    def points_check(tree, ours):
        if not torch.equal(ours, pts_plain):
            raise AssertionError(f"points kernel of {tree} differs from plain")

    # the library yardstick of the winner pass: one scatter_reduce_ amin
    # over the pixel of each particle, as render_points_plain builds it
    n, hw = pp.capacity, pcfg.width * pcfg.height
    px = torch.round(world_to_pixel(pp.pos, pcfg.width, pcfg.height, points.camera))
    x, y = px[:, 0], px[:, 1]
    inside = pp.active & (x >= 0) & (x < pcfg.width) & (y >= 0) & (y < pcfg.height)
    flat = torch.where(inside, torch.where(inside, y, 0.0).long() * pcfg.width
                       + torch.where(inside, x, 0.0).long(), hw)
    ids = torch.arange(n, device=device)
    winner = torch.full((hw + 1,), n, dtype=torch.int64, device=device)
    row("points (refdemo)", "ops.points_cuda",
        lambda pkg: lambda: imported(pkg, "ops.points_cuda").render_points(*pts), points_check,
        plain=lambda: points_cuda.render_points_plain(*pts),
        library=lambda: winner.scatter_reduce_(0, flat, ids, "amin"),
        bound=roofline.points_bound(n, pcfg.width, pcfg.height))

    # the step kernels on the 2^20 state's own planes (checks.step_planes)
    P = cmodel.params
    planes = step_planes(stepped, cmodel)
    cells, stages = collision_inputs(stepped, cmodel)
    (start, still), (moved, disp) = stages[0], stages[3]
    nbrs = None if cmodel.spring_offsets is not None else planes.neighbors
    cd, rep = P.collision_distance, P.collision_repulsion_coefficient
    coll0 = forces_cuda.collision_forces(start, stepped.active, cells, cd, rep, still,
                                         neighbors=nbrs)
    coll3 = forces_cuda.collision_forces(moved, stepped.active, cells, cd, rep, disp,
                                         neighbors=nbrs)
    fold = torch.zeros(2, device=device)  # the displacement each timed call folds into
    evals = {"stage 3": dict(gpos=moved, coll=coll3, facc=coll0, weight=2),
             "first": dict(gpos=start, coll=coll0, facc=None, weight=0)}

    def counter(which):  # the first evaluation breaks bonds and counts them
        return ({"broken": torch.zeros((), dtype=torch.int32, device=device)}
                if which == "first" else {})

    want = {k: rk4.bond_stage_plain(planes, P, **a, **counter(k), h_adv=P.h / 2.0,
                                    disp=torch.zeros_like(fold))
            for k, a in evals.items()}

    def stage_check(which):
        def check(tree, ours):
            err = (ours.next_pos - want[which].next_pos).abs().max().item()
            if not torch.equal(ours.facc, want[which].facc) or err > 1e-6 or (
                    which == "first" and not torch.equal(ours.neighbors,
                                                         want[which].neighbors)):
                raise AssertionError(f"bond_stage of {tree} differs from the plain chain "
                                     f"({which}; next positions off by {err:.3e})")
        return check

    stage_bound, finish_bound = roofline.step_bounds(planes, 2, False)
    bounds = {"stage 3": stage_bound, "first": roofline.step_bounds(planes, 0, True)[0]}
    for which, a in evals.items():
        extra = counter(which)
        row(f"bond_stage, {which} (2^20)", "ops.step_cuda",
            lambda pkg: lambda: imported(pkg, "ops.rk4").bond_stage(
                imported(pkg, "ops.rk4").StepPlanes(**planes._asdict()), P, **a, **extra,
                h_adv=P.h / 2.0, disp=fold),
            stage_check(which),
            plain=lambda: rk4.bond_stage_plain(planes, P, **a, **extra, h_adv=P.h / 2.0,
                                               disp=fold),
            bound=bounds[which])
    facc = want["stage 3"].facc
    fin_plain = rk4.step_finish_plain(planes, P, facc)

    def finish_check(tree, ours):
        torch.testing.assert_close(ours[0], fin_plain[0], rtol=0, atol=1e-6)
        torch.testing.assert_close(ours[1], fin_plain[1], rtol=1e-5, atol=1e-6)

    row("step_finish (2^20)", "ops.step_cuda",
        lambda pkg: lambda: imported(pkg, "ops.rk4").step_finish(
            imported(pkg, "ops.rk4").StepPlanes(**planes._asdict()), P, facc),
        finish_check, plain=lambda: rk4.step_finish_plain(planes, P, facc),
        bound=finish_bound)

    rp_, robjects, rbuf, rcam, rparams = st["refdemo"]
    for label, frame in (
            ("retina, refdemo", (rbuf, rp_, robjects, rcam,
                                 dataclasses.replace(rparams, retina_budget=RETINA_ROWS),
                                 headline.WIDTH, headline.HEIGHT)),
            ("retina, 2^20", (cstate.buf, cp, cobjects, ccam, cparams,
                              headline.CAPACITY_WIDTH, headline.CAPACITY_HEIGHT))):
        pairs, rcam_, t_now, rpar = frame_retina(*frame)
        theta = raytrace._ray_angles(rpar.num_rays, device)
        dhx, dhy = torch.cos(theta), torch.sin(theta)
        retina_plain = retina_cuda.retina_march_plain(pairs, rcam_, t_now, rpar)

        def retina_run(pkg):
            s_first = torch.full_like(dhx, raytrace._BIG)
            launch = imported(pkg, "ops.retina_cuda").launch

            def run():
                launch(pairs, dhx, dhy, rcam_, t_now, rpar, s_first)
                return s_first
            return run

        def retina_check(tree, ours):
            if not torch.equal(ours, retina_plain):
                raise AssertionError(f"retina kernel of {tree} differs from plain")

        row(f"{label} ({int(pairs.pair_valid.sum())} of {pairs.pdata.shape[0]} rows valid)",
            "ops.retina_cuda", retina_run, retina_check,
            plain=lambda: retina_cuda.retina_march_plain(pairs, rcam_, t_now, rpar),
            bound=roofline.retina_bound(pairs, rpar))

    for label, frame, cold in (
            ("pairs, refdemo", (rbuf, rp_, robjects, rcam,
                                dataclasses.replace(rparams, **REFDEMO_CELL),
                                headline.WIDTH, headline.HEIGHT), False),
            ("pairs, 2^20, L2 evicted", (cstate.buf, cp, cobjects, ccam, cparams,
                                         headline.CAPACITY_WIDTH, headline.CAPACITY_HEIGHT),
             True)):
        args = frame_pairs(*frame)
        want = pairs_cuda.pair_rows_plain(*args)

        def pairs_check(tree, ours):
            bad = pairs_unequal(ours, want)
            if bad:
                raise AssertionError(f"pair-rows kernel of {tree} differs from plain in {bad}")

        rows, n_pairs = want[0].pdata.shape[0], int(want[0].n_pairs)
        row(f"{label} ({n_pairs} valid, {rows} rows out)", "ops.pairs_cuda",
            lambda pkg: lambda: imported(pkg, "ops.pairs_cuda").pair_rows(*args), pairs_check,
            cold=cold, plain=lambda: pairs_cuda.pair_rows_plain(*args),
            bound=roofline.pairs_bound(args[0], args[7], rows, min(n_pairs, rows)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
