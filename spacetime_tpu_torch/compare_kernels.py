"""Time the port's kernels beside other trees', on one card.

    python3 -m spacetime_tpu_torch.compare_kernels [--other DIR ...]

Builds the inputs once with this package: the headline frame (headline.py)
stepped and pushed FRAMES times, through the discs' impact;
`flagship_1080p` with `lattice_pad=False` stepped ROWS_FRAMES times;
`boosted_observer` run BOOSTED_FRAMES frames through the Engine; and the
116k reference demo (`headline.refdemo_config`) run POINTS_FRAMES frames
in points mode.  From their final states it times, with the host out of
the reading (utils/timing.cuda_ms):

  * the collision kernel's include variant (headline) and exclude variant
    (unpadded flagship) at RK4 stage 3's and stage 0's inputs
    (`collision_inputs`);
  * the band kernel on the headline's ring with the headline's render
    params, with the ring in L2 (repeated calls) and with the L2 evicted
    before each call (as a frame finds the ring);
  * the pixel kernel on the headline's CSR (1920x1080, cell_px 16,
    bin_capacity 64), and its CAMERA_FRAME branch on the boosted Engine's
    CSR at the render params its last frame used (`checks.pixel_inputs`);
  * the points kernel on the reference demo's state at 1920x1080.

Each `--other DIR` loads `DIR/spacetime_tpu_torch` as another package, its
kernels built from its own sources under DIR/build/: a parent commit
unpacked with `git archive`, or a copy whose launch-shape constants were
edited to re-tune them (`kLanesInclude`, `kLanesExclude`, `kThreads` in
csrc/collision.cu; `kSlices` in csrc/band.cu; `kLanesGround`,
`kLanesCamera`, `kWarps` in csrc/pixel_pass.cu: lanes per run of 4 pixels
in each branch, warps per block).  Every reading is taken in the order:
the other trees, this tree twice, the other trees in reverse.  Every
tree's result is first held against the plain version by chip_smoke.py's
checks (checks.py: `collision_error`, `band_unequal`, `pixel_share`;
points bit-equal).  Prints the card, the launch floor, one line per
reading and, last, a JSON object of all readings.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from .checks import band_unequal, collision_error, collision_inputs, pixel_inputs, pixel_share

FRAMES = 200  # the headline discs meet at about frame 170
ROWS_FRAMES = 200  # the unpadded flagship discs meet near frame 120
BOOSTED_FRAMES = 300  # chip_smoke.py's boosted_observer run
POINTS_FRAMES = 100  # chip_smoke.py's points run
REPS = 50


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


def states(device):
    """{"headline": (model, particles, objects, ring, cam, params), "rows":
    (model, particles), "boosted": Engine, "points": Engine}, each run to
    its final state."""
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
    torch.cuda.synchronize()
    return {"headline": (model, p, objects, buf, cam, params), "rows": (eng.model, rows),
            "boosted": boosted, "points": points}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="root of another tree to time beside this one (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from . import headline, kernels
    from .ops import band_cuda, forces_cuda, points_cuda, render_cuda
    from .utils.timing import cuda_ms, launch_floor_ms

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
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
    print(f"headline after {FRAMES} frames: {int(hp.active.sum())} active of {hp.capacity}; "
          f"unpadded flagship after {ROWS_FRAMES} frames: {int(rp.active.sum())} active of "
          f"{rp.capacity}; boosted_observer after {BOOSTED_FRAMES} frames, refdemo after "
          f"{POINTS_FRAMES}: {int(points.particles.active.sum())} active of "
          f"{points.particles.capacity}")
    out = {"card": card, "launch_floor_ms": floor, "readings": []}
    order = [*args.other, "this", "this", *reversed(args.other)]

    def time_all(label, runs, cold=False):
        for tree in order:
            ms = cuda_ms(runs[tree], reps=REPS, cold=cold)
            print(f"  {label:<34} {tree:<24} {ms:.5f} ms")
            out["readings"].append({"kernel": label, "tree": tree, "ms": ms})

    def each_tree(module, make_run, check):
        """{tree: run} over every tree's `module`, each first checked."""
        runs = {}
        for tree, name in trees.items():
            runs[tree] = make_run(importlib.import_module(f"{name}.{module}"))
            check(tree, runs[tree]())
        return runs

    for state, (model, p), exclude in (("include", (hmodel, hp), False),
                                       ("exclude", (rmodel, rp), True)):
        P = model.params
        cd, rep = P.collision_distance, P.collision_repulsion_coefficient
        cells, stages = collision_inputs(p, model)
        nbr = p.neighbors.contiguous() if exclude else None
        for stage, (pos, disp) in stages.items():
            plain = forces_cuda.collision_forces_plain(pos, p.active, cd, rep, nbr)
            runs = each_tree("ops.forces_cuda",
                             lambda fc: lambda: fc.collision_forces(pos, p.active, cells, cd, rep,
                                                                    disp, neighbors=nbr),
                             lambda tree, ours: collision_error(ours, plain, p.active))
            time_all(f"collision {state}, stage {stage}", runs)
    band_plain = band_cuda.cone_band_window_plain(buf, params, cam)

    def band_check(tree, ours):
        unequal = band_unequal(ours, band_plain)
        if unequal:
            raise AssertionError(f"band kernel of {tree} differs from plain in {unequal}")

    runs = each_tree("ops.band_cuda", lambda bc: lambda: bc.cone_band_window(buf, params, cam),
                     band_check)
    time_all("band", runs)
    time_all("band, L2 evicted", runs, cold=True)

    cfg = boosted.config
    for label, frame in (
            ("pixel, headline", (hp, hobjects, buf, cam, params, headline.WIDTH,
                                 headline.HEIGHT)),
            ("pixel, camera frame (boosted)",
             (boosted.particles, boosted.objects, boosted.worldline, boosted.camera,
              boosted._render_params(), cfg.width, cfg.height))):
        rparams, width, height = frame[4:]
        inputs, _ = pixel_inputs(*frame)
        plain = render_cuda.pixel_pass_plain(inputs, rparams, width=width, height=height)
        runs = each_tree("ops.render_cuda",
                         lambda rc: lambda: rc.pixel_pass(inputs, rparams, width=width,
                                                          height=height),
                         lambda tree, ours: pixel_share(ours, plain))
        time_all(label, runs)

    pcfg = points.config
    pts = (points.particles, points.objects, points.camera, pcfg.width, pcfg.height)
    pts_plain = points_cuda.render_points_plain(*pts)

    def points_check(tree, ours):
        if not torch.equal(ours, pts_plain):
            raise AssertionError(f"points kernel of {tree} differs from plain")

    runs = each_tree("ops.points_cuda", lambda pc: lambda: pc.render_points(*pts), points_check)
    time_all("points (refdemo)", runs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
