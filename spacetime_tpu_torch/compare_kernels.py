"""Time the collision and band kernels beside other trees', on one card.

    python3 -m spacetime_tpu_torch.compare_kernels [--other DIR ...]

Builds the inputs once with this package: the headline frame (headline.py)
stepped and pushed FRAMES times, through the discs' impact, and
`flagship_1080p` with `lattice_pad=False` stepped ROWS_FRAMES times.  From
their final states it times, with the host out of the reading
(utils/timing.cuda_ms):

  * the collision kernel's include variant (headline) and exclude variant
    (unpadded flagship) at RK4 stage 3's and stage 0's inputs
    (`collision_inputs`);
  * the band kernel on the headline's ring with the headline's render
    params, with the ring in L2 (repeated calls) and with the L2 evicted
    before each call (as a frame finds the ring).

Each `--other DIR` loads `DIR/spacetime_tpu_torch` as another package, its
kernels built from its own sources under DIR/build/: a parent commit
unpacked with `git archive`, or a copy whose launch-shape constants
(`kLanesInclude`, `kLanesExclude`, `kThreads` in csrc/collision.cu,
`kSlices` in csrc/band.cu) were edited to re-tune them.  Every reading is
taken in the order: the other trees, this tree twice, the other trees in
reverse.  Every tree's result is first held against the plain version
(`collision_error`, `band_unequal`).  Prints the card, the launch floor,
one line per reading and, last, a JSON object of all readings.

`collision_inputs`, `collision_error` and `band_unequal` are also
chip_smoke.py's: both hold the kernels to the same inputs and tolerances.
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

FRAMES = 200  # the headline discs meet at about frame 170
ROWS_FRAMES = 200  # the unpadded flagship discs meet near frame 120
REPS = 50
COLLISION_TOL = {"rtol": 1e-4, "atol": 1e-3}
BAND_FIELDS = ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages")


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
    """(headline model, particles, ring, cam, params), (rows model, particles)."""
    from . import headline
    from .engine import Engine
    from .ops import worldline as wl
    from .utils.config import get_config

    model, p, _, buf, cam, params = headline.build(device)
    for i in range(FRAMES):
        p, _ = model.step(p)
        wl.push_frame(buf, p, model.params.h * (i + 1))
    cfg = get_config("flagship_1080p")
    cfg = dataclasses.replace(cfg, scene=dataclasses.replace(cfg.scene, lattice_pad=False))
    eng = Engine(cfg, device=device)
    rows = eng.particles
    for _ in range(ROWS_FRAMES):
        rows, _ = eng.model.step(rows, eng.materials)
    torch.cuda.synchronize()
    return (model, p, buf, cam, params), (eng.model, rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="root of another tree to time beside this one (repeatable)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_kernels: CUDA is not available; this tool needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    from . import kernels
    from .ops import band_cuda, forces_cuda
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
    (hmodel, hp, buf, cam, params), (rmodel, rp) = states(device)
    print(f"headline after {FRAMES} frames: {int(hp.active.sum())} active of {hp.capacity}; "
          f"unpadded flagship after {ROWS_FRAMES} frames: {int(rp.active.sum())} active of "
          f"{rp.capacity}")
    out = {"card": card, "launch_floor_ms": floor, "readings": []}
    order = [*args.other, "this", "this", *reversed(args.other)]

    def time_all(label, runs, cold=False):
        for tree in order:
            ms = cuda_ms(runs[tree], reps=REPS, cold=cold)
            print(f"  {label:<34} {tree:<24} {ms:.5f} ms")
            out["readings"].append({"kernel": label, "tree": tree, "ms": ms})

    for state, (model, p), exclude in (("include", (hmodel, hp), False),
                                       ("exclude", (rmodel, rp), True)):
        P = model.params
        cd, rep = P.collision_distance, P.collision_repulsion_coefficient
        cells, stages = collision_inputs(p, model)
        nbr = p.neighbors.contiguous() if exclude else None
        for stage, (pos, disp) in stages.items():
            plain = forces_cuda.collision_forces_plain(pos, p.active, cd, rep, nbr)
            runs = {}
            for tree, name in trees.items():
                fc = importlib.import_module(name + ".ops.forces_cuda")
                runs[tree] = lambda fc=fc: fc.collision_forces(pos, p.active, cells, cd, rep,
                                                               disp, neighbors=nbr)
                collision_error(runs[tree](), plain, p.active)
            time_all(f"collision {state}, stage {stage}", runs)
    band_plain = band_cuda.cone_band_window_plain(buf, params, cam)
    runs = {}
    for tree, name in trees.items():
        bc = importlib.import_module(name + ".ops.band_cuda")
        runs[tree] = lambda bc=bc: bc.cone_band_window(buf, params, cam)
        unequal = band_unequal(runs[tree](), band_plain)
        if unequal:
            raise AssertionError(f"band kernel of {tree} differs from plain in {unequal}")
    time_all("band", runs)
    time_all("band, L2 evicted", runs, cold=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
