"""The Engine on N GPUs: one process a GPU, started by torchrun.

    torchrun --nproc-per-node 4 -m spacetime_tpu_torch.mesh_run --config flagship_1080p --frames 200
    torchrun --nproc-per-node 2 -m spacetime_tpu_torch.mesh_run --config single_blob --frames 10 \\
        --width 64 --height 64 --cpu --check

The counterpart of the JAX package's `tools/launch_multihost.py` driving
`Engine(config, mesh=...)`, which torchrun replaces.  Every rank joins the
group from torchrun's environment (`parallel.multihost.initialize`: NCCL,
each rank on cuda:LOCAL_RANK; gloo with `--cpu`), builds its Mesh and the
Engine on it, and runs the frames fused (the collectives inside the CUDA
graphs).  Rank 0 prints one JSON line: the world size, the card, the
stats summary (frame times, drops, graphs), the collectives of one eager
mesh frame by kind (calls and bytes a rank), and with `--check` whether
the last image and the gathered state are bit-equal to a single-device
Engine's (rank 0 runs it on its own device after the mesh run).  The
stats and the image are rank 0's, as the sinks are.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from .engine import MODES, Engine


def collectives_of_one_frame(cfg, mesh) -> dict:
    """{collective: [calls, bytes of their inputs]} of one eager frame of a
    fresh mesh Engine of `cfg`, counted around the torch.distributed
    functions (the fused frames' graphs replay the same collectives)."""
    import torch.distributed as dist

    eng = Engine(dataclasses.replace(cfg, stage_timing=True), mesh=mesh)
    names = [n for n in ("all_gather_into_tensor", "all_gather_single", "reduce_scatter_tensor",
                         "reduce_scatter_single", "all_reduce") if hasattr(dist, n)]
    originals = {n: getattr(dist, n) for n in names}
    seen: dict = {}

    def counted(name, fn):
        def call(*args, **kwargs):
            src = [x for x in args if isinstance(x, torch.Tensor)][-1]
            calls, nbytes = seen.get(name, (0, 0))
            seen[name] = (calls + 1, nbytes + src.numel() * src.element_size())
            return fn(*args, **kwargs)
        return call

    for n, fn in originals.items():
        setattr(dist, n, counted(n, fn))
    try:
        eng.run_frame()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
    return {k: list(v) for k, v in seen.items()}


def _run(args, mesh) -> dict:
    """The frames on the mesh (and with --check, rank 0's single-device
    run): the JSON record rank 0 prints.  Every Engine is dropped by the
    return, and with it its CUDA graphs: NCCL's communicator outlives no
    graph that captured its collectives (destroy_process_group waits for
    them)."""
    from .device import card_line
    from .parallel import multihost, sharding
    from .utils.config import get_config

    cfg = get_config(args.config)
    over = {k: v for k, v in (("render_mode", args.mode), ("width", args.width),
                              ("height", args.height)) if v is not None}
    cfg = dataclasses.replace(cfg, **over)
    eng = Engine(cfg, mesh=mesh)
    last = {}
    summary = eng.run(args.frames, on_frame=lambda i, img: last.__setitem__("img", img))
    out = {"world": mesh.size, "config": cfg.name, "mode": cfg.render_mode,
           "frames": args.frames, "particles_per_rank": eng.particles.capacity,
           "summary": summary, "collectives_per_frame": collectives_of_one_frame(cfg, mesh)}
    full = sharding.gather_particles(eng.particles, mesh, eng._n_full)
    del eng
    multihost.sync(mesh)
    if mesh.rank == 0:
        if not args.cpu:
            out["card"] = card_line()
        if args.check:
            ref = {}
            single = Engine(cfg, device=mesh.device)
            single.run(args.frames, on_frame=lambda i, img: ref.__setitem__("img", img))
            same_state = all(
                torch.equal(getattr(full, f.name), getattr(single.particles, f.name))
                for f in dataclasses.fields(full) if getattr(full, f.name) is not None)
            out["check"] = {"image_bit_equal": bool(torch.equal(last["img"], ref["img"])),
                            "state_bit_equal": bool(same_state),
                            "single_frame_median_ms": single.stats.summary().get(
                                "frame_median_ms")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="spacetime_tpu_torch.mesh_run", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="flagship_1080p", help="named config (utils/config.py)")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--mode", default=None, choices=list(MODES))
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--cpu", action="store_true", help="gloo processes on the CPU")
    ap.add_argument("--check", action="store_true",
                    help="rank 0 also runs the single-device Engine and compares")
    args = ap.parse_args(argv)

    from .parallel import mesh as mesh_mod
    from .parallel import multihost

    if not multihost.initialize(device="cpu" if args.cpu else None):
        print("mesh_run: no torchrun environment (RANK, WORLD_SIZE); start it with torchrun",
              file=sys.stderr)
        return 1
    try:
        mesh = mesh_mod.make_mesh()
        out = _run(args, mesh)
        if mesh.rank == 0:
            print(json.dumps(out), flush=True)
        multihost.sync(mesh)
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
