"""The port's multi-GPU layer (spacetime_tpu_torch/parallel/) on the CPU:
real gloo worker processes against the port's single-device path, and one
sharded frame against JAX's `make_sharded_frame`.

The workers are this file run as a script (`_worker`, below): torchrun's
environment variables and a free port, one process a rank, world sizes 2
and 3 (3 pads the 256-particle capacity to 258: blocks of 86 whose last
one holds only padding).  Each world size is spawned once, every check
runs inside it, and each rank writes its findings as JSON; the tests read
them.  A worker imports no JAX.  Every worker gets a hard timeout and all
are killed on its expiry.

What the workers hold, bit for bit, against the single-device port:
  * the sharded step (`make_sharded_step`, with the collision kernel's
    plain version over each rank's sorted rows): the shifted and the
    row-gather physics, and materials with plastic creep, each under RK4
    and under Euler;
  * the sharded retarded and instant frames (`make_sharded_frame`);
  * the Engine on a mesh, 3 fused frames, in each mode it runs there;
  * a checkpoint saved on the mesh and loaded on one device, and the
    reverse;
  * the collective budget of one fused frame, counted by a wrapper around
    every torch.distributed collective.

In this process: the kernels' plain row ranges (collision), cell-row bands
(pixel pass) and per-block winner planes (points) against their whole
launches, and the setup's refusals.
"""

from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
TIMEOUT = 120  # seconds for a whole world of workers
STEPS = 6
FRAMES = 3
# the Engine's modes on a mesh, each at a tiny config (_engine_config);
# selfgravity's sourced defects sum over the ranks (gravity.py), so its
# image is held to the pixel gate and its state bit-equal
ENGINE_MODES = ("retarded", "instant", "points", "worldline3d", "retina", "conical", "btz",
                "selfgravity")
HISTORY = 128  # the budget run's ring: 2T rows a particle column, more than any collective's


# --------------------------------------------------------------------------
# the scene both sides build (numpy and torch only: the workers import no JAX)
# --------------------------------------------------------------------------


def _bodies(apart: bool = False):
    """Two discs of ~50 particles a lattice step apart, closing at 0.6c:
    they touch within the first steps.  `apart`: 0.1 ls apart, no contact
    for many frames (JAX's XLA collision path misses contacts that form
    inside a step, so the JAX comparison runs before any)."""
    gap = 0.1 if apart else 0.0
    return (("disc", 50, (0.45 - gap, 0.45), (0.3, 0.0), (0.2, 0.2, 1.0)),
            ("disc", 50, (0.4805 + gap, 0.45175), (-0.3, 0.0), (1.0, 0.3, 0.25)))


def _config(config, rt, mode="retarded", apart=False, **kw):
    """A tiny EngineConfig: capacity 256, 64x64, small budgets so the
    retina's boundary prefix, pair compaction and rank compaction run."""
    render = rt.RenderParams(num_rays=256, retina_budget=128, pair_budget=512, segments=2)
    base = dict(scene=config.SceneSpec(bodies=_bodies(apart), capacity=256), render=render,
                width=64, height=64, history=32, render_mode=mode)
    base.update(kw)
    return config.EngineConfig(**base)


def _engine_config(config, rt, name):
    """A tiny Engine config of each mode: _config's scene, or the curved
    configs shrunk as chip_smoke's tiny set shrinks them (48x48, discs of
    ~50, 256 rays)."""
    if name in ("retarded", "instant", "points", "worldline3d", "retina"):
        return _config(config, rt, name)
    cfg = config.get_config({"conical": "conical_defect", "btz": "btz_hole"}.get(name, name))
    bodies = (("disc", 50, (0.25, 0.50), (0.0, 0.2), (0.25, 0.35, 1.0)),
              ("disc", 50, (0.75, 0.50), (0.0, -0.2), (1.0, 0.3, 0.25)))
    if name == "selfgravity":
        bodies = (("disc", 50, (0.40, 0.50), (0.2, 0.0), (0.25, 0.35, 1.0)),
                  ("disc", 50, (0.60, 0.50), (-0.2, 0.0), (1.0, 0.3, 0.25)))
    # the conical camera sits ~0.45 ls from the discs: 90 ticks of light delay
    return dataclasses.replace(cfg, scene=config.SceneSpec(bodies=bodies), width=48, height=48,
                               history=64 if name == "btz" else 128,
                               render=dataclasses.replace(cfg.render, num_rays=256))


# --------------------------------------------------------------------------
# the worker
# --------------------------------------------------------------------------


def _worker(out_dir: str) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from spacetime_tpu_torch import engine as engine_mod
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.ops import forces_cuda, materials as materials_ops
    from spacetime_tpu_torch.ops import rasterize as rt_points
    from spacetime_tpu_torch.ops import raytrace as rt
    from spacetime_tpu_torch.ops import worldline as wl
    from spacetime_tpu_torch.parallel import mesh as mesh_mod
    from spacetime_tpu_torch.parallel import multihost, sharding
    from spacetime_tpu_torch.state import with_rest_len
    from spacetime_tpu_torch.utils import config

    assert multihost.initialize(device="cpu")
    mesh = mesh_mod.make_mesh()
    checks = {}

    def same(a, b) -> bool:
        """Bit-equal tensors, or dataclasses of them field by field."""
        if isinstance(a, torch.Tensor):
            return a.shape == b.shape and a.dtype == b.dtype and bool(
                torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                            b.view(torch.int32) if b.dtype == torch.float32 else b))
        return all((getattr(a, f.name) is None and getattr(b, f.name) is None)
                   or same(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))

    def record(name, ok, detail=""):
        checks[name] = {"ok": bool(ok), "detail": str(detail)}

    # -- the sharded step --------------------------------------------------
    cfg = _config(config, rt)
    full, objects = engine_mod.build_scene(cfg.scene, "cpu")
    offsets = engine_mod.forces.derive_spring_offsets(full.neighbors.numpy())
    mats_cfg = ((1.0, 25.0, 1.0, 25.0, 0.10), (1.0, 10.0, 1.0))
    for variant in ("shifted", "rows", "creep"):
        offs = None if variant == "rows" else offsets
        start, mats = full, None
        if variant == "creep":
            start = with_rest_len(full, cfg.physics.rest_lengths())
        padded = sharding.pad_particles(start, mesh.size)
        if variant == "creep":
            mats = materials_ops.particle_materials(
                mats_cfg, objects.material_index, padded.object_index)
            single_mats = materials_ops.particle_materials(
                mats_cfg, objects.material_index, start.object_index)
        else:
            single_mats = None
        for integrator in ("rk4", "euler"):
            model = engine_mod.SoftbodyModel(full.capacity, offs, cfg.physics, device="cpu",
                                             integrator=integrator)
            step = sharding.make_sharded_step(
                engine_mod.SoftbodyModel(padded.capacity, offs, cfg.physics, device="cpu",
                                         integrator=integrator),
                mesh, materials=mats)
            mine, ref = sharding.shard_particles(start, mesh), start
            touched = 0.0
            for _ in range(STEPS):
                mine = step(mine)
                before = ref
                ref, _aux = model.step(ref, single_mats)
                touched += float(forces_cuda.collision_forces_plain(
                    before.pos, before.active, cfg.physics.collision_distance,
                    cfg.physics.collision_repulsion_coefficient).abs().sum())
            got = sharding.gather_particles(mine, mesh, full.capacity)
            record(f"step_{variant}_{integrator}",
                   same(got, ref) and touched > 0, f"contact force sum {touched}")

    # -- the sharded frame --------------------------------------------------
    cam = Camera.create(pos=(0.465, 0.45), zoom=0.12)
    for mode in ("retarded", "instant", "jax"):
        if mode == "jax":  # the scene of the JAX comparison: no contact
            full, objects = engine_mod.build_scene(_config(config, rt, apart=True).scene, "cpu")
            cam = Camera.create(pos=(0.465, 0.45), zoom=0.4)
            offsets = engine_mod.forces.derive_spring_offsets(full.neighbors.numpy())
        model = engine_mod.SoftbodyModel(full.capacity, offsets, cfg.physics, device="cpu")
        padded = sharding.pad_particles(full, mesh.size)
        params = dataclasses.replace(cfg.render, cell_px=8, max_age=0)
        if mode == "instant":
            params = dataclasses.replace(params, opaque=False, retarded=False)
        buf = wl.prefill_inertial(wl.create(cfg.history, full.capacity), full.pos, full.vel,
                                  full.active, 0.0, cfg.physics.h)
        mp, mb = sharding.shard_state(full, buf, mesh)
        fn = sharding.make_sharded_frame(
            engine_mod.SoftbodyModel(padded.capacity, offsets, cfg.physics, device="cpu"),
            objects, params, cfg.width, cfg.height, mesh)
        p1, b1 = full, wl.prefill_inertial(wl.create(cfg.history, full.capacity), full.pos,
                                           full.vel, full.active, 0.0, cfg.physics.h)
        ok, lit = True, True
        for i in range(FRAMES):
            t = torch.tensor(cfg.physics.h * (i + 1), dtype=torch.float32)
            mp, mb, img = fn(mp, mb, cam, t)
            p1, _ = model.step(p1)
            b1 = wl.push_frame(b1, p1, t)
            ref = rt.render_retarded(b1, p1.object_index, objects, cam, cfg.width, cfg.height,
                                     params)
            ok = ok and same(img.contiguous(), ref.contiguous())
            lit = lit and bool((ref.min(-1).values < 0.9).any())
        gp, gb = sharding.gather_state(mp, mb, mesh, full.capacity)
        record(f"frame_{mode}", ok and lit and same(gp, p1) and same(gb, b1),
               f"lit {lit}")
        if mode == "jax" and mesh.rank == 0:
            np.save(os.path.join(out_dir, "port_sharded_frame.npy"), img.numpy())

    # the raw point view: the replicated object index, one MIN all-reduce
    fn = sharding.make_sharded_frame(
        engine_mod.SoftbodyModel(padded.capacity, offsets, cfg.physics, device="cpu"),
        objects, cfg.render, cfg.width, cfg.height, mesh, render_mode="points",
        object_index=sharding.replicated_object_index(mp, mesh))
    mp, mb = sharding.shard_state(full, wl.create(cfg.history, full.capacity), mesh)
    p1 = full
    ok = True
    for i in range(FRAMES):
        mp, mb, img = fn(mp, mb, cam, torch.tensor(cfg.physics.h * (i + 1)))
        p1, _ = model.step(p1)
        ref = rt_points.render_points(p1, objects, cam, cfg.width, cfg.height)
        ok = ok and same(img.contiguous(), ref.contiguous()) and bool((ref != 1.0).any())
    record("frame_points", ok)

    # -- the Engine on a mesh -----------------------------------------------
    for mode in ENGINE_MODES:
        cfg_m = _engine_config(config, rt, mode)
        single = engine_mod.Engine(cfg_m, device="cpu")
        meshed = engine_mod.Engine(cfg_m, mesh=mesh)
        ok, share, lit = True, 0.0, True
        for _ in range(FRAMES):
            a, b = single.run_frame(), meshed.run_frame()
            ok = ok and same(a, b)
            share = max(share, float(((a - b).abs().amax(-1) > 1e-3).float().mean()))
            lit = lit and bool((a.min(-1).values < 0.9).any())
        if mode == "selfgravity":  # the sourced sums: the pixel gate
            ok = share <= 1e-3
        gp, gb = sharding.gather_state(meshed.particles, meshed.worldline, mesh,
                                       single.particles.capacity)
        diag_ok = (single.last_diag is None and meshed.last_diag is None) or all(
            (a is None and b is None) or int(a) == int(b)
            for a, b in zip(single.last_diag, meshed.last_diag))
        eager = FRAMES if mode == "retina" else 0  # retina frames run unfused
        record(f"engine_{mode}", ok and lit and same(gp, single.particles)
               and same(gb, single.worldline) and diag_ok
               and meshed.graph_stats["eager"] == eager,
               f"share {share} lit {lit} diag {single.last_diag} / {meshed.last_diag}")
        if mode == "retarded":
            cams = [Camera.create(pos=(0.46, 0.45), zoom=0.15),
                    Camera.create(pos=(0.47, 0.44), zoom=0.1, vel=(0.2, 0.0))]
            record("views", same(single.render_views(cams), meshed.render_views(cams)))

    # -- checkpoints across the mesh ----------------------------------------
    path = os.path.join(out_dir, f"mesh{mesh.size}.npz")
    a = engine_mod.Engine(_config(config, rt), mesh=mesh)
    for _ in range(2):
        a.run_frame()
    a.save_checkpoint(path)  # every rank calls it; rank 0 writes
    b = engine_mod.Engine(_config(config, rt), device="cpu")
    b.load_checkpoint(path)
    ok = same(a.run_frame(), b.run_frame())
    path2 = os.path.join(out_dir, f"single{mesh.size}_{mesh.rank}.npz")
    b.save_checkpoint(path2)
    c = engine_mod.Engine(_config(config, rt), mesh=mesh)
    c.load_checkpoint(path2)
    ok = ok and same(b.run_frame(), c.run_frame()) and c.frame == b.frame
    record("checkpoint", ok, f"frames {a.frame} {b.frame} {c.frame}")

    # -- the collective budget ----------------------------------------------
    log = []
    names = ("all_gather_into_tensor", "all_gather_single", "reduce_scatter_tensor",
             "reduce_scatter_single", "all_reduce", "all_gather", "all_to_all_single",
             "broadcast", "reduce", "gather", "scatter", "send", "recv", "isend", "irecv",
             "all_gather_object", "broadcast_object_list")
    originals = {n: getattr(dist, n) for n in names if hasattr(dist, n)}

    def counted(name, fn):
        def call(*args, **kwargs):
            ts = [x for x in args if isinstance(x, torch.Tensor)]
            src = ts[-1] if ts else None  # the input is the last tensor argument
            log.append([name, 0 if src is None else src.numel(),
                        0 if src is None else src.numel() * src.element_size()])
            return fn(*args, **kwargs)
        return call

    budget_eng = {}
    for mode in ("retarded", "points", "worldline3d", "conical"):
        eng = engine_mod.Engine(dataclasses.replace(_engine_config(config, rt, mode),
                                                    history=HISTORY), mesh=mesh)
        eng.run_frame()
        for n, fn in originals.items():
            setattr(dist, n, counted(n, fn))
        try:
            log.clear()
            eng.run_frame()
        finally:
            for n, fn in originals.items():
                setattr(dist, n, fn)
        rp = eng._render_params()
        budget_eng[mode] = {"log": list(log), "n_local": eng.particles.capacity,
                            "ring_cols": eng.worldline.pos_x.shape[0],
                            "steps": eng.config.steps_per_frame, "band": rp.band,
                            "segments": rp.segments, "cell_px": rp.cell_px}
    record("collectives", True, json.dumps(budget_eng))

    multihost.sync(mesh)
    multihost.shutdown()
    checks["_jax_imported"] = {"ok": "jax" not in sys.modules, "detail": ""}
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump({"checks": checks, "budget": budget_eng}, f)


if __name__ == "__main__":
    _worker(sys.argv[1])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from spacetime_tpu_torch import engine as engine_mod  # noqa: E402
from spacetime_tpu_torch.camera import Camera  # noqa: E402
from spacetime_tpu_torch.ops import forces_cuda, grid, points_cuda, raytrace as rt  # noqa: E402
from spacetime_tpu_torch.ops import render_cuda  # noqa: E402
from spacetime_tpu_torch.ops import worldline as wl  # noqa: E402
from spacetime_tpu_torch.parallel import mesh as mesh_mod, multihost, sharding  # noqa: E402
from spacetime_tpu_torch.utils import config  # noqa: E402

# the single-device port-vs-JAX frame tolerance (tests/test_torch_slice.py):
# at most 0.1% of the pixels may differ by more than 1e-3 (capsule edges
# where XLA and torch round the f32 maths apart)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(world: int, out_dir: str):
    """Start `world` workers with torchrun's variables on a free port."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        env_r = dict(env, RANK=str(r), LOCAL_RANK=str(r))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), out_dir],
                                      env=env_r, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT))
    return procs


@pytest.fixture(scope="module")
def worlds():
    """{world size: (per-rank results, out dir, seconds)}: both worlds
    spawned at once, each under one hard deadline."""
    dirs = {w: tempfile.mkdtemp(prefix=f"mesh{w}_") for w in WORLDS}
    t0 = time.monotonic()
    procs = {w: _spawn(w, dirs[w]) for w in WORLDS}
    logs = {w: [] for w in WORLDS}
    try:
        for w in WORLDS:
            for p in procs[w]:
                left = max(1.0, TIMEOUT - (time.monotonic() - t0))
                out, _ = p.communicate(timeout=left)
                logs[w].append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for w in WORLDS:
            for p in procs[w]:
                p.kill()
                p.communicate()
        pytest.fail(f"mesh workers passed the {TIMEOUT} s deadline (a hung rendezvous or "
                    "collective)")
    out = {}
    for w in WORLDS:
        results = []
        for r, p in enumerate(procs[w]):
            path = os.path.join(dirs[w], f"rank{r}.json")
            assert p.returncode == 0 and os.path.exists(path), (
                f"world {w} rank {r} rc={p.returncode}\n{logs[w][r][-4000:]}")
            with open(path) as f:
                results.append(json.load(f))
        out[w] = (results, dirs[w], time.monotonic() - t0)
    return out


def _check(worlds, world, name):
    for rank, res in enumerate(worlds[world][0]):
        c = res["checks"][name]
        assert c["ok"], f"world {world} rank {rank} {name}: {c['detail']}"


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("variant", ["shifted_rk4", "shifted_euler", "rows_rk4",
                                     "rows_euler", "creep_rk4", "creep_euler"])
def test_sharded_step_bit_equal_to_single_device(worlds, world, variant):
    """make_sharded_step over 6 steps through the discs' impact: the
    collision kernel's plain version over each rank's sorted rows, the
    force reduce-scatter, springs on the block's rows."""
    _check(worlds, world, f"step_{variant}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["retarded", "instant", "points"])
def test_sharded_frame_bit_equal_to_single_device(worlds, world, mode):
    _check(worlds, world, f"frame_{mode}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ENGINE_MODES)
def test_engine_on_a_mesh_bit_equal_to_single_device(worlds, world, mode):
    """Engine(config, mesh=...) for 3 frames (fused; the retina mode's
    eager): every image, the gathered state and the diagnostics bit-equal
    to one device's; selfgravity's images within the pixel gate (its
    sourced centroids sum over the ranks in another order)."""
    _check(worlds, world, f"engine_{mode}")


@pytest.mark.parametrize("world", WORLDS)
def test_render_views_on_a_mesh_bit_equal_to_single_device(worlds, world):
    _check(worlds, world, "views")


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_crosses_between_mesh_and_single_device(worlds, world):
    _check(worlds, world, "checkpoint")


@pytest.mark.parametrize("world", WORLDS)
def test_workers_import_no_jax(worlds, world):
    _check(worlds, world, "_jax_imported")


KINDS = {"all_gather_into_tensor": "gather", "all_gather_single": "gather",
         "reduce_scatter_tensor": "scatter", "reduce_scatter_single": "scatter",
         "all_reduce": "reduce"}


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_of_a_frame_within_budget(worlds, world):
    """One fused frame's collectives, counted around every torch.distributed
    collective, are exactly the budget: per step one all-gather per RK4
    stage (positions, velocities and active flags at the first, 5 N_local
    f32; positions after, 2 N_local), one force reduce-scatter per stage
    (2 N f32) and one counter all-reduce (3); per render one pair gather
    (12 f32 per pair row: 10 fields, validity, boundary) with one
    band-counter all-reduce and one image gather (a band of whole cell
    rows) when retarded; one pair gather (11 f32 a row) and one counter
    all-reduce per route when conical (2 routes, the rest replicated); one
    MIN all-reduce of the winner plane (points) or of the depth range and
    the plane (worldline3d).  None carries a ring plane: each moves fewer
    than 2T x N_local elements."""
    for res in worlds[world][0]:
        for mode, b in res["budget"].items():
            n_loc, steps, k = b["n_local"], b["steps"], b["cell_px"]
            n = n_loc * world
            assert b["ring_cols"] == 2 * HISTORY
            ring_plane = b["ring_cols"] * n_loc
            got = sorted((KINDS.get(name, name), numel) for name, numel, _ in b["log"])
            want = []
            for _ in range(steps):
                want += [("gather", 5 * n_loc)] + [("gather", 2 * n_loc)] * 3
                want += [("scatter", 2 * n)] * 4 + [("reduce", 3)]
            hc = -(-64 // k)
            image = ("gather", 3 * (-(-hc // world)) * k * 64)
            k_rows = b["segments"] if 0 < b["segments"] < b["band"] else b["band"]
            if mode == "retarded":
                want += [("gather", n_loc * k_rows * 12), ("reduce", 2), image]
            elif mode == "conical":
                counters = 2 if k_rows < b["band"] else 1
                want += [("gather", n_loc * k_rows * 11), ("reduce", counters)] * 2
            elif mode == "points":
                want += [("reduce", 64 * 64)]
            else:
                want += [("reduce", 2), ("reduce", 64 * 64)]
            assert got == sorted(want), (mode, got, sorted(want))
            assert all(numel < ring_plane for _, numel in got), (mode, ring_plane)


def test_sharded_frame_matches_jax_make_sharded_frame(worlds):
    """The port's sharded retarded frame (2 gloo ranks) against JAX's
    make_sharded_frame(..., production_kernels=False) on a 4-device CPU
    mesh (conftest's virtual devices), both after 3 frames of the same
    scene (its discs apart: see _bodies), at the tolerance stated
    above."""
    import jax
    import jax.numpy as jnp

    from spacetime_tpu.camera import Camera as JCamera
    from spacetime_tpu.engine import build_scene as jbuild
    from spacetime_tpu.models.softbody import SoftbodyModel as JModel
    from spacetime_tpu.ops import raytrace as jrt
    from spacetime_tpu.ops import worldline as jwl
    from spacetime_tpu.parallel import mesh as jmesh
    from spacetime_tpu.parallel import sharding as jsharding
    from spacetime_tpu.utils import config as jconfig

    port = np.load(os.path.join(worlds[2][1], "port_sharded_frame.npy"))
    from spacetime_tpu.ops import forces as jforces

    cfg = _config(jconfig, jrt, apart=True)
    particles, objects = jbuild(cfg.scene)
    model = JModel(capacity=particles.capacity, params=cfg.physics,
                   spring_offsets=jforces.derive_spring_offsets(np.asarray(particles.neighbors)))
    buf = jwl.prefill_inertial(jwl.create(cfg.history, particles.capacity), particles.pos,
                               particles.vel, particles.active, jnp.float32(0.0),
                               jnp.float32(cfg.physics.h))
    params = dataclasses.replace(cfg.render, cell_px=8, max_age=0)
    m = jmesh.make_mesh(4)
    p, b = jsharding.shard_state(particles, buf, m)
    fn = jsharding.make_sharded_frame(model, objects, params, cfg.width, cfg.height, m,
                                      production_kernels=False)
    cam = JCamera(pos=jnp.asarray([0.465, 0.45], jnp.float32), zoom=jnp.float32(0.4),
                  vel=jnp.zeros(2, jnp.float32))
    for i in range(FRAMES):
        p, b, img = fn(p, b, cam, jnp.float32(cfg.physics.h * (i + 1)))
    ref = np.asarray(jax.device_get(img))
    assert port.shape == ref.shape == (64, 64, 3)
    assert (ref.min(-1) < 0.9).any()
    mismatch = np.mean(np.abs(port - ref).max(axis=-1) > PIXEL_TOL)
    assert mismatch <= PIXEL_SHARE, f"{mismatch:.3%} pixels differ"


# --------------------------------------------------------------------------
# in this process: the kernels' plain shares against their whole launches
# --------------------------------------------------------------------------


def _contact_state():
    cfg = _config(config, rt)
    p, _ = engine_mod.build_scene(cfg.scene, "cpu")
    model = engine_mod.SoftbodyModel(p.capacity, None, cfg.physics, device="cpu")
    for _ in range(3):
        p, _ = model.step(p)
    return p, cfg.physics, model


@pytest.mark.parametrize("parts", [2, 4])
@pytest.mark.parametrize("exclude", [False, True], ids=["include", "exclude"])
def test_collision_row_ranges_sum_to_the_whole(parts, exclude):
    p, phys, model = _contact_state()
    bdim = max(1, int(round(model.grid_dim * phys.grid_resolution / model.bin_resolution)))
    cell, origin = grid.cell_ids(p.pos, p.active, model.bin_resolution, bdim)
    order = forces_cuda.build_cell_order(cell, origin, (bdim + 2) ** 2, bdim + 2,
                                         model.bin_resolution)
    nbr = p.neighbors.contiguous() if exclude else None
    disp = torch.zeros(2)
    args = (p.pos, p.active, order, phys.collision_distance,
            phys.collision_repulsion_coefficient, disp)
    whole = forces_cuda.collision_forces(*args, neighbors=nbr)
    assert whole.abs().sum() > 0
    n = p.capacity
    per = -(-n // parts)
    shares = [forces_cuda.collision_forces(*args, neighbors=nbr,
                                           rows=(r * per, max(0, min(per, n - r * per))))
              for r in range(parts)]
    assert torch.equal(sum(shares), whole)
    for r, s in enumerate(shares):  # each share touches its rows' particles only
        mine = torch.zeros(n, dtype=torch.bool)
        mine[order.sorted_idx[r * per:(r + 1) * per].long()] = True
        assert not s[~mine].any()


@pytest.mark.parametrize("bands", [2, 4])
@pytest.mark.parametrize("camera_frame", [False, True], ids=["ground", "camera_frame"])
def test_pixel_bands_assemble_the_whole_image(bands, camera_frame):
    cfg = _config(config, rt, width=72, height=60)
    eng = engine_mod.Engine(cfg, device="cpu")
    for _ in range(3):
        eng.run_frame()
    params = dataclasses.replace(eng._render_params(), camera_frame=camera_frame)
    cam = Camera.create(pos=(0.465, 0.45), zoom=0.12, vel=(0.3, 0.1) if camera_frame else
                        (0.0, 0.0))
    inputs, _ = rt.prepare_pixel_pass(eng.worldline, eng.particles.object_index, eng.objects,
                                      cam, cfg.width, cfg.height, params,
                                      wl.boundary_mask(eng.particles))
    whole = render_cuda.pixel_pass(inputs, params, width=cfg.width, height=cfg.height)
    k, hc = params.cell_px, inputs.hc_img
    per = -(-hc // bands)
    parts = []
    for r in range(bands):
        row0 = min(r * per, hc)
        band = render_cuda.pixel_pass(inputs, params, width=cfg.width, height=cfg.height,
                                      rows=(row0, min(per, hc - row0), per * k))
        assert band.shape == (3, per * k, cfg.width)
        parts.append(band)
    assert torch.equal(torch.cat(parts, dim=1)[:, :cfg.height], whole)
    assert (whole.min(0).values < 0.9).any()


@pytest.mark.parametrize("blocks", [2, 4])
def test_points_winner_planes_min_reduce_to_the_whole(blocks):
    p, _, _ = _contact_state()
    objects = engine_mod.build_scene(_config(config, rt).scene, "cpu")[1]
    cam = Camera.create(pos=(0.465, 0.45), zoom=0.08)
    whole = points_cuda.render_points(p, objects, cam, 64, 48)
    b = p.capacity // blocks
    planes = [points_cuda.points_winners(
        dataclasses.replace(p, pos=p.pos[r * b:(r + 1) * b], active=p.active[r * b:(r + 1) * b]),
        cam, 64, 48, r * b) for r in range(blocks)]
    merged = torch.stack(planes).amin(0)
    img = points_cuda.points_resolve(merged, p.object_index, objects, 64, 48)
    assert torch.equal(img, whole) and (whole != 1.0).any()


def test_make_mesh_raises_without_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        mesh_mod.make_mesh()


def test_initialize_does_nothing_without_torchruns_environment(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize(device="cpu") is False
    assert not torch.distributed.is_initialized() and not multihost.is_multiprocess()
    assert mesh_mod.pad_to_multiple(256, 3) == 258 and mesh_mod.pad_to_multiple(256, 4) == 256


def test_production_kernels_false_raises_on_a_cuda_mesh():
    """The port's only path on the card is its kernels: the raw API refuses
    JAX's `production_kernels=False` there rather than run something else.
    The check reads only the Mesh's device, so a Mesh value stands in."""
    cuda_mesh = mesh_mod.Mesh(group=None, rank=0, size=1, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="production_kernels=False"):
        sharding.make_sharded_step(None, cuda_mesh, production_kernels=False)
    with pytest.raises(ValueError, match="production_kernels=False"):
        sharding.make_sharded_frame(None, None, None, 8, 8, cuda_mesh, production_kernels=False)
