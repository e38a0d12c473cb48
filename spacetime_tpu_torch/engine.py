"""Engine: the frame loop tying physics, worldlines and rendering together.

Counterpart of `spacetime_tpu/engine.py` for one device.  Per frame it
(1) moves the camera, (2) steps physics and pushes each new tick into the
worldline ring, (3) renders in the config's mode — `retarded`, `instant`,
`points`, `retina` (the observer's 360-degree strip, (max(16, H // 8),
num_rays, 3)), `conical` (geodesic routes around conical defects,
ops/curved.py; the defects from `config.defect` and the matter-sourced
`config.defect_source`, ops/gravity.py), `btz` (null geodesics around the
BTZ black hole of `config.btz`, ops/btz.py) or `worldline3d` (the ring as
an (x, y, t) block, ops/worldline3d.py) — and (4) records stage times and
consumes the diagnostics.  `render_views` renders several cameras from the
current ring (retarded and instant modes).

The normal frame is the fused frame (fused.py), as in the JAX package:
`_can_fuse` takes it unless the Engine is paused, `config.stage_timing` is
set, the mode is `retina` (unfused in JAX too) or an aloof body's
trajectory cannot be captured, and `_fused_frame_fn` keeps one per
render-params key (at most `_FUSED_CACHE_MAX`, evicted first in, first
out).  On a CUDA device its
stages are captured as CUDA graphs at the key's first frame and replayed
at every later one (`graph_stats` counts captures and replays); on the CPU
the same closures run uncaptured.  Its stats carry the frame time and zero
stage times, as the JAX fused frame's do, until `profile_stages` fills in
per-stage device times.  With `stage_timing` (or while paused) the frame
runs eagerly, with CUDA-event stage times read one frame late, and pushes
the host clock (f32 of `time` after each tick's `+= h`), as the JAX eager
path does.  Either way the device work of frame i is queued while the host
moves on, and the one per-frame sync is the wait on frame i-1's end (as
the JAX fused path blocks on the previous image), so `frame_time` is the
pipelined frame time.  Every frame adds its drop counters (fused.
DROP_FIELDS) into a device sum, which `run`'s summary reports as `drops`.

Differences by design:
  * The state lives in fixed tensors that every frame updates in place
    (fused.FrameState): assigning `particles` or `worldline`, loading a
    checkpoint or setting `camera` copies into them, so the next replay
    reads what was set.  Particles passed in are copied, not shared.
  * Camera kinematics run on the host in f32 (np.float32, the JAX
    package's rounding).  Once a frame, the camera and the frame clock
    (`time` in f32, JAX's `t_prev`) go to the device in one non-blocking
    copy, from one of two pinned slots used in turn.
  * The checkpoint keeps every adaptation field, `_seg_boost` included
    (the JAX package's `_ADAPT_FIELDS` leaves it out).
  * The collision and point kernels have no window cap, so the JAX
    package's `wmax` adaptation has no counterpart.
  * The Engine runs on cuda:0 unless `device` names another (`"cpu"` for
    the plain-torch path); without CUDA the default raises.
  * Reserving aloof slots moves the active particles to the front and
    renumbers their bonds with them; the JAX Engine keeps the old numbers,
    which garble a lattice-padded scene's bonds.  A lattice scene so
    repacked loses its shifted spring offsets and takes the row-gather
    physics.

Materials (`config.materials`, with plastic creep), the camera-frame
(boosted) view, scenes without spring offsets (the row-gather physics,
e.g. `SceneSpec(lattice_pad=False)` bodies with irregular rows) and aloof
bodies (models/aloofbody.py: slots reserved after the softbody particles,
render-present and physics-inactive, written after each step and before
each push at the tick's time), conical defects (static, moving, retarded
and matter-sourced), the BTZ hole (slow-rotation or exact spin, reflected
and winding routes) and the worldline3d view run as in the JAX package.
So do the live settings `hotswap` (max_fps, read by `run(realtime=True)`
and changed by `viewer.apply_key`), the `recorder` (utils/replay.py), which
logs each frame's inputs before they apply, `run`'s `key_source` (key
events through `viewer.apply_key`; `quit` ends the loop) and `save_png`
(utils/png.py's writer, no pillow).

On a mesh (`Engine(config, mesh=parallel.mesh.make_mesh())`, one process a
rank; the JAX Engine's `mesh=`) the state takes the JAX layout
(parallel/sharding.py): `particles` and `worldline` are this rank's block
of the particle axis (the scene built whole on every rank, padded to a
multiple of the world size, then cut: `_shard_state`), the camera, the
clock and the ring's cursor replicated.  The frame is the same fused frame
with the collectives inside its stages (captured into its CUDA graphs on
NCCL); every rank gets the whole image and the same diagnostics, so every
rank adapts its budgets alike.  A checkpoint holds the whole unpadded
state (rank 0 writes it) and loads on a mesh or on one device alike.  Every
mode and `render_views` run on a mesh; aloof bodies raise
NotImplementedError there.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import device as device_mod
from . import fused
from . import scene as scene_mod
from .camera import Camera, CameraController, stack_cameras
from .models import aloofbody
from .models.softbody import SoftbodyModel
from .ops import btz, curved, forces, gravity, materials as materials_ops, raytrace
from .ops import worldline as wl
from .ops.points_cuda import PointsDiag
from .ops.rk4 import StepAux
from .parallel import multihost, sharding
from .state import Objects, Particles, pack_particles, with_rest_len
from .utils import logging as logmod
from .utils.config import EngineConfig, SceneSpec
from .utils.stats import FramePerfStats, StageClock, StatsWindow

MODES = ("retarded", "instant", "points", "retina", "conical", "btz", "worldline3d")
# retina frames run eagerly, as in JAX
FUSED_MODES = ("retarded", "instant", "points", "conical", "btz", "worldline3d")


def build_scene(spec: SceneSpec, device=None):
    """(particles, objects) on `device` (None: cuda:0, raising without CUDA)
    for a SceneSpec."""
    device = device_mod.resolve(device)
    sb = scene_mod.SceneBuilder()
    pad = spec.lattice_pad
    mat_idx = spec.material_indices or (0,) * len(spec.bodies)
    for i, (kind, arg, offset, vel, rgb) in enumerate(spec.bodies):
        if kind == "disc":
            body = scene_mod.disc_softbody(scene_mod.radius_for_count(arg), i, offset, vel,
                                           lattice_pad=pad)
        elif kind == "box":
            body = scene_mod.mask_to_softbody(scene_mod.box_mask(arg[0], arg[1]), i, offset,
                                              vel, lattice_pad=pad)
        elif kind == "image":
            body = scene_mod.image_to_softbody(arg, i, offset, vel, lattice_pad=pad)
        else:
            raise ValueError(f"unknown body kind {kind!r}")
        if i >= len(mat_idx):
            raise ValueError(
                f"scene.material_indices has {len(mat_idx)} entries for "
                f"{len(spec.bodies)} bodies — provide one per body")
        sb.add(body, base_color=rgb, material_index=mat_idx[i])
    return sb.build(spec.capacity, device=device)


def conical_defects(cfg: EngineConfig, device, t, cam, particles, buf, max_age: int = 0,
                    mesh=None):
    """The ConicalDefect tuple of `cfg` on `device`: cfg.defect, a single
    ((cx, cy), deficit) spec or a tuple of them, moved by cfg.defect_vel to
    time `t`, then the matter-sourced cfg.defect_source entries
    (ops/gravity.py) of `particles` and `buf`.  With cfg.defect_retarded
    each moving defect sits where the camera's past light cone meets its
    linear track c0 + v t_r: the t_r <= t root of |c(t_r) - cam| = t - t_r;
    sourced ones sit at their retarded centroid.  With tensors `t` and
    `cam` no value is read back to the host.  On a `mesh` the state is this
    rank's share (the sourced centroids' sums all-reduced)."""
    sourced = ()
    if cfg.defect_source:
        sourced = gravity.source_defects(cfg.defect_source, particles, buf, cam,
                                         cfg.physics.h, cfg.defect_G, cfg.defect_retarded,
                                         max_age=max_age, mesh=mesh)
    if cfg.defect is None:
        return sourced
    spec = cfg.defect
    # one spec ((cx, cy), deficit) has a number at spec[0][0]; a tuple a tuple
    specs = tuple(spec) if isinstance(spec[0][0], (tuple, list)) else (spec,)
    vels = cfg.defect_vel or ((0.0, 0.0),) * len(specs)
    if len(vels) != len(specs):
        raise ValueError(f"defect_vel has {len(vels)} entries for {len(specs)} defects — "
                         "provide one (vx, vy) per defect")
    out = []
    for ((cx, cy), deficit), (vx, vy) in zip(specs, vels):
        if vx * vx + vy * vy >= 1.0:
            # the retarded-time quadratic divides by v^2 - 1 and its root
            # choice assumes |v| < c
            raise ValueError(f"defect velocity ({vx}, {vy}) is not below c")
        if cfg.defect_retarded and (vx != 0.0 or vy != 0.0):
            qx = cx - cam.pos[0]
            qy = cy - cam.pos[1]
            a = vx * vx + vy * vy - 1.0
            b = 2.0 * (qx * vx + qy * vy + t)
            c_ = qx * qx + qy * qy - t * t
            # a < 0: the t_r <= t root is (-b + sqrt(D)) / 2a
            disc = torch.sqrt(torch.clamp(b * b - 4.0 * a * c_, min=0.0))
            t_r = (-b + disc) / (2.0 * a)
            center = (cx + vx * t_r, cy + vy * t_r)
        else:
            center = (cx + vx * t, cy + vy * t)
        out.append(curved.ConicalDefect.create(center, deficit, device=device))
    return tuple(out) + sourced


def _refuse_unported(config: EngineConfig, mesh, aloof_bodies=()) -> None:
    on_mesh = mesh is not None
    missing = [
        (config.render_mode not in MODES, f"render_mode {config.render_mode!r}"),
        (on_mesh and bool(aloof_bodies), "aloof bodies on a device mesh"),
    ]
    for absent, what in missing:
        if absent:
            raise NotImplementedError(f"{what} is not ported to spacetime_tpu_torch yet")


class Engine:
    """Owns the state on one device (or this rank's share of it on a
    `mesh`) and drives the frame loop.  `device` None means cuda:0 and
    raises without CUDA; pass "cpu" for the CPU.  With `mesh` the device is
    the mesh's, and `particles` (if given) is the whole scene."""

    def __init__(self, config: EngineConfig, particles: Optional[Particles] = None,
                 objects: Optional[Objects] = None, device=None, aloof_bodies=(),
                 mesh=None):
        _refuse_unported(config, mesh, aloof_bodies)
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = device_mod.resolve(device)
        self.mesh = mesh
        self.log = logmod.initialize()
        self.config = config
        if particles is None:
            particles, objects = build_scene(config.scene, self.device)
        self.aloof_bodies = tuple(aloof_bodies)
        self.present = None  # render-present mask when aloof slots exist
        self._aloof = None  # their injection (aloofbody.Injection)
        if self.aloof_bodies:
            particles = self._reserve_aloof_slots(particles)
        self._n_full = particles.capacity  # the capacity, before any mesh padding
        particles = fused.owned(particles.to(self.device))  # updated in place
        self.objects = objects.to(self.device)
        self._object_index = None  # the replicated global object index (mesh points view)
        if mesh is not None:
            # the global scene padded to the world size; the physics reads
            # global offsets and material planes, the state is cut below
            particles = sharding.pad_particles(particles, mesh.size)
            self._object_index = particles.object_index
        # None for an irregular bond graph: the row-gather physics
        offsets = forces.derive_spring_offsets(particles.neighbors.cpu().numpy())
        self.model = SoftbodyModel(particles.capacity, offsets, config.physics,
                                   device=self.device, mesh=mesh)
        # per-particle material planes (None when everything is default)
        self.materials = None
        if config.materials is not None:
            self.materials = materials_ops.particle_materials(
                config.materials, self.objects.material_index, particles.object_index)
        if (self.materials is not None and self.materials.creep_rate is not None
                and particles.rest_len is None):
            # plastic creep needs the per-bond rest-length state; an evolved
            # one passed in (or loaded from a checkpoint) is kept as it is
            particles = with_rest_len(particles, config.physics.rest_lengths())
        if mesh is not None:
            particles = sharding.shard_particles(particles, mesh)
        self.controller = CameraController()
        self.time = 0.0
        self.frame = 0
        self.paused = False
        # live-tweakable runtime settings (the reference's HotswapConfig),
        # changed at run time without touching the frozen config
        self.hotswap = {"max_fps": float(config.max_fps)}
        self.recorder = None  # a utils.replay.ReplayRecorder logging each frame's inputs
        self._stats = StatsWindow()
        self._pending = None  # (StageClock or None, frame seconds) not yet in _stats
        self._prev_end = None  # CUDA event at the end of the previous frame
        self._profile_clocks = None  # StageClocks of the frames profile_stages runs
        self._drops = torch.zeros(len(fused.DROP_FIELDS), dtype=torch.int64, device=self.device)
        self.last_aux = None
        self.last_diag = None
        self._band_boost = 0  # diagnostics-driven adaptation (see _check_diag)
        self._cap_boost = 0
        self._pair_boost = 0  # pair_budget doublings
        self._retina_boost = 0  # retina_budget doublings
        self._entry_boost = 0  # entry_budget doublings
        self._seg_boost = 0  # segments widenings
        # fused frames by render-params key; their CUDA graphs' stream and
        # memory pool (made at the first capture); captures and replays
        self._fused_cache: Dict[tuple, tuple] = {}
        self._graph_stream = None
        self._graph_pool = None
        self.graph_stats = fused.new_stats()
        # the FULL history primed with inertially extrapolated past states,
        # so retarded visibility does not ramp in over `history` frames
        present = particles.active
        if self._aloof is not None:
            self._aloof(particles, torch.zeros((), device=self.device), self.time)
            self._aloof.check_speed(particles)
            present = self.present
        buf = wl.create(config.history, particles.capacity, device=self.device)
        buf = wl.prefill_inertial(buf, particles.pos, particles.vel, present,
                                  self.time, config.physics.h)
        self._state = fused.FrameState(
            particles, buf, torch.zeros(6, dtype=torch.float32, device=self.device),
            torch.zeros(3, dtype=torch.int64, device=self.device))
        # host camera state (f32), uploaded with the clock once a frame from
        # one of two pinned slots used in turn (a slot is rewritten only once
        # its last copy has run)
        self._cam_pos = np.asarray(config.cam_pos, np.float32)
        self._cam_zoom = np.float32(config.cam_zoom)
        self._cam_vel = np.asarray(config.cam_vel, np.float32)
        cuda = self.device.type == "cuda"
        self._staging = torch.empty((2, 6), dtype=torch.float32, pin_memory=cuda)
        self._staged = [torch.cuda.Event() for _ in range(2)] if cuda else None
        self._slot = 0
        self._upload()
        self.log.debug("engine created on %s: %d particles, history %d, %dx%d %s",
                       self.device, int(particles.active.sum()), config.history,
                       config.width, config.height, config.render_mode)

    # -- state --------------------------------------------------------------

    @property
    def particles(self) -> Particles:
        """The particles' tensors that the next frame reads."""
        return self._state.particles

    @particles.setter
    def particles(self, particles: Particles) -> None:
        self._adopt("particles", particles)

    @property
    def worldline(self) -> wl.WorldlineBuffer:
        """The worldline ring that the next frame reads."""
        return self._state.buf

    @worldline.setter
    def worldline(self, buf: wl.WorldlineBuffer) -> None:
        self._adopt("buf", buf)

    def _adopt(self, field: str, value) -> None:
        """Copy `value` into the state's tensors of `field`; one of another
        layout replaces them, and every fused frame (which holds the old
        tensors) is dropped."""
        held = getattr(self._state, field)
        value = value.to(self.device)
        if fused.same_layout(held, value):
            fused.commit(held, value)
        else:
            if field == "particles":
                value = fused.owned(value)
            self._state = self._state._replace(**{field: value})
            self._fused_cache.clear()

    # -- aloof bodies ---------------------------------------------------------

    def _reserve_aloof_slots(self, particles: Particles) -> Particles:
        """The softbody particles repacked with one physics-inactive slot per
        aloof point after them (capacity grown to a multiple of 256 if
        needed), each body's slots carrying its object index; sets
        `present` (softbody and aloof slots) and the injection.  The active
        particles move to the front, and their bonds are renumbered with
        them (the JAX Engine keeps the old numbers, which point at other
        particles wherever a lattice-padded scene had padding between
        them)."""
        bodies = self.aloof_bodies
        act = particles.active.cpu().numpy()
        n_soft = int(act.sum())
        total = sum(b.num_points for b in bodies)
        cap = particles.capacity
        if n_soft + total > cap:
            cap = ((n_soft + total + 255) // 256) * 256
        host = lambda x: x.cpu().numpy()[act]
        renumber = np.full(act.shape[0], -1, np.int32)
        renumber[act] = np.arange(n_soft, dtype=np.int32)
        nbr = host(particles.neighbors)
        nbr = np.where(nbr >= 0, renumber[np.clip(nbr, 0, None)], -1).astype(np.int32)
        a_obj = np.concatenate([np.full(b.num_points, b.object_index, np.int32)
                                for b in bodies])
        new = pack_particles(
            np.concatenate([host(particles.pos), np.full((total, 2), 1e9, np.float32)]),
            np.concatenate([host(particles.vel), np.zeros((total, 2), np.float32)]),
            np.concatenate([nbr, np.full((total, 8), -1, np.int32)]),
            np.concatenate([host(particles.object_index), a_obj]),
            capacity=cap, device=self.device)
        if particles.rest_len is not None:
            # the evolved creep state goes along (aloof and padding rows are
            # bondless, their values unread)
            rl = np.zeros((cap, 8), np.float32)
            rl[:n_soft] = host(particles.rest_len)
            new = dataclasses.replace(new, rest_len=torch.from_numpy(rl).to(self.device))
        active = np.zeros(cap, bool)
        active[:n_soft] = True
        present = active.copy()
        present[n_soft:n_soft + total] = True
        self.present = torch.from_numpy(present).to(self.device)
        self._aloof = aloofbody.Injection(bodies, n_soft, n_soft + total)
        if not self._aloof.capturable:
            self.log.warning("an aloof body's trajectory cannot be captured (it reads its "
                             "time on the host): every frame runs eagerly")
        return dataclasses.replace(new, active=torch.from_numpy(active).to(self.device))

    @property
    def _aloof_slice(self):
        """(lo, hi): the aloof slots, or None."""
        return None if self._aloof is None else (self._aloof.lo, self._aloof.hi)

    # -- camera -------------------------------------------------------------

    @property
    def camera(self) -> Camera:
        """The device camera: views of the frame input the next frame reads."""
        return fused.camera_of(self._state.frame_in)

    @camera.setter
    def camera(self, cam: Camera) -> None:
        self._cam_pos = cam.pos.detach().cpu().numpy().astype(np.float32)
        self._cam_zoom = np.float32(cam.zoom.item())
        self._cam_vel = cam.vel.detach().cpu().numpy().astype(np.float32)
        self._upload()

    def _upload(self) -> None:
        """The host camera and the clock (f32) into the device frame input:
        one non-blocking copy from a pinned slot on CUDA (a pageable copy
        would sync)."""
        host = self._staging[self._slot]
        if self._staged is not None:
            self._staged[self._slot].synchronize()  # this slot's last copy has run
        host.numpy()[:] = np.concatenate(
            [self._cam_pos, [self._cam_zoom], self._cam_vel, [np.float32(self.time)]])
        self._state.frame_in.copy_(host, non_blocking=self._staged is not None)
        if self._staged is not None:
            self._staged[self._slot].record()
        self._slot ^= 1

    def _move_camera(self, dt: float) -> None:
        """Relativistic camera motion on the host: inertial, or under the
        config's proper acceleration with the velocity clamped below c (f32,
        as JAX)."""
        ax, ay = self.config.cam_accel
        dt32 = np.float32(dt)
        if ax == 0.0 and ay == 0.0:
            if self._cam_vel.any():
                self._cam_pos = self._cam_pos + self._cam_vel * dt32
            return
        one = np.float32(1.0)
        v = self._cam_vel
        g = one / np.sqrt(np.maximum(one - np.sum(v * v), np.float32(1e-9)))
        # dv/dt = a / gamma^3 for rectilinear proper acceleration
        new_v = v + np.asarray([ax, ay], np.float32) * dt32 / (g * g * g)
        speed = np.float32(np.linalg.norm(new_v))
        if speed >= np.float32(0.999):
            new_v = new_v / speed * np.float32(0.999)
        self._cam_vel = new_v.astype(np.float32)
        self._cam_pos = self._cam_pos + self._cam_vel * dt32

    def update_camera_kinematics(self, dt: float) -> None:
        """Move the camera by `dt` (see _move_camera) and upload it."""
        self._move_camera(dt)
        self._upload()

    # -- frame --------------------------------------------------------------

    def _stages(self, rparams, tick_time=None):
        """The frame's stage closures (fused.frame_stages) at `rparams`."""
        cfg = self.config
        defects = hole = None
        if cfg.render_mode == "conical":
            if cfg.defect is None and cfg.defect_source is None:
                raise ValueError("render_mode='conical' requires config.defect or "
                                 "config.defect_source")
            # bound to the config, not to the Engine: the fused frame that
            # keeps this function lives in the Engine's own cache, and a
            # reference back to the Engine would hold its device memory
            # (ring, graph pools) past its last use, until a cycle collection
            defects = functools.partial(conical_defects, cfg, self.device, mesh=self.mesh)
        if cfg.render_mode == "btz":
            if cfg.btz is None:
                raise ValueError("render_mode='btz' requires config.btz")
            hole = self._btz_hole()
        return fused.frame_stages(self.model, self.materials, self._state, self.objects,
                                  cfg.width, cfg.height, rparams, cfg.render_mode,
                                  cfg.physics.h, tick_time, aloof=self._aloof,
                                  present=self.present, defects=defects, wl3d=cfg.wl3d,
                                  hole=hole, mesh=self.mesh, object_index=self._object_index)

    def _btz_hole(self) -> btz.BTZBlackHole:
        """The BTZBlackHole of config.btz, ((cx, cy), mass, ads_l[, spin]),
        as device tensors."""
        (center, mass, ads_l), spin = self.config.btz[:3], self.config.btz[3:]
        return btz.BTZBlackHole.create(center, mass, ads_l, spin[0] if spin else 0.0,
                                       device=self.device)

    def _defects(self, t=None, cam=None, particles=None, buf=None, max_age: int = 0):
        """conical_defects of the config at time `t` (default: the host
        clock `time`; the render stage passes the device clock), the camera
        `cam` and the state (default: the Engine's own)."""
        return conical_defects(self.config, self.device, self.time if t is None else t,
                               self.camera if cam is None else cam,
                               self.particles if particles is None else particles,
                               self.worldline if buf is None else buf, max_age, self.mesh)

    def _tick(self) -> float:
        """An eager tick's host clock: `time` advanced by h (the JAX eager
        path's `self.time += h`)."""
        self.time += self.config.physics.h
        return self.time

    def step_physics(self) -> None:
        """`steps_per_frame` physics ticks, each pushed into the ring, with
        no render and no camera motion, even while paused (the JAX Engine's
        step_physics).  They run eagerly, as an eager frame's ticks do: each
        push takes the host clock that `_tick` advances, and the ring's
        cursor moves on the device, so the next frame (fused or not) reads
        the state they leave.  Sets `last_aux`: the StepAux counters summed
        over the ticks, as a frame's are."""
        stages = self._stages(self._render_params(), tick_time=self._tick)
        fused.run_stages(stages, fused.schedule(self.config.steps_per_frame)[:-1])
        self.last_aux = StepAux(*self._state.aux.clone().unbind())

    # coarse static ladder of view-cell sizes (the JAX package's): a zoom
    # sweep lands on few distinct cell sizes
    _CELL_LADDER = (8, 16, 24, 32, 48, 64)

    def _render_params(self) -> raytrace.RenderParams:
        """Render params for the CURRENT zoom: the minimal legal view-cell
        size quantized UP to the ladder, the diagnostics-driven boosts, and
        a view-derived sweep bound `max_age`."""
        cfg = self.config
        zoom = float(self._cam_zoom)
        need = raytrace.auto_cell_px(cfg.render, cfg.width, cfg.height, zoom)
        k = next((k for k in self._CELL_LADDER if k >= need), need)
        out = cfg.render
        if out.cell_px != k:
            out = dataclasses.replace(out, cell_px=k)
        if self._band_boost:
            out = dataclasses.replace(out, band=min(out.band + self._band_boost, 12))
        if self._cap_boost:
            out = dataclasses.replace(
                out, bin_capacity=min(out.bin_capacity + self._cap_boost, 384))
        if self._pair_boost and out.pair_budget > 0:
            out = dataclasses.replace(out, pair_budget=out.pair_budget << self._pair_boost)
        if self._retina_boost and out.retina_budget > 0:
            out = dataclasses.replace(out, retina_budget=out.retina_budget << self._retina_boost)
        if self._entry_boost and out.entry_budget > 0:
            out = dataclasses.replace(out, entry_budget=out.entry_budget << self._entry_boost)
        if self._seg_boost and 0 < out.segments < out.band:
            out = dataclasses.replace(
                out, segments=min(out.segments << self._seg_boost, out.band))
        # light reaching the (camera-centred) view comes from within
        # corner-distance / h ticks; quantized to 64 ticks
        if cfg.render_mode in ("retarded", "instant") and out.max_age == 0:
            ps = zoom / max(cfg.width, cfg.height)
            corner = 0.5 * ps * math.hypot(cfg.width, cfg.height)
            if out.camera_frame:
                # the boosted view's GROUND footprint reaches gamma (1 + |v|)
                # times the corner distance on the trailing side; the host
                # camera velocity, so no device sync
                v = min(float(np.linalg.norm(self._cam_vel)), 0.999)
                corner *= (1.0 + v) / math.sqrt(1.0 - v * v)
            a = int(math.ceil(corner / cfg.physics.h)) + out.band + 8
            a = min(cfg.history, ((a + 63) // 64) * 64)
            if a < cfg.history:
                out = dataclasses.replace(out, max_age=a)
        return out

    def render(self) -> torch.Tensor:
        """The current frame, (H, W, 3) f32 ((max(16, H // 8), num_rays, 3)
        in retina mode), rendered eagerly; sets `last_diag`.  The conical
        mode raises ValueError without config.defect or defect_source, the
        btz mode without config.btz."""
        stages = self._stages(self._render_params())
        img, counters = stages["render"]()
        self.last_diag = fused.unpack(counters, stages["render"])[1]
        return img.permute(1, 2, 0)

    def render_views(self, cams) -> torch.Tensor:
        """The current ring seen by several cameras: (B, H, W, 3).  `cams` is
        a sequence of Cameras or a batched Camera (camera.stack_cameras).
        Retarded and instant modes only, as in the JAX package; each view
        launches the band (retarded) and pixel kernels on the card."""
        cfg = self.config
        mode = cfg.render_mode
        if mode not in ("retarded", "instant"):
            raise ValueError(f"render_views supports retarded/instant modes, not {mode!r}")
        rparams = self._render_params()
        if mode == "instant":
            rparams = dataclasses.replace(rparams, opaque=False, retarded=False)
        if isinstance(cams, (list, tuple)):
            cams = stack_cameras([c.to(self.device) for c in cams])
        p = self.particles
        return raytrace.render_views(self.worldline, p.object_index, self.objects, cams,
                                     cfg.width, cfg.height, rparams,
                                     boundary=wl.boundary_mask(p), mesh=self.mesh)

    # -- fused frame --------------------------------------------------------

    _FUSED_CACHE_MAX = 4  # fused frames kept (see _render_params)

    def _fused_frame_fn(self, rparams) -> fused.FusedFrame:
        """The fused frame for `rparams`: steps, pushes and render, captured
        as CUDA graphs at its first call on a CUDA device.  Kept by a key of
        what its closures bake in (the JAX key's fields that the port has,
        the defect and BTZ geometry and the worldline3d view among them,
        with the view size and physics); at most _FUSED_CACHE_MAX, evicted first in,
        first out.  Each entry pins the materials, so a recycled id cannot
        alias a stale frame."""
        cfg = self.config
        key = (rparams, cfg.render_mode, cfg.steps_per_frame, cfg.wl3d, cfg.btz, cfg.defect,
               cfg.defect_vel, cfg.defect_retarded, cfg.defect_source, cfg.defect_G,
               self.model, id(self.materials), id(self._aloof), cfg.width, cfg.height,
               cfg.physics)
        cache = self._fused_cache
        if key in cache:
            return cache[key][0]
        if self.device.type == "cuda" and self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
            self._graph_pool = torch.cuda.graph_pool_handle()
        frame = fused.FusedFrame(self._stages(rparams), fused.schedule(cfg.steps_per_frame),
                                 self.device, pool=self._graph_pool,
                                 stream=self._graph_stream, stats=self.graph_stats)
        if len(cache) >= self._FUSED_CACHE_MAX:
            cache.pop(next(iter(cache)))  # FIFO evict
        cache[key] = (frame, self.materials, self._aloof)
        return frame

    def _can_fuse(self) -> bool:
        return (not self.paused and not self.config.stage_timing
                and self.config.render_mode in FUSED_MODES
                and (self._aloof is None or self._aloof.capturable))

    def run_frame(self, keys: Optional[Dict] = None) -> torch.Tensor:
        """One full frame: camera -> physics -> worldline -> render -> stats
        and diagnostics.  Returns the image, (H, W, 3) f32, a tensor of its
        own (its device work may still be queued; the call waits only for
        the previous frame)."""
        t0 = time.perf_counter()
        cfg = self.config
        frame_dt = cfg.physics.h * cfg.steps_per_frame
        if self.recorder is not None:
            self.recorder.record(self.frame, keys, self.hotswap)
        if keys:
            pos, zoom = self.controller.update(self._cam_pos, self._cam_zoom, keys, frame_dt)
            self._cam_pos, self._cam_zoom = pos, zoom
            if keys.get("p"):
                self.paused = not self.paused
        self._move_camera(frame_dt)
        self._upload()
        rparams = self._render_params()
        clock = None
        if self._can_fuse():
            frame = self._fused_frame_fn(rparams)
            timed = StageClock(self.device) if self._profile_clocks is not None else None
            img, counters = frame(timed)
            if timed is not None:
                self._profile_clocks.append(timed)
            self.time += frame_dt
            render = frame.stages["render"]
        else:
            clock = StageClock(self.device)
            stages = self._stages(rparams, tick_time=self._tick)
            img, counters = fused.run_stages(
                stages, fused.schedule(cfg.steps_per_frame, ticks=not self.paused), clock)
            render = stages["render"]
            self.graph_stats["eager"] += 1
        self.last_aux, self.last_diag = fused.unpack(counters, render)
        self._drops += fused.drop_counts(counters, render)
        if self.device.type == "cuda":
            end = torch.cuda.Event()
            end.record()
            if self._prev_end is not None:
                self._prev_end.synchronize()
            self._prev_end = end
        self.frame += 1
        self._flush_stats()
        self._pending = (clock, time.perf_counter() - t0)
        self._check_diag()
        return img.permute(1, 2, 0)

    def _flush_stats(self) -> None:
        """Add the pending frame to the stats window; an eager frame's stage
        times wait for its end."""
        if self._pending is not None:
            clock, frame_time = self._pending
            stages = clock.seconds() if clock is not None else {}
            self._stats.add(FramePerfStats(**stages, frame_time=frame_time))
            self._pending = None

    @property
    def stats(self) -> StatsWindow:
        """The stats window, with every frame run so far."""
        self._flush_stats()
        return self._stats

    def profile_stages(self, n_frames: int = 3) -> Dict[str, float]:
        """Per-stage time of the fused frame: `n_frames` real frames, each
        stage's graph replays bracketed by CUDA events outside the graphs
        (the host clock on the CPU), averaged per frame.  The counterpart
        of the JAX Engine's profiler capture of its compiled frame.  The
        result, seconds per frame by stage and their total, is kept so the
        stats summary reports it (`*_dev_ms`; `*_host_ms` on the CPU) beside
        the fused frame's zero stage times."""
        self._profile_clocks = []
        try:
            for _ in range(n_frames):
                self.run_frame()
            clocks = self._profile_clocks
        finally:
            self._profile_clocks = None
        sums: Dict[str, float] = {}
        for clock in clocks:
            for name, sec in clock.seconds().items():
                key = name.removesuffix("_time")
                sums[key] = sums.get(key, 0.0) + sec
        stages = {k: v / max(len(clocks), 1) for k, v in sums.items()}
        if stages:
            stages["total"] = sum(stages.values())
            self._stats.profiled_stages = stages
            self._stats.profiled_on = "device" if self.device.type == "cuda" else "host"
        return stages

    def _check_diag(self) -> None:
        """Consume RenderDiag every `diag_every` frames: warn on silent-
        quality conditions and ADAPT the budgets, on evidence only (the JAX
        package's rules).  The StepAux counters need no reading here: the
        port's collision kernel has no cell cap or window to overflow."""
        if self.config.diag_every <= 0 or self.frame % self.config.diag_every:
            return
        diag = self.last_diag
        if diag is None or isinstance(diag, PointsDiag):
            return  # the point view drops nothing (no window cap)
        fields = [f for f in diag._fields if getattr(diag, f) is not None]
        # ONE device-to-host transfer for all counters
        vals = torch.stack([torch.as_tensor(getattr(diag, f)).to(torch.int64)
                            for f in fields]).tolist()
        d = dict(zip(fields, vals))
        render = self.config.render
        if d["band_truncated"] > 0 and self._band_boost < 6:
            self._band_boost += 2
            self.log.warning("cone band truncated for %d particles: raising band to %d",
                             d["band_truncated"], render.band + self._band_boost)
        cap_now = render.bin_capacity + self._cap_boost
        # a capped bin drops its FARTHEST candidates; below 0.1% of the
        # pairs that is inside the retina's quantization: log, don't adapt
        dropped = d["bin_dropped"]
        drop_tol = max(1, int(1e-3 * max(d["pairs_used"], 1)))
        if 0 < dropped <= drop_tol:
            self.log.debug("%d far candidates dropped from full bins (<= %d tolerance): "
                           "within the nearest-k envelope, not adapting", dropped, drop_tol)
        elif dropped > 0:
            if cap_now < 384:
                # doubling converges in <= 3 steps from the default 64
                self._cap_boost = min(cap_now * 2, 384) - render.bin_capacity
                self.log.warning("%d candidates dropped from full view bins: raising "
                                 "bin_capacity to %d", dropped,
                                 render.bin_capacity + self._cap_boost)
            else:
                self.log.warning("%d candidates dropped from full view bins at the "
                                 "bin_capacity ceiling (%d)", dropped, cap_now)
        if render.pair_budget > 0 and d["pairs_used"] > (render.pair_budget << self._pair_boost):
            self._grow_budget("_pair_boost", render.pair_budget, d["pairs_used"],
                              "cone-crossing pairs exceed pair_budget",
                              "occupancy/occlusion may drop surfaces")
        if d["cell_too_small"]:
            self.log.warning("view cells smaller than capsule reach: splat coverage is "
                             "incomplete at this zoom")
        if d.get("retina_dropped", 0) > 0:
            self._grow_budget("_retina_boost", render.retina_budget, d["retina_dropped"],
                              "boundary pairs beyond retina_budget",
                              "occlusion may miss surfaces")
        if d.get("entry_dropped", 0) > 0:
            self._grow_budget("_entry_boost", render.entry_budget, d["entry_dropped"],
                              "valid splat entries beyond entry_budget",
                              "whole view cells may be missing")
        if d.get("segment_dropped", 0) > 0:
            # _render_params caps segments at the (boosted) band
            band = min(render.band + self._band_boost, 12) if self._band_boost else render.band
            self._grow_budget("_seg_boost", render.segments, d["segment_dropped"],
                              "valid crossings beyond the segments slots",
                              "fast approachers lose trailing-edge capsules", ceiling=band)

    def _grow_budget(self, boost_attr: str, base: int, count: int,
                     what: str, consequence: str, ceiling: Optional[int] = None) -> None:
        """Shared budget-doubling adaptation: up to 4 doublings, then warn at
        the ceiling.  _render_params applies `base << boost`, capped at
        `ceiling` where one is given (segments at the band), and the log
        names the value it applies."""
        if base <= 0:
            return
        boost = getattr(self, boost_attr)
        if boost < 4:
            setattr(self, boost_attr, boost + 1)
            value = base << (boost + 1)
            if ceiling is not None:
                value = min(value, ceiling)
            self.log.warning("%d %s: raising the budget to %d", count, what, value)
        else:
            self.log.warning("%d %s at the adaptation ceiling: %s", count, what, consequence)

    def run(self, n_frames: int,
            on_frame: Optional[Callable[[int, torch.Tensor], None]] = None,
            realtime: bool = False,
            key_source: Optional[Callable[[], list]] = None) -> Dict[str, float]:
        """Headless loop of `n_frames`; returns the stats summary, with
        `drops`: each drop counter summed over every frame this Engine ran.

        `realtime` paces each frame to the LIVE `hotswap["max_fps"]`.
        `key_source() -> [(key_name, down), ...]` is polled before each frame
        and routed through viewer.apply_key; a `quit` key ends the loop, and
        `p` (pause) acts once, as an edge."""
        keys: dict = {}
        for i in range(n_frames):
            start = time.perf_counter()
            if key_source is not None:
                from . import viewer

                for key, down in key_source():
                    viewer.apply_key(keys, self, key, down)
                if keys.get("quit"):
                    break
                img = self.run_frame(keys=dict(keys))
                keys.pop("p", None)
            else:
                img = self.run_frame()
            if on_frame is not None:
                on_frame(i, img)
            if realtime:
                budget = 1.0 / max(self.hotswap["max_fps"], 1e-3)
                elapsed = time.perf_counter() - start
                if elapsed < budget:
                    time.sleep(budget - elapsed)
        return {**self.stats.summary(),
                "drops": dict(zip(fused.DROP_FIELDS, self._drops.tolist()))}

    def conserved_quantities(self):
        """Relativistic totals (momentum/energy/KE/bonds) — see
        utils/diagnostics.py — of the whole scene (gathered on a mesh)."""
        from .utils import diagnostics

        p = self.particles
        if self.mesh is not None:
            p = sharding.gather_particles(p, self.mesh)
        return diagnostics.totals(p)

    # -- persistence --------------------------------------------------------

    _ADAPT_FIELDS = ("_band_boost", "_cap_boost", "_pair_boost", "_retina_boost",
                     "_entry_boost", "_seg_boost")

    def _config_fingerprint(self) -> str:
        """Digest of the frozen config + scene shape, so a resumed engine can
        refuse a checkpoint from another scene/config."""
        cfg = dataclasses.asdict(self.config)
        cfg.pop("stage_timing")  # how frames are timed, not what they compute
        # the scene's own capacity: a mesh's padding and blocks leave it alone
        desc = repr((cfg, int(self._n_full), int(self.worldline.capacity)))
        return hashlib.sha256(desc.encode()).hexdigest()[:16]

    def _checkpoint_parts(self) -> dict:
        """The state a checkpoint holds: on a mesh the whole unpadded state,
        gathered on every rank (a collective: every rank calls it)."""
        p, buf = self.particles, self.worldline
        if self.mesh is not None:
            p, buf = sharding.gather_state(p, buf, self.mesh, self._n_full)
        return {"particles": p, "worldline": buf, "camera": self.camera}

    def _shard_state(self, particles: Particles, buf: wl.WorldlineBuffer):
        """(particles, ring) of this rank from the whole state (identity
        off a mesh), on the Engine's device."""
        if self.mesh is None:
            return particles, buf
        return sharding.shard_state(particles, buf, self.mesh)

    def save_checkpoint(self, path: str) -> None:
        """Write the state and the learned budgets to `path`.  On a mesh
        every rank calls it: the state is gathered, rank 0 writes, and the
        ranks wait for the file."""
        from .utils import checkpoint

        meta = {"time": self.time, "frame": self.frame,
                "config_fingerprint": self._config_fingerprint(),
                "hotswap": dict(self.hotswap),
                "paused": bool(self.paused)}
        for f in self._ADAPT_FIELDS:
            meta[f] = int(getattr(self, f))
        parts = self._checkpoint_parts()
        if self.mesh is None or self.mesh.rank == 0:
            checkpoint.save(path, parts, meta)
        if self.mesh is not None:
            multihost.sync(self.mesh)

    def load_checkpoint(self, path: str, strict: bool = True) -> None:
        """Restore state + learned adaptation budgets.  `strict` validates
        the config/scene fingerprint.  Everything is loaded and validated
        before any field of the engine changes.  A checkpoint of a single
        device loads on a mesh (every rank calls it) and back."""
        from .utils import checkpoint

        state, meta = checkpoint.load(path, self._checkpoint_parts())
        fp = meta.get("config_fingerprint")
        if strict and fp is not None and fp != self._config_fingerprint():
            raise ValueError(
                f"checkpoint {path!r} was saved under a different engine config/scene "
                "(fingerprint mismatch) — construct the engine with the saved run's "
                "config, or pass strict=False")
        self.particles, self.worldline = self._shard_state(state["particles"],
                                                           state["worldline"])
        self.time = float(meta["time"])
        self.camera = state["camera"]  # uploads the camera and the clock
        self.frame = int(meta["frame"])
        for f in self._ADAPT_FIELDS:
            if f in meta:
                setattr(self, f, int(meta[f]))
        if "hotswap" in meta:
            self.hotswap.update(meta["hotswap"])
        if "paused" in meta:
            self.paused = bool(meta["paused"])


def save_png(path: str, img) -> None:
    """Write an (H, W, 3) [0, 1] image (tensor or array) as PNG, quantized
    as the JAX package's save_png does."""
    from .utils import png

    arr = img.detach().cpu().numpy() if isinstance(img, torch.Tensor) else np.asarray(img)
    png.write_png(path, (np.clip(arr, 0.0, 1.0) * 255.0).astype(np.uint8))
