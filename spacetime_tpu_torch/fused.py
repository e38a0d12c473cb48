"""The fused frame: physics steps, worldline pushes and the render, replayed
as CUDA graphs.

Counterpart of `Engine._fused_frame_fn` in `spacetime_tpu/engine.py` and of
the `jax.jit(frame, donate_argnums=(0, 1))` of `bench.py`.  XLA compiles
the JAX frame into one program; here each stage of the frame is a closure
over fixed tensors, captured into a CUDA graph and replayed, so a frame
costs the host a few graph launches and one small upload instead of some
1,200 eager launches.

The state a frame reads and writes in place (`FrameState`):
  * the particles: a step's results are copied back into the particles'
    own tensors (the JAX program donates its state; a graph must find the
    state where it read it the last time);
  * the worldline ring, whose cursor and in-use count are device tensors
    (ops/worldline.py);
  * `frame_in`, (6,) f32: the camera (x, y, zoom, vx, vy) and the frame
    clock t_prev, filled by one copy a frame (the Engine's upload);
  * `aux`, (3,) i64: the StepAux counters summed over the frame's ticks.

The stages (`frame_stages`), in the order a frame runs them:
  * step: one RK4 step (models/softbody.py); the first tick of a frame
    writes its StepAux counters into `aux`, later ticks add theirs, as the
    JAX frame sums them over its scan;
  * worldline: the clock advances by h in f32 on the device (JAX's
    `t_prev + h`), the aloof bodies (if any) are written into their slots
    at that clock, and the tick is pushed into the ring (aloof slots
    present, physics-inactive);
    step and worldline run `steps_per_frame` times;
  * render: the planar (3, H, W) image (the retina mode's strip is
    (3, max(16, H // 8), num_rays)) and one i64 vector of counters: `aux`,
    then the render's diagnostics that are not None (`unpack` reads it
    back; the retina mode has none); the stage is a `RenderStage`.  The
    conical mode computes its defects inside the stage from the device
    clock (the JAX frame's
    in-graph `t_end`), so a replay places them at its own frame's time;
    matter-sourced ones read the particles and the ring there.  The btz
    mode renders around a hole whose tensors the Engine made once for the
    frame (Engine._btz_hole); the Engine keys its fused frames on
    config.btz, so new geometry makes a new frame.

`FusedFrame` runs that schedule.  On the CPU it calls the stages in turn;
the tier-1 tests hold that path to the JAX fused frame.  On CUDA its first
call runs the stages eagerly on the frame's own stream (the frame's real
work, and the warm-up a capture needs: lazy set-up, the points kernel's
scratch of that stream) and then captures each distinct stage into a CUDA
graph, all in one memory pool (the graphs never run at once); every later
call replays them.  A capture that fails raises: nothing falls back to
eager.  A call returns fresh copies of the render's outputs, since the next
replay overwrites the graph's own.  Each stage runs inside a span named
after the stage; a replay opens no other span inside those.  The launch
counts that the wrappers make while a stage is captured are held apart
and added at each replay (kernels.held_apart), so `kernels.launches`
counts kernels that ran.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import kernels
from .camera import Camera
from .ops import btz, curved, points_cuda, raytrace, rasterize, worldline3d
from .ops import worldline as wl
from .ops.points_cuda import PointsDiag
from .ops.rk4 import StepAux
from .utils.profiling import span


class FrameState(NamedTuple):
    """The fixed tensors a frame reads and writes in place."""

    particles: object  # state.Particles
    buf: wl.WorldlineBuffer
    frame_in: torch.Tensor  # (6,) f32: camera x, y, zoom, vx, vy, then t_prev
    aux: torch.Tensor  # (3,) i64: StepAux counters summed over a frame's ticks


def new_state(particles, buf, cam: Camera, t_prev: float) -> FrameState:
    """A FrameState over `particles` and `buf` (used as they are, not
    copied), with the camera `cam` and the clock at `t_prev`."""
    dev = particles.pos.device
    frame_in = torch.cat([cam.pos.reshape(2), cam.zoom.reshape(1), cam.vel.reshape(2),
                          torch.full((1,), float(np.float32(t_prev)), device=dev)])
    return FrameState(particles, buf, frame_in.to(device=dev, dtype=torch.float32),
                      torch.zeros(3, dtype=torch.int64, device=dev))


def owned(x):
    """A copy of the state dataclass `x` with tensors of its own."""
    return dataclasses.replace(x, **{f.name: getattr(x, f.name).clone()
                                     for f in dataclasses.fields(x)
                                     if getattr(x, f.name) is not None})


def copy_state(state: FrameState) -> FrameState:
    """A FrameState with tensors of its own, equal to `state`'s."""
    return FrameState(owned(state.particles), owned(state.buf), state.frame_in.clone(),
                      state.aux.clone())


def restore(state: FrameState, saved: FrameState) -> None:
    """Copy `saved` (e.g. a copy_state) into `state`'s tensors, in place."""
    commit(state.particles, saved.particles)
    commit(state.buf, saved.buf)
    state.frame_in.copy_(saved.frame_in)
    state.aux.copy_(saved.aux)


def camera_of(frame_in: torch.Tensor) -> Camera:
    """The Camera whose tensors are views of `frame_in`."""
    return Camera(pos=frame_in[0:2], zoom=frame_in[2], vel=frame_in[3:5])


def commit(static, new) -> None:
    """Copy each tensor field of the dataclass `new` that is not already the
    tensor of `static` into `static`'s (in place)."""
    for f in dataclasses.fields(static):
        dst, src = getattr(static, f.name), getattr(new, f.name)
        if src is dst:
            continue
        if dst is None or src is None:
            raise ValueError(f"{f.name}: a field cannot appear or vanish in place")
        dst.copy_(src)


def same_layout(a, b) -> bool:
    """Do two state dataclasses have tensors of the same shapes, dtypes and
    devices, field for field (so one can be copied into the other)?"""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if (x is None) != (y is None):
            return False
        if x is not None and (x.shape != y.shape or x.dtype != y.dtype or x.device != y.device):
            return False
    return True


def frame_stages(model, materials, state: FrameState, objects, width: int, height: int,
                 params, mode: str, h: float, tick_time: Optional[Callable[[], float]] = None,
                 aloof=None, present=None, defects=None, wl3d=None, hole=None, mesh=None,
                 object_index=None):
    """{stage name: closure} of one frame: 'step' (first tick), 'step_more'
    (later ticks), 'worldline' and 'render' (see the module docstring).
    `mode` is 'retarded', 'instant', 'points', 'retina', 'conical', 'btz'
    or 'worldline3d'; instant renders with opaque=False, retarded=False, as the
    JAX Engine does.  With `tick_time` (eager frames only: its value is
    baked into a capture) each push takes the clock from it instead, f32 of
    the host time it returns, as the JAX Engine's eager path pushes its host
    clock.  `aloof` (models/aloofbody.Injection) writes the aloof bodies
    before each push, which stores the slots of `present` (default: the
    active ones).  The conical mode takes `defects(t, cam, particles, buf,
    max_age)` -> ConicalDefect tuple (Engine._defects), called in the
    render stage with the device clock; btz takes its `hole`
    (ops/btz.BTZBlackHole, device tensors); worldline3d takes its view
    parameters `wl3d` (ops/worldline3d.Worldline3DParams).  With `mesh`
    (parallel.mesh.Mesh) the state is this rank's block, `model` steps on
    the mesh, the render stage runs the renderers' mesh paths and returns
    the whole image on every rank; the point view reads the replicated
    `object_index`, the conical `defects` the mesh's sums."""
    h32 = float(np.float32(h))
    cam = camera_of(state.frame_in)
    clock = state.frame_in[5]

    def step(first: bool) -> Callable[[], None]:
        def run():
            new, aux = model.step(state.particles, materials)
            commit(state.particles, new)
            counts = torch.stack(list(aux)).to(torch.int64)
            if first:
                state.aux.copy_(counts)
            else:
                state.aux.add_(counts)
        return run

    def push():
        host = None
        if tick_time is None:
            clock.add_(h32)
        else:
            host = tick_time()
            clock.fill_(float(np.float32(host)))
        if aloof is not None:
            aloof(state.particles, clock, host)
        wl.push_frame(state.buf, state.particles, clock, present=present)

    def with_diag(img, diag):
        """The image, the counters (aux, then the diag fields not None) and
        those fields' names."""
        vals = [torch.as_tensor(v).to(torch.int64).reshape(1) for v in diag if v is not None]
        return (img, torch.cat([state.aux] + vals),
                [f for f, v in zip(diag._fields, diag) if v is not None])

    def with_points_diag(img):
        """The image and the counters of the point views: aux, then
        PointsDiag's window_truncated, always 0 (no window cap)."""
        return img, torch.cat([state.aux, torch.zeros(1, dtype=torch.int64,
                                                      device=state.aux.device)]), \
            ["window_truncated"]

    if mode == "points" and mesh is not None:
        def render():
            return with_points_diag(points_cuda.render_points_mesh(
                state.particles, objects, cam, width, height, mesh, object_index))
    elif mode == "points":
        def render():
            return with_points_diag(rasterize.render_points(
                state.particles, objects, cam, width, height, planar=True))
    elif mode == "worldline3d":
        def render():
            return with_points_diag(worldline3d.render_worldline3d(
                state.buf, state.particles.object_index, objects, cam, width, height, wl3d,
                active=state.particles.active, boundary=wl.boundary_mask(state.particles),
                planar=True, mesh=mesh))
    elif mode == "conical":
        def render():
            ds = defects(clock, cam, state.particles, state.buf, params.max_age)
            return (*with_diag(*curved.render_retarded_conical_with_diag(
                state.buf, state.particles.object_index, objects, cam, ds, width, height,
                params, planar=True, mesh=mesh)), ds)
    elif mode == "btz":
        def render():
            return with_diag(*btz.render_btz_with_diag(
                state.buf, state.particles.object_index, objects, cam, hole, width, height,
                params, planar=True, mesh=mesh))
    elif mode == "retina":
        def render():
            img = raytrace.render_retina(state.buf, state.particles.object_index, objects, cam,
                                         params, height=max(16, height // 8), planar=True,
                                         mesh=mesh)
            return img, state.aux.clone(), []
    else:
        if mode == "instant":
            params = dataclasses.replace(params, opaque=False, retarded=False)

        def render():
            return with_diag(*raytrace.render_retarded_with_diag(
                state.buf, state.particles.object_index, objects, cam, width, height, params,
                planar=True, boundary=wl.boundary_mask(state.particles), mesh=mesh))
    return {"step": step(True), "step_more": step(False), "worldline": push,
            "render": RenderStage(render)}


class RenderStage:
    """frame_stages' render stage: a call runs `run` and returns (image,
    counters), and keeps what it found as attributes: `fields`, the names
    of the diagnostics after aux in the counters (`unpack` reads them), and
    in the conical mode `defects`, the defects it used (after a capture,
    the graph's own tensors, which each replay rewrites).  Kept on an
    object, not on the closure: a closure that sets its own attributes
    refers to itself, and that cycle held a dropped frame's state (its
    ring) and its graph-pool tensors until the cyclic garbage collector
    ran, which could then free graph memory in the middle of another
    capture."""

    def __init__(self, run: Callable[[], tuple]):
        self.run = run
        self.fields: Optional[List[str]] = None
        self.defects = None

    def __call__(self):
        img, counters, self.fields, *rest = self.run()
        if rest:
            self.defects = rest[0]
        return img, counters


def schedule(steps_per_frame: int, ticks: bool = True) -> List[Tuple[str, str]]:
    """(stage name, closure key) in run order: the ticks (none when
    `ticks` is False, as for a paused frame), then the render."""
    order = []
    if ticks:
        for i in range(steps_per_frame):
            order += [("step", "step" if i == 0 else "step_more"), ("worldline", "worldline")]
    return order + [("render", "render")]


def unpack(counters: torch.Tensor, render) -> tuple:
    """(StepAux, diag) as views of the counter vector of the render stage
    `render` (of frame_stages; its `fields` names the diagnostics it
    packed): PointsDiag for the point and worldline3d views, None for the
    retina mode, else RenderDiag, whose fields the renderer left None stay
    None."""
    aux = StepAux(*counters[:3])
    if not render.fields:
        return aux, None
    vals = dict(zip(render.fields, counters[3:]))
    if render.fields == ["window_truncated"]:
        return aux, PointsDiag(**vals)
    return aux, raytrace.RenderDiag(**{f: vals.get(f) for f in raytrace.RenderDiag._fields})


# StepAux and render counters that count dropped work (not bonds_broken or
# pairs_used)
DROP_FIELDS = ("grid_overflow", "window_truncated", "band_truncated", "bin_dropped",
               "cell_too_small", "retina_dropped", "entry_dropped", "segment_dropped")


def drop_counts(counters: torch.Tensor, render) -> torch.Tensor:
    """(len(DROP_FIELDS),) i64 on the counters' device, in DROP_FIELDS
    order: the drop counters of a counter vector that the render stage
    `render` packed (see unpack), by name; one the vector holds twice (the
    point view's window_truncated, in StepAux and PointsDiag) summed, one it
    does not hold 0.  Device work only: the index is made once a closure."""
    index = getattr(render, "drop_index", None)
    if index is None or index.device != counters.device:
        names = list(StepAux._fields) + render.fields
        pairs = [(DROP_FIELDS.index(n), i) for i, n in enumerate(names) if n in DROP_FIELDS]
        index = torch.tensor(pairs, dtype=torch.int64).T.contiguous().to(counters.device)
        render.drop_index = index
    return counters.new_zeros(len(DROP_FIELDS)).index_add_(
        0, index[0], counters.index_select(0, index[1]))


def drops_of(counters: torch.Tensor, render) -> dict:
    """{drop counter: int} of drop_counts, read back in one transfer."""
    return dict(zip(DROP_FIELDS, drop_counts(counters, render).tolist()))


def _each_stage(order, run_one, clock):
    """run_one(closure key) for each stage of `order`, inside a span named
    after the stage (utils/profiling.py attributes the device work
    launched inside it); with a utils.stats.StageClock, each stage's span
    marked.  Returns the last stage's outputs."""
    out = None
    for name, key in order:
        a = clock.mark() if clock is not None else None
        with span(name):
            out = run_one(key)
        if clock is not None:
            clock.span(f"{name}_time", a, clock.mark())
    return out


def run_stages(stages, order, clock=None):
    """Run `order` (see `schedule`) eagerly on the current stream (see
    _each_stage)."""
    return _each_stage(order, lambda key: stages[key](), clock)


def new_stats() -> dict:
    """Graph counts (FusedFrame.stats): captures, replays, and the host
    seconds the captures took (their first frames' eager runs apart); and
    `eager`, the frames an Engine ran without its graphs (stage timing, a
    pause, the retina mode, an aloof trajectory that cannot be captured)."""
    return {"captures": 0, "replays": 0, "capture_s": 0.0, "eager": 0}


class FusedFrame:
    """A frame's stages, run eagerly on the CPU and captured as CUDA graphs
    on a CUDA device (see the module docstring).  `stats` (new_stats; one
    dict may serve several frames) counts this frame's captures (one, at
    its first call) and replays (every later call)."""

    def __init__(self, stages, order: Sequence[Tuple[str, str]], device: torch.device,
                 pool=None, stream: Optional[torch.cuda.Stream] = None, stats=None):
        self.stages, self.order, self.device = stages, list(order), device
        self.pool, self.stream = pool, stream
        self.stats = stats if stats is not None else new_stats()
        self.graphs = None  # closure key -> (graph, its outputs, its launch counts)
        self.keep = None  # the points scratch a graph holds the pointers of

    @property
    def captures(self) -> bool:
        """Does the next call capture the graphs (a CUDA device's first)?"""
        return self.device.type == "cuda" and self.graphs is None

    def __call__(self, clock=None):
        if self.device.type != "cuda":
            return run_stages(self.stages, self.order, clock)
        if self.graphs is None:
            return self._capture(clock)
        out = _each_stage(self.order, self._replay, clock)
        self.stats["replays"] += 1
        return None if out is None else tuple(t.clone() for t in out)

    def _replay(self, key):
        graph, outs, counts = self.graphs[key]
        graph.replay()
        kernels.add_launches(counts)
        return outs

    def _capture(self, clock):
        """The first call: the frame eagerly on the frame's stream, then one
        capture of each distinct stage."""
        main = torch.cuda.current_stream(self.device)
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        s = self.stream
        s.wait_stream(main)
        with torch.cuda.stream(s):
            out = run_stages(self.stages, self.order, clock)
        main.wait_stream(s)
        for t in out or ():
            t.record_stream(main)
        self.keep = points_cuda.held(self.device, s.cuda_stream)
        t0 = time.perf_counter()
        self.graphs = {key: _capture_stage(self.stages[key], self.pool, s)
                       for key in dict.fromkeys(k for _, k in self.order)}
        self.stats["captures"] += 1
        self.stats["capture_s"] += time.perf_counter() - t0
        return out


def _capture_stage(stage, pool, stream):
    """(graph, its outputs, its launch counts): `stage()` captured on
    `stream` into the memory pool `pool`.  torch.cuda.graph would first
    synchronize the device, collect garbage and empty the allocator's caches
    at every capture, a cost of its own at each new key; the stage's eager
    run has just set up all it needs, so the capture begins at once."""
    graph = torch.cuda.CUDAGraph()
    with kernels.held_apart() as counts, torch.cuda.stream(stream):
        graph.capture_begin(pool=pool)
        try:
            outs = stage()
        finally:
            graph.capture_end()  # a failed capture raises here or above
    return graph, outs, counts
