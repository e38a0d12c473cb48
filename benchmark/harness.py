"""One run of one cell: set-up, the measured window, the traced block, the
check and the result line.

The window drives `spacetime_tpu_torch.engine.Engine.run_frame`, one frame
after the other, as a viewer does (a closed loop of one client).  It
replays one fixed episode of the scene: set-up advances the scene to the
episode's first frame, runs the episode once (so the Engine's adaptation
settles and every render key the episode needs is captured), and keeps a
copy of the state; the window runs the episode, restores that state in
place through the Engine's public setters, and runs it again, until the
window's seconds are up.  Restores count in the window, and the window
does nothing else: `memory_peak_bytes` is the peak from the end of
set-up to the window's close (the Engine, its graphs and the saved
episode start).  After it, the check's pass restores the episode start
on the same Engine and replays the episode's frames up to the last of
the frames the seed samples, keeping what the check compares of those.

End-to-end metrics (trace 0): `fps`, the frames the window completed over
its seconds (the window ends with a synchronize after the last frame);
`frame_p95_ms`, the 95th percentile over all of the window's frames of
the interval between successive `run_frame` returns (the first from the
window's start); `setup_s`, the process's start to the first timed frame.

With trace 1 the same window runs, then one block of frames around the
episode's middle is traced with torch.profiler, and the per-layer
metrics are read from the window's counters and that trace
(`metrics/<name>.py`).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from . import check, spec, trace as trace_mod, traffic as traffic_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "spacetime_tpu")
TRACE_FRAMES = 64  # frames of the traced block
SAMPLES = 3  # window frames the check compares


def process_age_s() -> float:
    """Seconds since this process started (Linux: its start tick, against
    the boot-time clock)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")  # field 22, starttime
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN (compared
    whole: spacetime_tpu_torch is not spacetime_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def keep_caches_inside(root) -> None:
    """Kernel and compiler caches of anything the run loads go under the
    checkout, at fixed paths (the program's own kernel build already does:
    build/spacetime_tpu_torch/)."""
    base = os.path.join(root, "build", "benchmark_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(base, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


@dataclasses.dataclass
class Cell:
    """A cell's configuration and traffic, as its files give them."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    here: Path  # the benchmark folder that holds its files

    @classmethod
    def load(cls, bench: dict, name: str, here=spec.HERE) -> "Cell":
        w = spec.workload(bench, name)
        return cls(name, spec.config(w["config"], here), spec.traffic(w["traffic"], here),
                   spec.limits(name, here), here)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def engine_config(cell: Cell):
    """The EngineConfig of a cell: the configuration's bodies as the scene,
    its `physics` and `render` blocks as those parameters, every other
    EngineConfig field it names as it names it (lists as tuples), and the
    traffic's render mode."""
    from spacetime_tpu_torch.constants import PhysicsParams
    from spacetime_tpu_torch.ops.raytrace import RenderParams
    from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

    cfg = cell.config
    physics = PhysicsParams(**cfg.get("physics", {}))
    scene = SceneSpec(bodies=tuple((b["kind"], _tuples(b["size"]), tuple(b["offset"]),
                                    tuple(b["vel"]), tuple(b["rgb"])) for b in cfg["bodies"]),
                      lattice_pad=True)
    built = {"name", "scene", "physics", "render", "render_mode"}
    fields = {f.name for f in dataclasses.fields(EngineConfig)} - built
    return EngineConfig(scene=scene, physics=physics,
                        render=RenderParams(dt=physics.h, **cfg.get("render", {})),
                        render_mode=cell.traffic["mode"],
                        **{k: _tuples(v) for k, v in cfg.items() if k in fields})


def _particles(p) -> Dict:
    return {k: getattr(p, k).clone() for k in check.PARTICLE_FIELDS}


def _ring(buf, full: bool) -> Dict:
    """The ring after a frame: its times, cursor and in-use count, the
    newest row and its mirror of each plane (`rows`), and with `full`
    the whole planes."""
    out = {k: getattr(buf, k).clone() for k in ("times", "cursor", "frames_in_use")}
    rows = buf.cursor.long() + torch.tensor([0, buf.capacity], device=buf.cursor.device)
    out["rows"] = {k: getattr(buf, k).index_select(0, rows) for k in check.PLANES}
    if full:
        out.update({k: getattr(buf, k).clone() for k in check.PLANES})
    return out


class Run:
    """One run's Engine and its episode (see the module docstring)."""

    def __init__(self, cell: Cell, seed: int, device):
        from spacetime_tpu_torch.engine import Engine

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.engine = Engine(engine_config(cell), device=self.device)
        if cell.config.get("grid_dim"):
            self.engine.model.grid_dim = int(cell.config["grid_dim"])
        ep = cell.config["episode"]
        self.first, self.frames = int(ep["first"]), int(ep["frames"])
        self.script = traffic_mod.pan_script(cell.traffic["pan"], self.frames, seed)
        self.full_ring = spec.mode_reference(cell.traffic["mode"], cell.here).FULL_RING
        self.initial = _particles(self.engine.particles)
        self.saved = None
        self.built_s = process_age_s()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self, log=print) -> None:
        """Advance to the episode start, save the state, warm the episode
        once, restore; the seconds of each phase go to `log`."""
        eng = self.engine
        t0 = time.perf_counter()
        for _ in range(self.first):
            eng.run_frame()
        self.sync()
        t1 = time.perf_counter()
        self.start = _particles(eng.particles)
        ring = dataclasses.replace(eng.worldline, **{
            f.name: getattr(eng.worldline, f.name).clone()
            for f in dataclasses.fields(eng.worldline)})
        cam = eng.camera
        self.saved = (self.start, ring, eng.time, eng.frame,
                      (cam.pos.clone(), cam.zoom.clone(), cam.vel.clone()))
        for keys in self.script:
            eng.run_frame(keys=keys)
        self.restore()
        self.sync()
        log(f"setup: process to the Engine {self.built_s:.3f} s, advance {t1 - t0:.3f} s, "
            f"warm episode {time.perf_counter() - t1:.3f} s, graphs {eng.graph_stats}",
            file=sys.stderr)

    def restore(self) -> None:
        """The saved episode start, copied into the Engine's own tensors."""
        from spacetime_tpu_torch.camera import Camera

        eng = self.engine
        particles, ring, t, frame, (pos, zoom, vel) = self.saved
        eng.particles = dataclasses.replace(eng.particles, **particles)
        eng.worldline = ring
        eng.time, eng.frame = t, frame
        eng.camera = Camera(pos=pos, zoom=zoom, vel=vel)

    def frame(self, i: int, sample: bool):
        """Run episode frame `i`; with `sample`, return its check.Sample."""
        eng = self.engine
        keys = self.script[i]
        if not sample:
            eng.run_frame(keys=keys)
            return None
        before = _particles(eng.particles)
        ring_before = {"cursor": eng.worldline.cursor.clone(),
                       "frames_in_use": eng.worldline.frames_in_use.clone()}
        t_before = eng.time
        params = dataclasses.asdict(eng._render_params())
        img = eng.run_frame(keys=keys)
        counters = dict(zip(type(eng.last_aux)._fields, eng.last_aux))
        if eng.last_diag is not None:
            counters.update({k: v for k, v in eng.last_diag._asdict().items() if v is not None})
        cam = eng.camera
        return check.Sample(before, ring_before, t_before, _particles(eng.particles),
                            _ring(eng.worldline, self.full_ring), img.permute(2, 0, 1),
                            counters, (cam.pos.clone(), cam.zoom.clone(), cam.vel.clone()),
                            params)


def sample_frames(seed: int, frames: int) -> List[int]:
    """The episode frames the check compares: the first after a restore,
    and SAMPLES - 1 more drawn from the seed."""
    r = traffic_mod.rng(seed, 3)
    more = r.choice(np.arange(1, frames), size=min(SAMPLES - 1, frames - 1), replace=False)
    return [0] + sorted(int(i) for i in more)


def window(run: Run, seconds: float):
    """The measured window: (frames, window seconds, the return intervals)."""
    returns = []
    n = 0
    t0 = time.perf_counter()
    while True:
        i = n % run.frames
        if i == 0 and n:
            run.restore()
        run.frame(i, False)
        returns.append(time.perf_counter())
        n += 1
        if returns[-1] - t0 >= seconds:
            break
    run.sync()
    t1 = time.perf_counter()
    intervals = np.diff(np.asarray([t0] + returns))
    return n, t1 - t0, intervals


def sample_pass(run: Run, chosen: List[int]) -> list:
    """Restore the episode start and replay the episode up to the last
    chosen frame, keeping a check.Sample of each chosen frame."""
    run.restore()
    samples = [run.frame(i, i in chosen) for i in range(max(chosen) + 1)]
    run.sync()
    return [s for s in samples if s is not None]


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, exclusive method)."""
    values = list(values)
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


def traced_block(run: Run):
    """Trace TRACE_FRAMES frames around the episode's middle (from the
    episode start): (Chrome trace events, frames, seconds)."""
    run.restore()
    mid = max(0, run.frames // 2 - TRACE_FRAMES // 2)
    for i in range(mid):
        run.frame(i, False)
    run.sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            count = 0
            for i in range(mid, min(run.frames, mid + TRACE_FRAMES)):
                with torch.profiler.record_function("benchmark.run_frame"):
                    run.frame(i, False)
                count += 1
            run.sync()
            t1 = time.perf_counter()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return events, count, t1 - t0


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool, device,
             control: bool = False, here=spec.HERE, log=print) -> dict:
    """One run of cell `name`; returns the result dict (see run.py)."""
    cell = Cell.load(bench, name, here)
    check.require_modeled(cell.config, cell.traffic, here)
    run = Run(cell, seed, device)
    run.setup(log)
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    setup_s = process_age_s()
    captures0 = run.engine.graph_stats["captures"]
    frames, window_s, intervals = window(run, seconds)
    captures = run.engine.graph_stats["captures"] - captures0
    peak = int(torch.cuda.max_memory_allocated(run.device)) if cuda else 0
    log(f"window: {frames} frames in {window_s:.3f} s, interval median "
        f"{np.median(intervals) * 1e3:.4f} ms, mean {np.mean(intervals) * 1e3:.4f}, "
        f"max {np.max(intervals) * 1e3:.4f}, captures {captures}, "
        f"memory peak {peak} B", file=sys.stderr)
    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if not traced:
        measured = {"fps": frames / window_s, "frame_p95_ms": p95(intervals) * 1e3,
                    "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_of(bench, name, "end_to_end")}
    else:
        events, traced_frames, traced_s = traced_block(run)
        busy = trace_mod.busy_union((e["ts"], e["dur"]) for e in trace_mod.device_events(events))
        device_info.update(busy_s=busy / 1e6, window_s=traced_s)
        ctx = {"events": events, "frames": traced_frames, "window_s": traced_s,
               "busy_s": busy / 1e6, "captures": captures, "config": cell.config,
               "traffic": cell.traffic,
               "params": dataclasses.asdict(run.engine._render_params()),
               "engine": run.engine}
        for m in spec.metrics_of(bench, name, "per_layer"):
            value = spec.metric_reader(m["name"], here)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = {"device_ops": [list(x) for x in trace_mod.top_ops(events)],
                     "idle_gaps": [list(x) for x in trace_mod.idle_gaps(events)]}
        del events, ctx
    samples = sample_pass(run, sample_frames(seed, run.frames))
    # the program's state goes before the reference runs
    start, initial, first = run.start, run.initial, run.first
    mode = cell.traffic["mode"]
    del run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    with torch.no_grad():
        values = check.numbers(cell.config, mode, first, initial, start, samples, device,
                               control, here)
    correct = bool(samples) and check.judge(values, cell.limits)
    compared = {k: {"value": values.get(k), "limit": cell.limits[k]} for k in check.NUMBERS}
    for k in sorted(set(values) - set(check.NUMBERS)):
        log(f"info {k} {values[k]!r}", file=sys.stderr)
    for k, v in compared.items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    log(f"check samples {len(samples)} limit 1", file=sys.stderr)
    # a frame that fails raises, and the run with it
    result = {"correct": correct, "attempted": frames, "failed": 0,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checked"] = {**compared, "samples": {"value": len(samples), "limit": 1}}
    return result

