"""The program's spans (utils/profiling.span) on the CPU: the Engine's
frame loop under a torch.profiler trace emits its `engine.*` spans, named
as the benchmark's readers expect and nested under `engine.frame`; without
a trace nothing opens a `record_function` range and no sub-stage works out
its label; the conical render names its routes' sub-stages.  The card's side (the capture, the
waits on the device, the stage ranges around graph replays) is held in
tests/test_torch_cuda.py."""

import time

import pytest
import torch

from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace
from spacetime_tpu_torch.utils import profiling
from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

CPU = [torch.profiler.ProfilerActivity.CPU]
# the spans a CPU frame passes through (no capture and no wait on a device
# event there), and those of an eager (stage-timing) frame besides
FUSED_SPANS = {"engine.frame", "engine.input", "engine.upload", "engine.params", "step",
               "worldline", "render", "engine.outputs", "engine.stats", "engine.adapt",
               "engine.wait.diag_read"}
EAGER_SPANS = FUSED_SPANS | {"engine.wait.stage_clock"}
WAITS = {"engine.wait.staging", "engine.wait.prev_frame", "engine.wait.stage_clock",
         "engine.wait.diag_read"}


def _config(**kw):
    base = dict(scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                                capacity=256),
                render=raytrace.RenderParams(num_rays=256), width=48, height=48, history=32,
                diag_every=1)
    base.update(kw)
    return EngineConfig(**base)


def _spans(prof):
    """[(name, start us, end us)] of the trace's ranges."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.name.startswith("engine.") or e.name in ("step", "worldline", "render")]


@pytest.mark.parametrize("stage_timing", [False, True], ids=["fused", "eager"])
def test_traced_frames_emit_the_engine_spans_inside_engine_frame(stage_timing):
    eng = Engine(_config(stage_timing=stage_timing), device="cpu")
    eng.run_frame()
    with torch.profiler.profile(activities=CPU) as prof:
        for _ in range(2):
            eng.run_frame()
    spans = _spans(prof)
    assert {n for n, _, _ in spans} == (EAGER_SPANS if stage_timing else FUSED_SPANS)
    frames = [(a, b) for n, a, b in spans if n == "engine.frame"]
    assert len(frames) == 2
    for name, a, b in spans:
        assert any(fa <= a and b <= fb for fa, fb in frames), name
    # every engine.wait.* span is one of the known places where the host waits
    assert {n for n, _, _ in spans if n.startswith("engine.wait.")} <= WAITS


def _refuse_ranges(monkeypatch):
    def refused(name):
        raise AssertionError(f"range {name!r} opened without a trace")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refused)


def test_frames_without_a_trace_open_no_range(monkeypatch):
    fused_eng = Engine(_config(), device="cpu")
    eager_eng = Engine(_config(stage_timing=True), device="cpu")
    _refuse_ranges(monkeypatch)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    for eng in (fused_eng, eager_eng):
        eng.hotswap["max_fps"] = 1e-3
        eng.run(2, on_frame=lambda i, img: None, realtime=True)
    assert fused_eng.frame == eager_eng.frame == 2


def test_spanned_works_out_its_label_only_under_a_trace():
    labels = []

    def label(args, kwargs):
        labels.append(args)
        return f"twice {args[0]}"

    twice = profiling.spanned(label)(lambda x: 2 * x)
    assert twice(3) == 6 and labels == []
    with torch.profiler.profile(activities=CPU) as prof:
        assert twice(4) == 8
    assert labels == [(4,)]
    assert "twice 4" in {e.name for e in prof.events()}


def test_conical_frame_names_each_routes_sub_stages():
    """The conical render's band search is one span a route (route 1 the
    chord, route 2 each defect's), the innermost over raytrace's band
    search, beside its own view tables, route-2 images and route pass."""
    eng = Engine(_config(render_mode="conical", defect=((0.5, 0.55), 1.2),
                         cam_pos=(0.45, 0.3), width=32, height=32), device="cpu")
    with torch.profiler.profile(activities=CPU) as prof:
        eng.run_frame()
    names = {e.name for e in prof.events()}
    for label in ("band + pairs, route 1", "band sweep + pairs, route 2", "pair compaction",
                  "view tables", "splat CSR", "route-2 images", "retina march", "route pass",
                  "cell sort", "collision kernel", "springs"):
        assert label in names, label
    assert "cone sweep + pairs" not in names
