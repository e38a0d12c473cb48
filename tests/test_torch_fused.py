"""The port's fused frame (spacetime_tpu_torch.fused and the Engine's
`_fused_frame_fn` / `_can_fuse`), run uncaptured on the CPU, against the
JAX Engine's fused path (which `_can_fuse` selects on a JAX CPU run), on
the tiny config of tests/test_engine.py; the stage-timing path against
JAX's; the cache of fused frames; what the Engine keeps in its fixed
state tensors; the replay harness's refusal without CUDA; the attribution
of a graph replay's kernels to its stage range; and the pixel pass at a bin_capacity above what a 48 KB slice holds, against the JAX
Pallas kernel in interpret mode.  The CUDA graphs themselves are held to
the eager frame on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import bench, convert, fused
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import config

FRAMES = 8
# positions: the same physics in another f32 order (tests/test_torch_slice.py)
POS_ATOL = 1e-5
# images: at most 0.1% of pixels may flip at capsule edges (test_torch_render.py)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
DIAG_FIELDS = ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small",
               "retina_dropped", "entry_dropped", "segment_dropped")
AUX_FIELDS = ("grid_overflow", "bonds_broken", "window_truncated")


def _tiny(mod, **kw):
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
        width=48, height=48, history=32)
    base.update(kw)
    return mod.EngineConfig(**base)


def _configs(**kw):
    """(JAX config, port config) of the tiny scene with the same overrides."""
    return (_tiny(jconfig, render=jrt.RenderParams(num_rays=256), **kw),
            _tiny(config, render=rt.RenderParams(num_rays=256), **kw))


_RUNS = {}


def _run(mode, spf):
    """(JAX engine, JAX images, port engine, port images) after FRAMES frames
    of `mode` with `steps_per_frame` spf, computed once per case."""
    if (mode, spf) not in _RUNS:
        jcfg, cfg = _configs(render_mode=mode, steps_per_frame=spf)
        je = JEngine(jcfg)
        jimgs = []
        je.run(FRAMES, on_frame=lambda i, img: jimgs.append(np.asarray(img)))
        pe = Engine(cfg, device="cpu")
        imgs = []
        pe.run(FRAMES, on_frame=lambda i, img: imgs.append(img.numpy().copy()))
        _RUNS[mode, spf] = (je, jimgs, pe, imgs)
    return _RUNS[mode, spf]


@pytest.mark.parametrize("spf", [1, 2])
@pytest.mark.parametrize("mode", ["retarded", "instant", "points"])
def test_fused_frames_match_jax_fused_path(mode, spf):
    je, jimgs, pe, imgs = _run(mode, spf)
    assert je._can_fuse() and pe._can_fuse()
    assert len(pe._fused_cache) == len(je._fused_cache) == 1
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    assert pe.frame == je.frame == FRAMES and pe.time == je.time
    # the clock: f32(time) + h per tick on the device, as the JAX program adds
    np.testing.assert_array_equal(pe.worldline.times.numpy(), np.asarray(je.worldline.times))
    assert int(pe.worldline.cursor) == int(je.worldline.cursor) == (FRAMES * spf - 1) % 32
    assert int(pe.worldline.frames_in_use) == int(je.worldline.frames_in_use) == 32
    for name in AUX_FIELDS:
        assert int(getattr(pe.last_aux, name)) == int(getattr(je.last_aux, name)), name
    if mode == "points":
        assert int(pe.last_diag.window_truncated) == int(je.last_diag.window_truncated) == 0
        for img, jimg in zip(imgs, jimgs):
            cov = np.any(img != 1.0, axis=-1)
            np.testing.assert_array_equal(cov, np.any(jimg != 1.0, axis=-1))
        return
    for name in DIAG_FIELDS:
        a, b = getattr(pe.last_diag, name), getattr(je.last_diag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name
    assert int(pe.last_diag.pairs_used) > 0
    for img, jimg in zip(imgs, jimgs):
        assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    assert (imgs[-1].min(-1) < 0.9).any()


def test_fused_stats_report_zero_stage_times_as_jax():
    """The fused frame's stats: a real frame time, zero stage times, like
    the JAX fused frame's; profile_stages then fills per-stage times."""
    je, _, pe, _ = _run("retarded", 1)
    ours, ref = pe.stats.summary(), je.stats.summary()
    for k in ("step_avg_ms", "worldline_avg_ms", "render_avg_ms"):
        assert ours[k] == ref[k] == 0.0, k
    assert ours["frame_avg_ms"] > 0 and set(ref) <= set(ours)
    eng = Engine(_configs()[1], device="cpu")
    eng.run(2)
    stages = eng.profile_stages(2)
    assert set(stages) == {"step", "worldline", "render", "total"}
    assert all(v > 0 for v in stages.values())
    assert eng.frame == 4 and eng.graph_stats == fused.new_stats()
    summary = eng.stats.summary()
    for k in ("step", "worldline", "render", "total"):
        assert summary[f"{k}_host_ms"] == pytest.approx(stages[k] * 1e3)
    assert summary["stage_source"] == "profile_stages"


def _stage_timed(spf):
    """(JAX engine, port engine) after 4 stage-timed (eager) frames of
    `steps_per_frame` spf: the same physics, and the ring's times exactly
    equal (both push f32 of the host clock after each tick's `+= h`)."""
    jcfg, cfg = _configs(stage_timing=True, steps_per_frame=spf)
    je, pe = JEngine(jcfg), Engine(cfg, device="cpu")
    assert not je._can_fuse() and not pe._can_fuse()
    je.run(4)
    pe.run(4)
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    assert pe.time == je.time
    np.testing.assert_array_equal(pe.worldline.times.numpy(), np.asarray(je.worldline.times))
    assert int(pe.worldline.cursor) == int(je.worldline.cursor) == (31 + 4 * spf) % 32
    return je, pe


def test_stage_timing_summary_matches_jax():
    """tests/test_engine.py::test_stage_timing_summary on both Engines: the
    eager path with per-stage times, the same physics and ring times."""
    je, pe = _stage_timed(1)
    ours, ref = pe.stats.summary(), je.stats.summary()
    for k in ("step_avg_ms", "worldline_avg_ms", "render_avg_ms"):
        assert ours[k] > 0 and ref[k] > 0, k
    assert set(ref) <= set(ours) and not pe._fused_cache


def test_stage_timing_ring_times_match_jax_at_two_steps_a_frame():
    """Two ticks a frame on the eager path: each push takes the host clock
    of its own tick, as JAX's does (not f32(t_prev) + h per tick, the
    fused frame's clock)."""
    _, pe = _stage_timed(2)
    assert pe.frame == 4 and not pe._fused_cache


def test_run_summary_sums_drop_counters_by_name():
    """Engine.run's summary reports each drop counter summed over every
    frame run, by name; fused.drop_counts adds the point view's two
    window_truncated counters (StepAux and PointsDiag) into one."""
    cfg = _tiny(config, render=rt.RenderParams(num_rays=256, bin_capacity=2))
    eng = Engine(cfg, device="cpu")
    seen = []
    summary = eng.run(3, on_frame=lambda i, img: seen.append(
        {**eng.last_aux._asdict(), **eng.last_diag._asdict()}))
    assert list(summary["drops"]) == list(fused.DROP_FIELDS)
    for name, total in summary["drops"].items():
        assert total == sum(int(f[name]) for f in seen if f.get(name) is not None), name
    assert summary["drops"]["bin_dropped"] > 0  # two entries a view cell drop some
    render = lambda: None  # noqa: E731 -- a closure with the points layout
    render.fields = ["window_truncated"]
    counters = torch.tensor([5, 7, 2, 3], dtype=torch.int64)  # StepAux, then PointsDiag
    drops = fused.drops_of(counters, render)
    assert drops == {**dict.fromkeys(fused.DROP_FIELDS, 0), "grid_overflow": 5,
                     "window_truncated": 5}


def test_stats_summary_reports_median_and_first_frame():
    """The stats summary's frame_median_ms and frame_first_ms (a warm-up
    frame lands in the average and the lows, not in the median)."""
    from spacetime_tpu_torch.utils.stats import FramePerfStats, StatsWindow

    window = StatsWindow()
    for sec in (2.0, 0.010, 0.012, 0.011):
        window.add(FramePerfStats(frame_time=sec))
    summary = window.summary()
    assert summary["frame_first_ms"] == pytest.approx(2000.0)
    assert summary["frame_median_ms"] == pytest.approx(11.5)
    assert summary["frame_avg_ms"] == pytest.approx(508.25)
    assert summary["low_01pct_ms"] == pytest.approx(2000.0)


def test_fused_cache_key_across_the_cell_ladder_matches_jax():
    """A 2x zoom sweep and back (tests/test_engine.py's, at zooms where the
    48-pixel view's cells cross from 16 to 8 pixels): the cache's keys hold
    the JAX keys' render params, field for field, in the same order; the
    sweep back adds none."""
    jcfg, cfg = _configs()
    je, pe = JEngine(jcfg), Engine(cfg, device="cpu")
    zooms = np.linspace(0.02, 0.04, 12)
    for sweep in (zooms, zooms[::-1]):
        for z in sweep:
            je.camera = JCamera(pos=je.camera.pos, zoom=jnp.float32(z), vel=je.camera.vel)
            pe.camera = Camera.create(pos=(0.5, 0.5), zoom=float(z), device="cpu")
            je.run_frame()
            pe.run_frame()
        ours = [k[0] for k in pe._fused_cache]
        ref = [k[0] for k in je._fused_cache]
        assert 1 < len(ours) == len(ref) <= 2
        for a, b in zip(ours, ref):
            assert {f.name: getattr(a, f.name) for f in dataclasses.fields(a)} == \
                {f.name: getattr(b, f.name) for f in dataclasses.fields(a)}


def test_fused_cache_evicts_first_in_at_four():
    """Five zooms on five rungs of the cell ladder (8, 16, 24, 32 and 48
    pixels): four frames kept, the oldest evicted first; revisiting a kept
    zoom reuses its frame."""
    eng = Engine(_configs()[1], device="cpu")
    frames = []
    zooms = (0.049, 0.0204, 0.01224, 0.00816, 0.00612)
    for zoom in zooms:
        eng.camera = Camera.create(pos=(0.5, 0.5), zoom=zoom, device="cpu")
        eng.run_frame()
        frames.append(eng._fused_frame_fn(eng._render_params()))
    assert len({f.stages["render"] for f in frames}) == 5
    cached = [entry[0] for entry in eng._fused_cache.values()]
    assert len(cached) == Engine._FUSED_CACHE_MAX == 4 and cached == frames[1:]
    assert [k[0].cell_px for k in eng._fused_cache] == [16, 24, 32, 48]
    eng.camera = Camera.create(pos=(0.5, 0.5), zoom=zooms[2], device="cpu")
    eng.run_frame()
    assert [entry[0] for entry in eng._fused_cache.values()] == frames[1:]
    # the evicted zoom comes back as a new frame, evicting the next oldest
    eng.camera = Camera.create(pos=(0.5, 0.5), zoom=zooms[0], device="cpu")
    eng.run_frame()
    kept = [entry[0] for entry in eng._fused_cache.values()]
    assert kept[:3] == frames[2:] and kept[3] is not frames[0]


def test_engine_state_stays_in_its_tensors():
    """The tensors a fused frame reads stay the Engine's state: after a
    fused frame, a paused (eager) frame, a stage-timed frame, setting the
    camera, assigning particles and loading a checkpoint; particles passed
    in are copied, and returned images are tensors of their own."""
    _, cfg = _configs(render_mode="retarded")
    eng = Engine(cfg, device="cpu")
    ref = {"pos": eng.particles.pos, "ring": eng.worldline.pos_x,
           "cursor": eng.worldline.cursor, "frame_in": eng._state.frame_in}

    def same():
        return (eng.particles.pos is ref["pos"] and eng.worldline.pos_x is ref["ring"]
                and eng.worldline.cursor is ref["cursor"]
                and eng.camera.pos.data_ptr() == ref["frame_in"].data_ptr())

    first = eng.run_frame()
    kept = first.clone()
    eng.run_frame()
    assert same() and torch.equal(first, kept)
    eng.run_frame(keys={"p": True})  # paused: an eager frame
    assert eng.paused and not eng._can_fuse() and same()
    eng.run_frame(keys={"p": True})
    eng.camera = Camera.create(pos=(0.47, 0.45), zoom=0.8, device="cpu")
    assert same() and float(eng.camera.zoom) == pytest.approx(0.8)
    moved = dataclasses.replace(eng.particles, pos=eng.particles.pos + 0.001)
    eng.particles = moved
    assert same() and torch.equal(eng.particles.pos, moved.pos)
    other = Engine(cfg, moved, eng.objects, device="cpu")
    assert other.particles.pos is not moved.pos  # copied, not shared
    assert int(eng.worldline.cursor) == 2  # three ticks pushed after the prefill (T = 32)


def test_checkpoint_loads_into_the_state_tensors(tmp_path):
    """A checkpoint (including one whose ring cursor was saved as a host int,
    a 0-d int64 array) loads into the Engine's own tensors; the resumed
    fused frames match the original's."""
    _, cfg = _configs(render_mode="retarded")
    eng = Engine(cfg, device="cpu")
    eng.run(3)
    path = str(tmp_path / "c.npz")
    eng.save_checkpoint(path)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    assert arrays["worldline.cursor"].dtype == np.int32
    arrays["worldline.cursor"] = np.asarray(int(arrays["worldline.cursor"]))  # int64, 0-d
    arrays["worldline.frames_in_use"] = np.asarray(int(arrays["worldline.frames_in_use"]))
    old = str(tmp_path / "old.npz")
    np.savez(old, **arrays)
    for p in (path, old):
        eng2 = Engine(cfg, device="cpu")
        pos, cursor = eng2.particles.pos, eng2.worldline.cursor
        eng2.load_checkpoint(p)
        assert eng2.particles.pos is pos and eng2.worldline.cursor is cursor
        assert cursor.dtype == torch.int32 and int(cursor) == int(eng.worldline.cursor)
        assert float(eng2._state.frame_in[5]) == np.float32(eng.time)
        eng2.run(2)
    eng.run(2)
    assert torch.equal(eng.particles.pos, eng2.particles.pos)
    assert torch.equal(eng.worldline.times, eng2.worldline.times)


def test_bench_without_cuda_exits_nonzero(monkeypatch, capsys, tmp_path):
    """A session flag on a box without CUDA: exit 1, no result line, no
    session file."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    session = tmp_path / "s.jsonl"
    assert bench.main(["--record", str(session)]) == 1
    assert bench.main(["--replay", str(session)]) == 1
    assert capsys.readouterr().out == "" and not session.exists()


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def test_pixel_pass_above_a_48kb_slice_matches_pallas_interpret():
    """bin_capacity 1536 (a staged slice of 62,480 bytes, past the 48 KB a
    block has without opting in): the JAX package's Pallas pixel kernel in
    interpret mode renders it, and the port's plain path matches it within
    PIXEL_TOL / PIXEL_SHARE; the two keep the same nearest-first entries."""
    h = 0.005
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(5, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(jscene.disc_softbody(5, 1, (0.42, 0.43), (-0.25, -0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    jp, jo = sb.build()
    jbuf = jwl.prefill_inertial(jwl.create(64, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(h))
    jbuf = jwl.push_frame(jbuf, dataclasses.replace(jp, pos=jp.pos + jp.vel * h), h)
    jcam = JCamera.create(pos=(0.39, 0.41), zoom=0.15)
    jparams = jrt.RenderParams(dt=h, num_rays=512, pair_budget=2048, bin_capacity=1536,
                               cell_px=32, occlusion_downsample=2, ray_chunk=256,
                               retina_budget=128, max_age=48, backend="pallas_interpret")
    params = rt.RenderParams(**{f.name: getattr(jparams, f.name)
                                for f in dataclasses.fields(rt.RenderParams)})
    buf = convert.worldline_from_numpy(_fields(jbuf))
    tp = convert.particles_from_numpy(_fields(jp))
    to, cam = convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam))
    jimg, jdiag = jrt.render_retarded_with_diag(jbuf, jp.object_index, jo, jcam, 64, 48, jparams,
                                                planar=True, boundary=jwl.boundary_mask(jp))
    img, diag = rt.render_retarded_with_diag(buf, tp.object_index, to, cam, 64, 48, params,
                                             planar=True, boundary=wl.boundary_mask(tp))
    inputs, _ = rt.prepare_pixel_pass(buf, tp.object_index, to, cam, 64, 48, params,
                                      boundary=wl.boundary_mask(tp))
    assert int((inputs.cell_hi - inputs.cell_lo).max()) > 64  # crowded cells
    assert int(diag.bin_dropped) == int(jdiag.bin_dropped) == 0
    img, jimg = img.numpy(), np.asarray(jimg)
    assert (img < 0.99).mean() > 0.05
    assert np.mean(np.abs(img - jimg).max(axis=0) > PIXEL_TOL) <= PIXEL_SHARE


def test_stage_breakdown_of_graph_replays():
    """utils.profiling.attribute on a trace of the fused frame's shape: the
    kernels of a graph replay carry the correlation id of its graph
    launch, so they fall in the stage range open at that launch, per frame
    (the image copy outside any stage); empty for a trace without device
    activity (a CPU run).  And utils/roofline.py's bound of a piece of
    work: bytes or operations, whichever sets it."""
    from spacetime_tpu_torch.utils import profiling, roofline

    def x(cat, name, ts, dur, tid=1, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [x("user_annotation", "step", 0, 10),
              x("cuda_runtime", "cudaGraphLaunch", 5, 1, corr=1),
              x("user_annotation", "worldline", 20, 10),
              x("cuda_runtime", "cudaGraphLaunch", 25, 1, corr=2),
              x("user_annotation", "render", 40, 10),
              x("cuda_runtime", "cudaGraphLaunch", 45, 1, corr=3),
              x("cuda_runtime", "cudaMemcpyAsync", 60, 1, corr=4)]
    for corr, durs in ((1, (400, 600)), (2, (100,)), (3, (3000, 1000)), (4, (200,))):
        events += [x("kernel", "k", 1000 * corr + i, d, tid=7, corr=corr)
                   for i, d in enumerate(durs)]
    by_range = profiling.attribute(events, 2)["by_range"]
    assert {k: v[0] for k, v in by_range.items()} == pytest.approx(
        {"step": 0.5, "worldline": 0.05, "render": 2.0, "(no range)": 0.1})
    assert profiling.attribute([e for e in events if e["cat"] != "kernel"], 2)["by_range"] == {}
    # the bound of work at the H100 SXM's published peaks: bytes or operations
    assert roofline.Roofline(flops=67e9, bytes_accessed=3.35e9).bound_s == pytest.approx(1e-3)
    assert roofline.Roofline(flops=134e9, bytes_accessed=3.35e9).bound_by == "operations"
    assert roofline.Roofline(flops=1e9, bytes_accessed=6.7e9).bound_by == "bytes"
