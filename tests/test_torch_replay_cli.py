"""Record/replay, `Engine.run`'s key source and pacing, the checkpoint's
live settings, the CLI's sink flags and the bench's session harness, on
the CPU, against the JAX package where it has the same function: a JAX
session log read and replayed by the port (and a port log read by JAX),
`run` stopping on `q` at JAX's frame, and `bench --diff` against
bench.py's `_cmd_diff`.  Tiny engines (a 48x48 view of two small discs);
every HTTP client has a timeout of a few seconds."""

import argparse
import http.client
import importlib.util
import io
import json
import os
import time

import numpy as np
import pytest
import torch
from PIL import Image

from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu.utils import replay as jreplay
from spacetime_tpu_torch import bench, cli
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config, replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 5.0
POS_ATOL = 1e-5  # the engine parity tests' tolerance on positions


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The Engines here run thousands of small torch ops; beside the
    suite's other workers each op's intra-op thread team waits on busy
    cores.  One thread a worker keeps their time that of the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(mod, **kw):
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),
                                    ("disc", 50, (0.52, 0.452), (-0.1, 0.0), (1.0, 0.3, 0.2))),
                            capacity=256),
        render=(jrt if mod is jconfig else rt).RenderParams(num_rays=256),
        width=48, height=48, history=32, cam_pos=(0.4813, 0.4437), cam_zoom=0.3)
    base.update(kw)
    return mod.EngineConfig(**base)


@pytest.fixture
def tiny_config(monkeypatch):
    """`tiny_io` in the port's registry: _cfg in retarded mode."""
    monkeypatch.setitem(config.CONFIGS, "tiny_io", lambda: _cfg(config))
    return "tiny_io"


def _state(eng):
    return {"pos": eng.particles.pos, "vel": eng.particles.vel,
            **{f"ring.{k}": v for k, v in vars(eng.worldline).items()
               if isinstance(v, torch.Tensor)}}


def _assert_bit_equal(a, b):
    for k, v in _state(a).items():
        assert torch.equal(v, _state(b)[k]), k


# --------------------------------------------------------------------------
# replay in the port
# --------------------------------------------------------------------------

# frame -> keys of a scripted session: pan, pause and unpause, zoom in and out
SCRIPT = {1: {"right": True}, 2: {"right": True, "up": True}, 3: {"p": True}, 5: {"p": True},
          6: {"z": True}, 7: {"z": True}, 9: {"x": True}}


def _record(path, cfg, frames=12):
    eng = Engine(cfg, device="cpu")
    with replay.ReplayRecorder(path, config=eng.config, meta={"config_name": "tiny"}) as rec:
        eng.recorder = rec
        for i in range(frames):
            if i == 4:
                eng.hotswap["max_fps"] = 30.0
            img = eng.run_frame(keys=SCRIPT.get(i))
    return eng, img


def test_replay_is_bit_exact(tmp_path):
    path = str(tmp_path / "s.jsonl")
    cfg = _cfg(config)
    eng, img = _record(path, cfg)
    header, events = replay.load_full(path)
    assert header["meta"] == {"config_name": "tiny"}
    assert [e["frame"] for e in events] == list(range(12))
    assert [i for i, e in enumerate(events) if "hotswap" in e] == [0, 4]
    assert events[3]["keys"] == {"p": True} and "keys" not in events[4]
    again = Engine(cfg, device="cpu")
    img2 = replay.replay(again, path)
    assert again.frame == eng.frame == 12 and again.hotswap == {"max_fps": 30.0}
    assert again.paused == eng.paused is False
    assert again.graph_stats["eager"] == eng.graph_stats["eager"] == 2  # the paused frames
    assert float(again.camera.zoom) == float(eng.camera.zoom) != cfg.cam_zoom
    assert torch.equal(img, img2)
    _assert_bit_equal(eng, again)


def test_replay_refuses_another_config_under_strict(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _record(path, _cfg(config), frames=2)
    other = Engine(_cfg(config, width=40), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        replay.replay(other, path)
    replay.replay(other, path, strict=False)
    assert other.frame == 2


# --------------------------------------------------------------------------
# across the packages, and Engine.run's key source
# --------------------------------------------------------------------------

# frame -> key events a key source yields: pan, pause edge, hotswap, zoom,
# unpause, then q
EVENTS = {1: [("d", True)], 3: [("d", False), ("w", True)], 4: [("p", True), ("w", False)],
          5: [("+", True)], 6: [("p", True), ("z", True)], 8: [("z", False), ("-", True)],
          9: [("-", True)], 11: [("q", True)]}
N_RUN = 20  # q at frame 11 ends the loop long before


def _key_source():
    frame = [0]

    def poll():
        out = EVENTS.get(frame[0], [])
        frame[0] += 1
        return out
    return poll


@pytest.fixture(scope="module")
def jax_session(tmp_path_factory):
    """A JAX Engine run under the key source, recorded: (engine, log path)."""
    path = str(tmp_path_factory.mktemp("jax") / "s.jsonl")
    je = JEngine(_cfg(jconfig))
    with jreplay.ReplayRecorder(path, config=je.config, meta={"config_name": "tiny"}) as rec:
        je.recorder = rec
        je.run(N_RUN, key_source=_key_source())
    return je, path


def test_run_key_source_stops_at_jax_frame(jax_session):
    je, _ = jax_session
    eng = Engine(_cfg(config), device="cpu")
    summary = eng.run(N_RUN, key_source=_key_source())
    assert eng.frame == je.frame == 11
    assert eng.hotswap == je.hotswap and eng.hotswap["max_fps"] != 72.0
    assert eng.paused == je.paused is False
    np.testing.assert_allclose(eng.camera.pos.numpy(), np.asarray(je.camera.pos), rtol=0,
                               atol=1e-6)
    assert float(eng.camera.zoom) == pytest.approx(float(je.camera.zoom), abs=1e-6)
    assert "drops" in summary


def test_port_replays_a_jax_log(jax_session):
    je, path = jax_session
    header, events = replay.load_full(path)
    jheader, jevents = jreplay.load_full(path)
    assert (header, events) == (jheader, jevents) and len(events) == 11
    eng = Engine(_cfg(config), device="cpu")
    replay.replay(eng, path, strict=False)  # the two packages' configs print differently
    assert eng.frame == je.frame and eng.hotswap == je.hotswap and eng.paused == je.paused
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(eng.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(eng.camera.pos.numpy(), np.asarray(je.camera.pos), atol=1e-6)


def test_jax_reads_a_port_log(tmp_path):
    path = str(tmp_path / "s.jsonl")
    _record(path, _cfg(config), frames=6)
    assert jreplay.load_full(path) == replay.load_full(path)
    fp, events = jreplay.load(path)
    assert fp == replay.config_fingerprint(_cfg(config)) and len(events) == 6


def test_run_realtime_paces_to_the_live_max_fps():
    eng = Engine(_cfg(config, render_mode="points"), device="cpu")
    eng.run(1)
    eng.hotswap["max_fps"] = 50.0
    t0 = time.perf_counter()
    eng.run(5, realtime=True)
    assert time.perf_counter() - t0 >= 0.1


def test_checkpoint_round_trips_hotswap(tmp_path):
    eng = Engine(_cfg(config, render_mode="points"), device="cpu")
    eng.run(2)
    eng.hotswap["max_fps"] = 33.0
    eng.save_checkpoint(str(tmp_path / "c.npz"))
    again = Engine(_cfg(config, render_mode="points"), device="cpu")
    again.load_checkpoint(str(tmp_path / "c.npz"))
    assert again.hotswap == {"max_fps": 33.0} and again.frame == 2


DROPPED_CASES = [
    ("retarded", {}), ("points", {}), ("conical", {"defect": ((0.5, 0.5), 0.5)}),
    ("conical", {"defect_source": ((0, None),), "defect_G": 1e-3}),
    ("btz", {"btz": ((0.5, 0.5), 0.03, 0.45)}), ("worldline3d", {}), ("retina", {})]


@pytest.mark.parametrize("mode,extra", DROPPED_CASES[:-1])
def test_a_dropped_engine_is_freed_at_once(mode, extra, monkeypatch):
    """No reference cycle holds an Engine (and with it its ring and, on the
    card, its CUDA graphs' memory) once its last reference goes: the conical
    stage keeps a function of the config, not a bound method of the Engine."""
    import gc
    import weakref

    cfg = _cfg(config, render_mode=mode, width=16, height=16, history=16, **extra)
    eng = Engine(cfg, device="cpu")
    eng.run(2)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


@pytest.mark.parametrize("mode,extra", DROPPED_CASES)
def test_a_dropped_engine_frees_its_ring_at_once(mode, extra):
    """Nor does a cycle hold the frame state its fused frames' stages close
    over (the ring; on the card, the graph-pool tensors of the conical
    stage's defects): a render closure that set its own attributes kept
    them until the cyclic collector ran, which could free graph memory in
    the middle of another capture."""
    import gc
    import weakref

    cfg = _cfg(config, render_mode=mode, width=16, height=16, history=16, **extra)
    eng = Engine(cfg, device="cpu")
    eng.run(2)
    refs = [weakref.ref(eng.worldline.pos_x), weakref.ref(eng.particles.pos)]
    gc.disable()
    try:
        del eng
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# the CLI's sink flags
# --------------------------------------------------------------------------


def test_cli_out_every_writes_the_raw_frames(tiny_config, tmp_path):
    out = tmp_path / "frames"
    seen = {}
    eng, img, summary = cli.run(["--config", tiny_config, "--frames", "5", "--out", str(out),
                                 "--every", "2", "--cpu"],
                                on_frame=lambda i, im: seen.update({i: im.numpy().copy()}))
    assert sorted(os.listdir(out)) == ["frame_00000000.png", "frame_00000002.png",
                                       "frame_00000004.png"]
    assert set(summary["sinks"]) == {"out"} and summary["sinks"]["out"] in ("native", "python")
    for i in (0, 2, 4):  # raw: no overlay on dumped frames
        got = np.asarray(Image.open(out / f"frame_{i:08d}.png"))
        np.testing.assert_array_equal(got, (np.clip(seen[i], 0, 1) * 255).astype(np.uint8))


def _read_part(port):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("GET", "/stream")
        r = c.getresponse()
        assert r.fp.readline().strip() == b"--spacetimeframe"
        headers = {}
        while (line := r.fp.readline().strip()):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        return r.fp.read(int(headers["content-length"]))
    finally:
        c.close()


def _key(port, name, down=True):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("GET", f"/key?d={int(down)}&k={name}")
        assert c.getresponse().status == 204
    finally:
        c.close()


@pytest.mark.parametrize("overlay", [True, False])
def test_cli_serve_streams_and_q_ends_the_run(tiny_config, overlay, capsys):
    argv = ["--config", tiny_config, "--frames", "3", "--serve", "0", "--cpu"]
    eng, args = cli.build(argv + ([] if overlay else ["--no-overlay"]))
    sinks = cli.Sinks(args, eng)
    parts = []

    def client(i, img):
        if i == 0:
            parts.append(_read_part(sinks.stream.port))
            parts.append(img.numpy().copy())
            _key(sinks.stream.port, "q")

    summary = cli.drive(eng, args, sinks, on_frame=client)
    assert eng.frame == 1  # q, posted during frame 0, ends the loop before frame 1
    assert "live view: http://127.0.0.1:" in capsys.readouterr().err
    data, img = parts
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    dec = np.asarray(Image.open(io.BytesIO(data))).astype(int)
    raw = (np.clip(img, 0, 1) * 255).astype(int)
    panel = np.abs(dec[8:30, 8:40] - raw[8:30, 8:40]).mean()
    assert (panel > 20) == overlay  # the stats panel only with the overlay
    assert summary["sinks"]["serve"] in ("native", "python")


def test_cli_stats_on_a_fused_run_reports_stage_times(tiny_config, capsys):
    assert cli.main(["--config", tiny_config, "--frames", "3", "--stats", "--cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    assert summary["stage_source"] == "profile_stages"
    for k in ("step_host_ms", "worldline_host_ms", "render_host_ms", "total_host_ms"):
        assert summary[k] > 0, k


# --------------------------------------------------------------------------
# the bench's session harness
# --------------------------------------------------------------------------


def test_bench_record_then_replay_is_bit_exact(tiny_config, tmp_path):
    path = str(tmp_path / "s.jsonl")
    eng, perf, img = bench.record_session(tiny_config, 24, path, device="cpu")
    again, rperf, img2 = bench.replay_session(path, device="cpu")
    assert torch.equal(img, img2)
    _assert_bit_equal(eng, again)
    for p in (perf, rperf):
        assert p["frames"] == 24 and p["config"] == tiny_config and p["backend"] == "cpu"
        assert p["frame_avg_ms"] > 0 and p["fps_avg"] > 0 and p["low_1pct_ms"] > 0
    with open(bench.perf_path(path)) as f:
        assert json.load(f) == rperf
    # bench.py's script: frames 10-19 zoom in, the "d" of 0-9 moves nothing
    assert float(eng.camera.zoom) < 0.3 and eng.camera.pos.tolist() == pytest.approx(
        [0.4813, 0.4437])


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DIFF_CASES = {
    "regression": ({"frame_avg_ms": 10.0, "fps_avg": 100.0, "low_1pct_ms": 12.0, "config": "x"},
                   {"frame_avg_ms": 11.0, "fps_avg": 90.9, "low_1pct_ms": 14.0, "config": "x"}),
    "within": ({"frame_avg_ms": 10.0, "fps_avg": 100.0, "low_1pct_ms": 12.0},
               {"frame_avg_ms": 10.2, "fps_avg": 98.0, "low_1pct_ms": 11.0}),
    "unknown": ({"frame_avg_ms": 10.0, "fps_avg": 100.0}, {"fps_avg": 90.0}),
}


@pytest.mark.parametrize("case", list(DIFF_CASES))
def test_bench_diff_matches_jax(case, tmp_path, capsys):
    a, b = (tmp_path / "a.perf.json"), (tmp_path / "b.perf.json")
    a.write_text(json.dumps(DIFF_CASES[case][0]))
    b.write_text(json.dumps(DIFF_CASES[case][1]))
    code = bench.main(["--diff", str(a), str(b)])
    ours = json.loads(capsys.readouterr().out)
    jcode = _jax_bench()._cmd_diff(argparse.Namespace(diff=[str(a), str(b)], threshold=5.0))
    ref = json.loads(capsys.readouterr().out)
    assert ours == ref and code == jcode == {"regression": 1, "within": 0, "unknown": 2}[case]


def test_bench_config_row_on_the_cpu(tiny_config, monkeypatch):
    """The named-config row's protocol, shrunk: its slow-frame schedule
    switches on what the first frames take."""
    monkeypatch.setattr(bench, "CONFIG_WINDOWS", 2)
    monkeypatch.setattr(bench, "SLOW_FRAME_S", 0.0)  # every frame "slow"
    monkeypatch.setattr(bench, "SLOW_SCHEDULE", (6, 2))
    row = bench.config_row(tiny_config, device="cpu")
    assert row["config"] == tiny_config and row["particles"] > 0
    assert row["schedule"] == "warm 6, best of 2 x 2 (slow-frame schedule)"
    assert row["frame_ms"] > 0 and set(row["drops"]) == set(
        ("grid_overflow", "window_truncated", "band_truncated", "bin_dropped", "cell_too_small",
         "retina_dropped", "entry_dropped", "segment_dropped"))


def test_build_capacity_is_bench_1m_scene():
    """The capacity scene at 2^20 particles (with a 2-tick ring here)."""
    from spacetime_tpu_torch import headline

    model, p, _, buf, cam, params = headline.build_capacity("cpu", history=2)
    assert p.capacity == int(p.active.sum()) == 1 << 20
    assert model.grid_dim == 768 and buf.capacity == 2
    assert cam.pos.tolist() == pytest.approx([1.79, 1.82]) and float(cam.zoom) == pytest.approx(0.9)
    assert (params.num_rays, params.pair_budget, params.bin_capacity, params.cell_px,
            params.band, params.splat_cells, params.retina_budget, params.max_age) == (
        4096, 131072, 128, 16, 4, 4, 16384, 0)
    assert model.spring_offsets is not None  # box bodies: the shifted springs
