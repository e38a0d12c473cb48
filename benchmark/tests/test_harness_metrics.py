"""The metric arithmetic on hand-made Chrome-trace events and shapes."""

import numpy as np
import pytest

from benchmark import counts, harness, spec, trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def two_frames():
    """Two frames, each a 'step' range launching one kernel and a 'render'
    range replaying a graph whose two kernels carry the graph launch's
    correlation id; the device idle 400 us of each 1000 us frame."""
    out = []
    for f in range(2):
        t = 1000.0 * f
        out += [
            ev("user_annotation", "benchmark.run_frame", t, 900, tid=1),
            ev("user_annotation", "step", t + 10, 100, tid=1),
            ev("cuda_runtime", "cudaLaunchKernel", t + 20, 5, tid=1, corr=10 * f + 1),
            ev("kernel", "elementwise_kernel", t + 30, 200, tid=7, corr=10 * f + 1),
            ev("user_annotation", "render", t + 200, 100, tid=1),
            ev("cuda_runtime", "cudaGraphLaunch", t + 210, 5, tid=1, corr=10 * f + 2),
            ev("kernel", "band_kernel", t + 250, 300, tid=7, corr=10 * f + 2),
            ev("kernel", "points_winner_kernel", t + 570, 100, tid=7, corr=10 * f + 2),
        ]
    return out


def test_busy_union_counts_overlap_once_and_leaves_gaps_out():
    assert trace.busy_union([(0, 10), (5, 10), (30, 5)]) == 20


def test_stage_attribution_follows_a_graph_replay_correlation():
    got = trace.by_range(two_frames())
    assert got["step"] == [400.0, 2]
    assert got["render"] == [800.0, 4]  # both kernels of each replay


def make_ctx(events, frames=2, window_s=0.002, **kw):
    busy = trace.busy_union((e["ts"], e["dur"]) for e in trace.device_events(events))
    return {"events": events, "frames": frames, "window_s": window_s, "busy_s": busy / 1e6,
            "captures": 0, "config": {"width": 4, "height": 2}, "traffic": {},
            "params": {"band": 4, "max_age": 0}, "engine": None, **kw}


def test_stage_readers():
    ctx = make_ctx(two_frames())
    read = lambda n: spec.metric_reader(n)(ctx)
    assert read("step_device_ms") == pytest.approx(0.2)
    assert read("render_device_ms") == pytest.approx(0.4)
    assert read("step_launches") == 1
    assert read("render_launches") == 2
    # busy 600 us a frame in a 1000 us frame: 40% idle over the 2 ms block
    assert read("device_idle_pct") == pytest.approx(40.0)
    assert read("window_captures") == 0


def test_a_reader_with_nothing_to_read_returns_none():
    ctx = make_ctx([ev("user_annotation", "step", 0, 10)])
    for name in ("step_device_ms", "render_launches", "device_idle_pct"):
        assert spec.metric_reader(name)(ctx) is None


class Ring:
    capacity, num_particles, frames_in_use = 128, 1 << 20, 128


class Particles:
    capacity = 1 << 20


class Engine:
    worldline, particles = Ring(), Particles()


def test_roofline_readers_against_the_counts():
    ctx = make_ctx(two_frames(), engine=Engine())
    band_ms = 0.3  # a frame
    nbytes, nops = counts.band_work(128, 1 << 20, 128, 4, 0)
    assert nbytes == 127 * (1 << 20) * 8 + 5 * (1 << 20) * 16 + 8 * (1 << 20) \
        + 20 * 5 * (1 << 20) + 8
    assert nops == 10 * 127 * (1 << 20)
    want = 100 * counts.bound_s(nbytes, nops) * 1e3 / band_ms
    assert spec.metric_reader("band_roofline")(ctx) == pytest.approx(want)
    pb, po = counts.points_work(1 << 20, 4, 2)
    assert (pb, po) == ((1 << 20) * 13 + 12 * 8, 10 * (1 << 20))
    assert spec.metric_reader("points_roofline")(ctx) == pytest.approx(
        100 * counts.bound_s(pb, po) * 1e3 / 0.1)


def test_band_work_caps_the_sweep_by_max_age_and_the_in_use_count():
    assert counts.band_work(1024, 10, 1024, 4, 256)[1] == 10 * 255 * 10
    assert counts.band_work(1024, 10, 40, 4, 256)[1] == 10 * 39 * 10


def test_top_ops_and_idle_gaps():
    events = two_frames()
    top = trace.top_ops(events)
    assert top[0] == ("band_kernel", pytest.approx(600e-6))
    gaps = dict(trace.idle_gaps(events))
    # gaps 230->250 (inside 'render') and 550->570 in each frame, and
    # 670->1030 between them, by the shortest host range open at the middle
    assert gaps == {"benchmark.run_frame": pytest.approx(400e-6),
                    "render": pytest.approx(40e-6)}
    assert dict(trace.idle_gaps(events, named=1)) == {
        "benchmark.run_frame": pytest.approx(360e-6), "(shorter gaps)": pytest.approx(80e-6)}


def test_p95_and_fps_take_every_frame_restores_included():
    """The window's intervals: 99 frames of 10 ms and one of 40 ms (the
    frame after a restore).  p95 is over all 100 intervals, and fps over
    the window's whole seconds."""
    intervals = np.full(100, 0.010)
    intervals[50] = 0.040
    returns = np.cumsum(intervals)
    got = np.diff(np.concatenate([[0.0], returns]))
    assert harness.p95(got) == pytest.approx(0.010)
    intervals[50:56] = 0.040
    assert harness.p95(np.diff(np.concatenate([[0.0], np.cumsum(intervals)]))) \
        == pytest.approx(0.040)
    assert 100 / returns[-1] == pytest.approx(100 / 1.03)
