"""The span readers (`host_submit_ms`, `host_blocked_ms`,
`device_starved_pct`) and `_spans.starved_by_span` on hand-made Chrome-trace
events."""

import pytest

from benchmark import spec
from benchmark.metrics import _spans
from benchmark.tests.test_harness_metrics import ev, make_ctx


def one_frame():
    """One 1000 us frame.  A graph launched at 100-120 runs kernels at
    150-300 and 400-500: the gap between them lies inside submitted work.
    A kernel launched by a call at 550-650 runs at 700-800: the gap 500-700
    is starved until the call's end, 650.  A call at 820-950 launches a
    kernel that starts at 900, before the call returns: the gap 800-900 is
    starved whole.  The waits: diag_read 600-700 with another wait nested in
    it, prev_frame 850-950, and a staging wait after the frame."""
    return [
        ev("user_annotation", "benchmark.run_frame", 0, 1000),
        ev("user_annotation", "engine.frame", 5, 990),
        ev("cuda_runtime", "cudaGraphLaunch", 100, 20, corr=1),
        ev("kernel", "k1", 150, 150, tid=7, corr=1),
        ev("kernel", "k2", 400, 100, tid=7, corr=1),
        ev("user_annotation", "engine.outputs", 540, 70),
        ev("cuda_runtime", "cudaLaunchKernel", 550, 100, corr=2),
        ev("kernel", "k3", 700, 100, tid=7, corr=2),
        ev("user_annotation", "engine.wait.diag_read", 600, 100),
        ev("user_annotation", "engine.wait.inner", 620, 60),
        ev("cuda_runtime", "cudaMemcpyAsync", 820, 130, corr=3),
        ev("gpu_memcpy", "Memcpy HtoD", 900, 100, tid=7, corr=3),
        ev("user_annotation", "engine.wait.prev_frame", 850, 100),
        ev("user_annotation", "engine.wait.staging", 1000, 100),
    ]


def read(name, events, **kw):
    return spec.metric_reader(name)(make_ctx(events, frames=1, window_s=0.002, **kw))


def test_a_gap_ended_by_work_submitted_before_it_is_not_starved():
    gaps = _spans.starved_gaps(one_frame())
    assert (300.0, 400.0) not in gaps and all(a >= 500 for a, _ in gaps)


def test_a_gap_ended_by_a_launch_during_it_is_starved_to_the_calls_end():
    assert _spans.starved_gaps(one_frame()) == [(500.0, 650.0), (800.0, 900.0)]
    # 250 us of the 2 ms block; the device idles 1550 us of it
    assert read("device_starved_pct", one_frame()) == pytest.approx(12.5)
    assert read("device_starved_pct", one_frame()) <= read("device_idle_pct", one_frame())


def test_nested_waits_count_once():
    # diag_read 600-700 holds the inner wait: 100 us, not 160; the staging
    # wait lies outside the frame and prev_frame is left out
    assert read("host_blocked_ms", one_frame()) == pytest.approx(0.1)
    # 990 us of frame less 100 (diag_read) and 100 (prev_frame)
    assert read("host_submit_ms", one_frame()) == pytest.approx(0.79)


def test_waits_are_clipped_to_the_frame_and_per_frame():
    events = one_frame() + [ev("user_annotation", "engine.frame", 2000, 500),
                            ev("user_annotation", "engine.wait.staging", 2400, 300)]
    ctx = make_ctx(events, frames=2, window_s=0.003)
    # the staging wait counts 2400-2500, inside its frame
    assert spec.metric_reader("host_blocked_ms")(ctx) == pytest.approx((100 + 100) / 2 / 1e3)
    assert spec.metric_reader("host_submit_ms")(ctx) == pytest.approx(
        (990 + 500 - 200 - 100) / 2 / 1e3)


def test_starved_by_span_names_the_innermost_range_at_the_starved_middle():
    got = _spans.starved_by_span(one_frame())
    assert got == {"engine.outputs": pytest.approx(150e-6),
                   "engine.wait.prev_frame": pytest.approx(100e-6)}
    assert list(got) == ["engine.outputs", "engine.wait.prev_frame"]


def test_a_trace_without_the_programs_spans_reads_none_for_the_host():
    """The parent program opens no engine.* span: the host readers leave
    their metrics out, and the starved share needs only the device ops and
    their launches."""
    events = [e for e in one_frame() if not e["name"].startswith("engine.")]
    assert read("host_submit_ms", events) is None
    assert read("host_blocked_ms", events) is None
    assert read("device_starved_pct", events) == pytest.approx(12.5)
    assert _spans.starved_by_span(events) == {"benchmark.run_frame": pytest.approx(250e-6)}


def test_a_gap_inside_a_launch_in_flight_is_not_starved():
    """A graph whose launch call (0-500) outlasts its first nodes: the gaps
    between its nodes (100-200, 300-400) lie inside the graph.  The gap
    before a launch whose ops all follow it (500-600, call 450-550) is
    starved to the call's end."""
    events = [ev("cuda_runtime", "cudaGraphLaunch", 0, 500, corr=1),
              ev("kernel", "a", 50, 50, tid=7, corr=1),
              ev("kernel", "b", 200, 100, tid=7, corr=1),
              ev("kernel", "c", 400, 100, tid=7, corr=1),
              ev("cuda_runtime", "cudaLaunchKernel", 450, 100, corr=2),
              ev("kernel", "d", 600, 10, tid=7, corr=2)]
    assert _spans.starved_gaps(events) == [(500.0, 550.0)]


def test_ops_that_start_together_take_the_earliest_launch():
    events = [ev("cuda_runtime", "cudaLaunchKernel", 0, 10, corr=1),
              ev("kernel", "a", 20, 30, tid=7, corr=1),
              ev("cuda_runtime", "cudaGraphLaunch", 30, 5, corr=2),
              ev("cuda_runtime", "cudaLaunchKernel", 60, 20, corr=3),
              ev("kernel", "b", 100, 10, tid=7, corr=2),
              ev("kernel", "c", 100, 10, tid=8, corr=3)]
    # the graph was launched (35) before the gap (50-100) began
    assert _spans.starved_gaps(events) == []
