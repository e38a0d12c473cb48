"""Frame and stage performance statistics (counterpart of
`spacetime_tpu/utils/stats.py`, same summary keys).

Stage times come from `StageClock`: CUDA events on a CUDA device, read once
the frame's work has ended (the Engine reads them one frame late, when it
waits on the previous frame anyway, so timing adds no sync); the host
clock on the CPU, where torch runs each op before it returns.  As in the
JAX package, the fused frame reports zero stage times: frames run with
`EngineConfig.stage_timing` carry their measured step, worldline and
render times, and `Engine.profile_stages` fills `profiled_stages`, which
the summary reports as `*_dev_ms`.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict

import numpy as np
import torch


@dataclasses.dataclass
class FramePerfStats:
    """Per-frame stage durations, seconds (the reference's FramePerfStats
    with the renderer's stage added)."""

    step_time: float = 0.0  # physics
    worldline_time: float = 0.0  # ring-buffer push
    render_time: float = 0.0
    frame_time: float = 0.0


class StageClock:
    """Marks between the stages of one frame on `device`; `seconds()` sums
    each stage's intervals."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans = []  # (stage, start mark, end mark)
        self.last = None

    def mark(self):
        if self.cuda:
            self.last = torch.cuda.Event(enable_timing=True)
            self.last.record()
        else:
            self.last = time.perf_counter()
        return self.last

    def span(self, stage: str, start, end) -> None:
        self.spans.append((stage, start, end))

    def seconds(self) -> Dict[str, float]:
        """{stage: seconds}; on CUDA this waits for the frame's last mark."""
        if self.cuda and self.spans:
            self.last.synchronize()
        out = {}
        for stage, a, b in self.spans:
            dt = a.elapsed_time(b) * 1e-3 if self.cuda else b - a
            out[stage] = out.get(stage, 0.0) + dt
        return out


class StatsWindow:
    """Rolling frame-time statistics: average, median, 1% low and 0.1% low
    over the last `window` frames, the first frame's time (a new process's
    warm-up and the first capture land there), and per-stage averages over
    all frames."""

    def __init__(self, window: int = 2000):
        self.window = window
        self.samples: deque[float] = deque(maxlen=window)
        self.stage_sums: Dict[str, float] = {}
        self.frames = 0
        self.first = None  # the first frame's seconds
        # per-frame stage seconds of the fused frame (Engine.profile_stages),
        # and whether CUDA events ("device") or the CPU's clock ("host")
        # timed them; when set, summary() reports them as *_dev_ms or
        # *_host_ms beside the (zero) stage averages
        self.profiled_stages: Dict[str, float] = {}
        self.profiled_on = "device"

    def add(self, stats: FramePerfStats) -> None:
        self.samples.append(stats.frame_time)
        if self.first is None:
            self.first = stats.frame_time
        self.frames += 1
        for k in ("step_time", "worldline_time", "render_time"):
            self.stage_sums[k] = self.stage_sums.get(k, 0.0) + getattr(stats, k)

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {}
        arr = np.sort(np.asarray(self.samples))
        n = len(arr)
        worst_1pct = arr[-max(1, n // 100):]
        worst_01pct = arr[-max(1, n // 1000):]
        out = {
            "frame_avg_ms": float(arr.mean() * 1e3),
            "frame_last_ms": float(self.samples[-1] * 1e3),
            "frame_median_ms": float(np.median(arr) * 1e3),
            "frame_first_ms": float(self.first * 1e3),
            "low_1pct_ms": float(worst_1pct.mean() * 1e3),
            "low_01pct_ms": float(worst_01pct.mean() * 1e3),
            "fps_avg": float(1.0 / max(arr.mean(), 1e-9)),
        }
        for k, v in self.stage_sums.items():
            out[f"{k.removesuffix('_time')}_avg_ms"] = float(v / max(self.frames, 1) * 1e3)
        if self.profiled_stages:
            suffix = "dev" if self.profiled_on == "device" else "host"
            for k, v in self.profiled_stages.items():
                out[f"{k}_{suffix}_ms"] = float(v * 1e3)
            out["stage_source"] = "profile_stages"
        return out
