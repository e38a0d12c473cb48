"""Stats overlay drawn onto outgoing frames (counterpart of
`spacetime_tpu/utils/overlay.py`).

The reference draws an egui "Debug UI" window over every swapchain image:
frame-duration minimum, last and average frame time, 1% and 0.1% lows,
the per-stage times and the live max-FPS setting (reference:
src/debugui.rs:55-103).  The headless analog composites the same panel
onto the frames served over MJPEG (`--serve`).  `stats_lines` gives the
JAX package's text and `composite` its compositing (the panel box darkened
by _BG_ALPHA, the glyph mask alpha-blended, heading rows tinted); the glyph
mask comes from a built-in 5x7 bitmap font (pillow's default font, which
the JAX package rasterizes with, is not a dependency of this package).
Everything runs on the host copy of the frame.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

import numpy as np

# panel styling (egui's default dark theme, approximately)
_FG = np.array([230, 230, 230], dtype=np.uint16)
_HEADING = np.array([255, 214, 120], dtype=np.uint16)
_BG_ALPHA = 0.62
_PAD = 6

# 5x7 glyphs of ASCII 32-126 (8 rows with descenders), five column bytes
# each, bit 0 the top row
_GLYPHS = (
    "0000000000 00005f0000 0007000700 147f147f14 242a7f2a12 2313086462 3649562050 "
    "0008070300 001c224100 0041221c00 2a1c7f1c2a 08083e0808 0080703000 0808080808 "
    "0000606000 2010080402 3e5149453e 00427f4000 7249494946 2141494d33 1814127f10 "
    "2745454539 3c4a494931 4121110907 3649494936 464949291e 0000140000 0040340000 "
    "0008142241 1414141414 0041221408 0201590906 3e415d594e 7c1211127c 7f49494936 "
    "3e41414122 7f4141413e 7f49494941 7f09090901 3e41415173 7f0808087f 00417f4100 "
    "2040413f01 7f08142241 7f40404040 7f021c027f 7f0408107f 3e4141413e 7f09090906 "
    "3e4151215e 7f09192946 2649494932 03017f0103 3f4040403f 1f2040201f 3f4038403f "
    "6314081463 0304780403 6159494d43 007f414141 0204081020 004141417f 0402010204 "
    "4040404040 0003070800 2054547840 7f28444438 3844444428 384444287f 3854545418 "
    "00087e0902 18a4a49c78 7f08040478 00447d4000 2040403d00 7f10284400 00417f4000 "
    "7c04780478 7c08040478 3844444438 fc18242418 18242418fc 7c08040408 4854545424 "
    "04043f4424 3c4040207c 1c2040201c 3c4030403c 4428102844 4c9090907c 4464544c44 "
    "0008364100 0000770000 0041360800 0201020402"
)
# (95, 8 rows, 5 columns) 0/255 glyph raster of the characters ' '..'~'
_FONT = (np.unpackbits(np.frombuffer(bytes.fromhex(_GLYPHS.replace(" ", "")), np.uint8)
                       .reshape(95, 5, 1), axis=2, bitorder="little")
         .transpose(0, 2, 1) * 255).astype(np.uint8)
_CELL_W, _GLYPH_H = 6, 8  # a glyph and its one-column gap; rows with descenders


def _render_lines(lines: Iterable[str]) -> Tuple[np.ndarray, int]:
    """Rasterize text lines to ((H, W) uint8 mask, line height in px) with
    the built-in font at 1x (characters outside ASCII 32-126 draw as '?')."""
    lines = [ln if ln else " " for ln in lines]
    line_h = _GLYPH_H + 2
    mask = np.zeros((line_h * len(lines), max(len(ln) for ln in lines) * _CELL_W + 1), np.uint8)
    for i, ln in enumerate(lines):
        for j, ch in enumerate(ln):
            code = ord(ch) - 32 if 32 <= ord(ch) <= 126 else ord("?") - 32
            mask[i * line_h:i * line_h + _GLYPH_H, j * _CELL_W:j * _CELL_W + 5] = _FONT[code]
    return mask, line_h


def composite(arr: np.ndarray, mask: np.ndarray, line_h: int, origin=(8, 8),
              scale: int = 1, heading_rows: int = 1) -> np.ndarray:
    """Composite a panel with the glyph `mask` ((h, w) uint8, `line_h` px a
    line) onto a frame, as the JAX package's draw_overlay does.

    `arr` is (H, W, 3) uint8 or float [0, 1]; returns a NEW uint8 array (the
    input may be the Engine's frame).  The first `heading_rows` lines are
    tinted like egui window titles; the panel is clipped to the frame."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        a = (np.clip(a, 0.0, 1.0) * 255.0).astype(np.uint8)
    out = a.copy()
    if scale > 1:
        mask = np.kron(mask, np.ones((scale, scale), dtype=np.uint8))
        line_h *= scale
    y0, x0 = origin
    h = min(mask.shape[0] + 2 * _PAD, out.shape[0] - y0)
    w = min(mask.shape[1] + 2 * _PAD, out.shape[1] - x0)
    if h <= 0 or w <= 0:
        return out
    # darken the panel box (egui's translucent window background)
    box = out[y0:y0 + h, x0:x0 + w, :].astype(np.uint16)
    out[y0:y0 + h, x0:x0 + w, :] = (box * int((1 - _BG_ALPHA) * 256) >> 8).astype(np.uint8)
    # alpha-blend the glyph mask, heading lines tinted
    mh = min(mask.shape[0], h - _PAD)
    mw = min(mask.shape[1], w - _PAD)
    if mh <= 0 or mw <= 0:
        return out
    m = mask[:mh, :mw, None].astype(np.uint16)
    color = np.broadcast_to(_FG, (mh, mw, 3)).copy()
    color[:min(heading_rows * line_h, mh)] = _HEADING
    ys, xs = slice(y0 + _PAD, y0 + _PAD + mh), slice(x0 + _PAD, x0 + _PAD + mw)
    region = out[ys, xs, :].astype(np.uint16)
    out[ys, xs, :] = ((region * (255 - m) + color * m) // 255).astype(np.uint8)
    return out


def draw_overlay(arr: np.ndarray, lines: List[str], origin=(8, 8), scale: int = 1,
                 heading_rows: int = 1) -> np.ndarray:
    """Composite a stats panel of `lines` onto a frame (see `composite`)."""
    mask, line_h = _render_lines(lines)
    return composite(arr, mask, line_h, origin, scale, heading_rows)


def stats_lines(engine) -> List[str]:
    """The debug-UI panel text for one frame (reference: debugui.rs:64-83
    labels, plus the per-stage times and the render settings)."""
    s = engine.stats.summary()
    max_fps = max(float(engine.hotswap["max_fps"]), 1e-3)  # the pacing loop's guard
    lines = [
        "Profiling",
        f"Frame Duration Minimum: {1000.0 / max_fps:.2f}ms (max fps {max_fps:.0f})",
        f"Last Frame Time: {s.get('frame_last_ms', 0.0):.2f}ms",
        f"Average: {s.get('frame_avg_ms', 0.0):.2f}ms"
        f" ({s.get('fps_avg', 0.0):.1f} fps)",
        f"1% low: {s.get('low_1pct_ms', 0.0):.2f}ms"
        f"   0.1% low: {s.get('low_01pct_ms', 0.0):.2f}ms",
    ]
    # per-stage times: eager stage times, or profile_stages' device times
    stage = {
        k.removesuffix("_avg_ms").removesuffix("_dev_ms"): v
        for k, v in s.items()
        if (k.endswith("_avg_ms") or k.endswith("_dev_ms")) and not k.startswith("frame")
    }
    parts = [f"{name} {stage[name]:.2f}ms" for name in ("step", "worldline", "render")
             if stage.get(name)]
    if parts:
        lines.append("Stages: " + "  ".join(parts))
    # the active count is a device-to-host read; it changes rarely (bond
    # breaking only detaches), so it is refreshed every 30 frames
    cache = getattr(engine, "_overlay_nactive", None)
    if cache is None or engine.frame - cache[0] >= 30:
        cache = (engine.frame, int(engine.particles.active.sum()))
        engine._overlay_nactive = cache
    lines.append(f"frame {engine.frame}  particles {cache[1]}  mode {engine.config.render_mode}"
                 + ("  [paused]" if engine.paused else ""))
    return lines


def overlay_stats(arr: np.ndarray, engine, scale: int = 1) -> np.ndarray:
    """One-call helper: frame + engine -> frame with the debug panel."""
    return draw_overlay(arr, stats_lines(engine), scale=scale)
