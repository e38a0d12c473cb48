"""Key handling and the optional interactive viewer (counterpart of
`spacetime_tpu/viewer.py`).

The reference is an interactive window with a stats overlay, WASD/zx/p
controls and a live-editable max-FPS setting (reference: src/main.rs,
src/debugui.rs:9-23 HotswapConfig, src/keyboard.rs).  `apply_key` maps key
events onto an Engine's key dict and live settings; the CLI's `--serve`
feeds it the keys a browser posts to the live view, and `run_viewer` the
keys of a matplotlib window where matplotlib is installed (it is imported
only there).

Controls: a/d/w/s pan, z/x zoom, p pause, q quit, +/- raise/lower the live
max-FPS target, [/] and {/} spin the 3D spacetime view (worldline3d mode
only), o toggle the camera-frame (boosted observer) view (retarded mode).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

AZ_STEP, EL_STEP = 0.2, 0.15  # worldline3d spin steps (rad)


def _snap(x: float, step: float) -> float:
    return round(round(x / step) * step, 10)


def apply_key(keys: dict, engine, key: Optional[str], down: bool) -> None:
    """Map one key event into the engine's key dict / hotswap settings
    (reference: keyboard.rs:3-45 booleans + debugui.rs editable max-FPS).
    Accepts matplotlib names ('a', 'left') and browser KeyboardEvent.key
    names ('ArrowLeft'), which the live view's /key endpoint forwards
    verbatim (utils/streamsink.py poll_keys)."""
    if key in ("a", "left", "ArrowLeft"):
        keys["left"] = down
    elif key in ("d", "right", "ArrowRight"):
        keys["right"] = down
    elif key in ("w", "up", "ArrowUp"):
        keys["up"] = down
    elif key in ("s", "down", "ArrowDown"):
        keys["down"] = down
    elif key in ("z", "x"):
        keys[key] = down
    elif key == "p" and down:
        keys["p"] = True
    elif key == "q" and down:
        keys["quit"] = True
    elif key in ("+", "=") and down:
        engine.hotswap["max_fps"] = min(engine.hotswap["max_fps"] * 1.25, 1000.0)
    elif key == "-" and down:
        engine.hotswap["max_fps"] = max(engine.hotswap["max_fps"] / 1.25, 1.0)
    elif (key == "o" and down and engine.config.render_mode == "retarded"
          and engine.config.render.retarded):
        # the camera-frame view is part of the render params, so it keys the
        # fused cache: flipping back replays the frame captured before
        r = engine.config.render
        engine.config = dataclasses.replace(
            engine.config, render=dataclasses.replace(r, camera_frame=not r.camera_frame))
    elif key in ("[", "]", "{", "}") and down and engine.config.render_mode == "worldline3d":
        # azimuth [ ], elevation { }.  The view keys the fused cache, so the
        # angles snap to exact step multiples and the azimuth wraps mod 2 pi:
        # after a full turn (or a backtrack) the value repeats bit-exactly
        # and the frame captured for it is replayed
        w = engine.config.wl3d
        if key in ("[", "]"):
            az = w.azimuth + (AZ_STEP if key == "]" else -AZ_STEP)
            w = dataclasses.replace(w, azimuth=_snap(az % (2 * math.pi), AZ_STEP))
        elif key == "{":
            w = dataclasses.replace(w, elevation=_snap(max(w.elevation - EL_STEP, 0.0), EL_STEP))
        else:
            w = dataclasses.replace(
                w, elevation=_snap(min(w.elevation + EL_STEP, math.pi / 2), EL_STEP))
        engine.config = dataclasses.replace(engine.config, wl3d=w)


def run_viewer(
    engine,
    max_frames: Optional[int] = None,
    script: Optional[Callable[[int], list]] = None,
    show: bool = True,
    stream_port: Optional[int] = None,
    stream_bind: str = "127.0.0.1",
    overlay: bool = True,
) -> int:
    """Interactive loop in a matplotlib window (Agg with `show=False`);
    raises RuntimeError where matplotlib is not installed.
    `script(frame) -> [(key, down), ...]` injects key events each frame.
    `stream_port` also serves the live view as MJPEG over HTTP
    (utils/streamsink.py; 0 = any free port).  Returns the number of frames
    rendered."""
    try:
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots(figsize=(8, 8))
        if show:
            fig.canvas.manager.set_window_title("spacetime_tpu_torch")
    except Exception as exc:  # no matplotlib, or no backend at all
        raise RuntimeError(
            "no matplotlib backend available; use `python -m spacetime_tpu_torch "
            "--out DIR` to write PNG frames or `--serve PORT` for the live view instead"
        ) from exc

    keys: dict = {}
    fig.canvas.mpl_connect("key_press_event", lambda e: apply_key(keys, engine, e.key, True))
    fig.canvas.mpl_connect("key_release_event", lambda e: apply_key(keys, engine, e.key, False))

    stream = None
    arr0 = engine.run_frame().cpu().numpy()
    im = ax.imshow(arr0)
    ax.set_axis_off()
    title = ax.set_title("")
    frame = 0
    try:  # the stream server and the figure go even if a frame raises
        if stream_port is not None:
            from .utils.streamsink import StreamSink

            stream = StreamSink(stream_port, arr0.shape[1], arr0.shape[0], bind=stream_bind)
            tok = f"?t={stream.key_token}" if stream.key_token else ""
            print(f"# live view: http://{stream_bind}:{stream.port}/{tok}")
        if show:
            plt.ion()
            plt.show()
        while not keys.get("quit"):
            if script is not None:
                for key, down in script(frame):
                    apply_key(keys, engine, key, down)
            arr = engine.run_frame(keys=dict(keys)).cpu().numpy()
            keys.pop("p", None)
            if stream is not None:
                if overlay:
                    from .utils.overlay import overlay_stats

                    stream.submit(overlay_stats(arr, engine))
                else:
                    stream.submit(arr)
            im.set_data(arr)
            summary = engine.stats.summary()
            title.set_text(
                f"frame {engine.frame}  {summary.get('fps_avg', 0):.1f} fps avg  "
                f"1% low {summary.get('low_1pct_ms', 0):.1f} ms  "
                f"max_fps {engine.hotswap['max_fps']:.0f}"
                + ("  [paused]" if engine.paused else ""))
            fig.canvas.draw_idle()
            if show:
                plt.pause(max(0.001, 1.0 / engine.hotswap["max_fps"]))
            frame += 1
            if max_frames is not None and frame >= max_frames:
                break
    finally:
        plt.close(fig)
        if stream is not None:
            stream.close()
    return frame
