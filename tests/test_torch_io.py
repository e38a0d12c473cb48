"""The port's I/O layer on the CPU against the JAX package and pillow: the
PNG reader (utils/png.py) against pillow's decoder, `image_to_softbody` on
the fixtures, `save_png` and the FrameSink (native and Python paths), the
StreamSink (native where it builds, and Python, over loopback sockets with
short timeouts), the overlay's text and compositing, `viewer.apply_key`,
and every module of the slice with pillow and matplotlib blocked."""

import builtins
import http.client
import importlib
import io
import math
import os
import struct
import sys
import time
import types
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from spacetime_tpu import scene as jscene
from spacetime_tpu import viewer as jviewer
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.engine import save_png as jsave_png
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu.utils import framesink as jframesink
from spacetime_tpu.utils import overlay as joverlay
from spacetime_tpu_torch import scene, viewer
from spacetime_tpu_torch.engine import Engine, save_png
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config, framesink, jpeg, native, overlay, png, streamsink

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = [os.path.join(ROOT, "assets", "fixtures", f) for f in ("blob_a.png", "blob_b.png")]
TIMEOUT = 5.0  # every client socket's timeout, seconds


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The Engines here run thousands of small torch ops; beside the
    suite's other workers each op's intra-op thread team waits on busy
    cores.  One thread a worker keeps their time that of the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frame(h=30, w=40, seed=0):
    """A smooth float frame in [0, 1] with a few pixels out of range (the
    sinks clip)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    f = np.stack([xx / w, yy / h, 0.5 + 0.4 * np.sin(xx / 5.0)], -1).astype(np.float32)
    f[0, 0] = [1.5, -0.2, 0.5]
    return f + rng.normal(0, 0.01, f.shape).astype(np.float32)


def _u8(f):
    return (np.clip(f, 0.0, 1.0) * 255.0).astype(np.uint8)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


# --------------------------------------------------------------------------
# PNG reader
# --------------------------------------------------------------------------


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_read_png_fixture_equals_pillow(path):
    ours = png.read_png(path)
    assert ours.shape == (64, 64, 3) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, np.asarray(Image.open(path).convert("RGB")))


def _pil_png(mode: str, optimize: bool, trns: bool = False) -> bytes:
    """A PNG that pillow writes from a seeded noise image in `mode` (noise
    makes pillow's adaptive filtering choose every filter type)."""
    rng = np.random.default_rng(hash((mode, trns)) % 2**32)
    arr = rng.integers(0, 256, (23, 37, 4), dtype=np.uint8)
    if mode == "P":
        im = Image.fromarray(arr[..., 0], "L").convert("P")
        if trns:
            im.info["transparency"] = 7
    else:
        im = Image.fromarray(arr, "RGBA").convert(mode)
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=optimize)
    return buf.getvalue()


PIL_CASES = [(m, o, False) for m in ("L", "RGB", "RGBA", "LA", "P") for o in (False, True)] + [
    ("P", o, True) for o in (False, True)]


@pytest.mark.parametrize("mode,optimize,trns", PIL_CASES)
def test_read_png_equals_pillow(mode, optimize, trns, tmp_path):
    data = _pil_png(mode, optimize, trns)
    assert (b"tRNS" in data) == trns
    path = tmp_path / "x.png"
    path.write_bytes(data)
    np.testing.assert_array_equal(png.read_png(path), _pil(data))


def _filter_types(data: bytes) -> set:
    chunks = dict(png._chunks(data))
    w, h, _, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    idat = b"".join(p for k, p in png._chunks(data) if k == b"IDAT")
    raw = zlib.decompress(idat)
    stride = w * png._CHANNELS[ctype] + 1
    return {raw[y * stride] for y in range(h)}


def test_pillow_cases_cover_every_filter_and_many_idat_chunks():
    seen = set()
    for case in PIL_CASES:
        seen |= _filter_types(_pil_png(*case))
    assert seen == {0, 1, 2, 3, 4}
    # the same image split over several IDAT chunks decodes the same
    data = _pil_png("RGB", True)
    chunks = list(png._chunks(data))
    idat = b"".join(p for k, p in chunks if k == b"IDAT")
    parts = [idat[i:i + 97] for i in range(0, len(idat), 97)]
    split = png.SIGNATURE + png._chunk(b"IHDR", dict(chunks)[b"IHDR"]) + b"".join(
        png._chunk(b"IDAT", p) for p in parts) + png._chunk(b"IEND", b"")
    assert len(parts) > 3
    np.testing.assert_array_equal(png.decode_png(split), _pil(data))


@pytest.mark.parametrize("depth,ctype,interlace,match", [
    (16, 3, 0, "bit depth 16"), (4, 2, 0, "bit depth 4"), (2, 4, 0, "bit depth 2"),
    (8, 2, 2, "interlace method 2"), (8, 5, 0, "colour type 5")])
def test_read_png_refuses_what_it_does_not_support(depth, ctype, interlace, match):
    """A header that names a bit depth its colour type does not allow, an
    unknown interlace method or colour type raises before any pixel is
    read (every legal depth and Adam7 decode: tests/test_torch_helpers_png.py)."""
    ihdr = struct.pack(">IIBBBBB", 9, 9, depth, ctype, 0, 0, interlace)
    data = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(bytes(9 * 60))) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


@pytest.mark.parametrize("path", FIXTURES, ids=os.path.basename)
def test_image_to_softbody_matches_jax(path):
    ours = scene.image_to_softbody(path, 1, (0.25, 0.3), (0.12, 0.12), lattice_pad=True)
    ref = jscene.image_to_softbody(path, 1, (0.25, 0.3), (0.12, 0.12), lattice_pad=True)
    assert ours.keys() == ref.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], np.asarray(ref[k]), err_msg=k)


# --------------------------------------------------------------------------
# PNG writers: save_png and the FrameSink
# --------------------------------------------------------------------------


def test_save_png_decodes_to_the_frame_and_to_jax_pixels(tmp_path):
    f = _frame()
    save_png(str(tmp_path / "ours.png"), torch.from_numpy(f))
    jsave_png(str(tmp_path / "jax.png"), f)
    ours = np.asarray(Image.open(tmp_path / "ours.png"))
    np.testing.assert_array_equal(ours, _u8(f))
    np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "jax.png")))


@pytest.mark.parametrize("path", ["native", "python"])
def test_framesink_writes_the_frames_jax_writes(path, tmp_path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(framesink, "_load", lambda: None)
    elif framesink._load() is None:
        pytest.skip(f"native frame sink does not build here: {native.build_errors}")
    monkeypatch.setattr(jframesink, "_load", lambda: None)  # JAX's PIL path, no make
    frames = {i: _frame(seed=i) for i in (0, 3, 12)}
    with framesink.FrameSink(str(tmp_path / "ours"), 40, 30) as sink:
        assert sink.native == (path == "native")
        for i, f in frames.items():
            sink.submit(i, torch.from_numpy(f) if i == 3 else f)
    with jframesink.FrameSink(str(tmp_path / "jax"), 40, 30) as jsink:
        for i, f in frames.items():
            jsink.submit(i, f)
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "jax")) == [
        "frame_00000000.png", "frame_00000003.png", "frame_00000012.png"]
    for name, f in zip(names, frames.values()):
        ours = np.asarray(Image.open(tmp_path / "ours" / name))
        np.testing.assert_array_equal(ours, _u8(f))
        np.testing.assert_array_equal(ours, np.asarray(Image.open(tmp_path / "jax" / name)))


def test_framesink_refuses_a_frame_of_another_size(tmp_path, monkeypatch):
    monkeypatch.setattr(framesink, "_load", lambda: None)
    with framesink.FrameSink(str(tmp_path), 40, 30) as sink:
        with pytest.raises(ValueError, match="sink expects"):
            sink.submit(0, np.zeros((30, 41, 3), np.float32))
        assert sink.pending() == 0


# --------------------------------------------------------------------------
# StreamSink
# --------------------------------------------------------------------------


def _sink(path, monkeypatch, **kw):
    if path == "python":
        monkeypatch.setattr(streamsink, "_load", lambda: None)
    elif streamsink._load() is None:
        pytest.skip(f"native stream sink does not build here: {native.build_errors}")
    sink = streamsink.StreamSink(0, 40, 30, **kw)
    assert sink.native == (path == "native")
    return sink


def _get(port, target):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("GET", target)
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def read_part(port):
    """The first JPEG part of /stream: (Content-Type, JPEG bytes)."""
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        c.request("GET", "/stream")
        r = c.getresponse()
        assert r.fp.readline().strip() == b"--spacetimeframe"
        headers = {}
        while (line := r.fp.readline().strip()):
            k, v = line.decode().split(":", 1)
            headers[k.strip().lower()] = v.strip()
        assert headers["content-type"] == "image/jpeg"
        return r.getheader("Content-Type"), r.fp.read(int(headers["content-length"]))
    finally:
        c.close()


@pytest.mark.parametrize("path", ["native", "python"])
def test_streamsink_serves_the_page_the_stream_and_keys(path, monkeypatch):
    f = _frame()
    with _sink(path, monkeypatch) as sink:
        assert sink.key_token == "" and sink.port > 0
        status, body = _get(sink.port, "/")
        assert status == 200 and b"/stream" in body
        sink.submit(f)
        ctype, data = read_part(sink.port)
        assert ctype == "multipart/x-mixed-replace; boundary=spacetimeframe"
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
        dec = _pil(data).astype(np.float64)
        psnr = 10 * np.log10(255.0 ** 2 / np.mean((dec - _u8(f)) ** 2))
        assert psnr >= 30.0, psnr
        assert _get(sink.port, "/key?d=1&k=ArrowLeft")[0] == 204
        assert _get(sink.port, "/key?d=0&k=q")[0] == 204
        assert sink.poll_keys() == [("ArrowLeft", True), ("q", False)]
        assert sink.poll_keys() == []
        n = sink.frames_encoded
        sink.submit(f)
        for _ in range(50):  # the native encoder runs on its own thread
            if sink.frames_encoded > n:
                break
            read_part(sink.port)
        assert sink.frames_encoded > n >= 1


@pytest.mark.parametrize("path", ["native", "python"])
def test_streamsink_key_token_gates_keys(path, monkeypatch):
    with _sink(path, monkeypatch, key_token="s3cret") as sink:
        assert _get(sink.port, "/key?d=1&k=a")[0] == 403
        assert _get(sink.port, "/key?d=1&k=a&t=wrong")[0] == 403
        assert _get(sink.port, "/key?d=1&k=a&t=s3cret")[0] == 204
        assert sink.poll_keys() == [("a", True)]


@pytest.mark.parametrize("path", ["native", "python"])
def test_streamsink_non_loopback_bind_makes_its_own_token(path, monkeypatch):
    with _sink(path, monkeypatch, bind="0.0.0.0") as sink:
        tok = sink.key_token
        assert len(tok) >= 12
        assert _get(sink.port, "/key?d=1&k=a")[0] == 403
        assert _get(sink.port, f"/key?d=1&k=a&t={tok}")[0] == 204
        assert sink.poll_keys() == [("a", True)]


def test_jpeg_encoder_quality_and_odd_sizes():
    """Sizes that are not multiples of 8, and a higher quality reads closer."""
    f = _u8(_frame(13, 21))
    errs = []
    for q in (50, 85, 95):
        dec = _pil(jpeg.encode_jpeg(f, q))
        assert dec.shape == f.shape
        errs.append(np.abs(dec.astype(int) - f).mean())
    assert errs[0] > errs[1] > errs[2]
    np.testing.assert_array_equal(jpeg.quant_table(jpeg._LUMA_Q, 50), jpeg._LUMA_Q)


# --------------------------------------------------------------------------
# overlay
# --------------------------------------------------------------------------


def _tiny(mod, **kw):
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
        render=(jrt if mod is jconfig else rt).RenderParams(num_rays=256),
        width=48, height=48, history=32, render_mode="points")
    base.update(kw)
    return mod.EngineConfig(**base)


def test_stats_lines_equal_jax(monkeypatch):
    summary = {"frame_last_ms": 12.345, "frame_avg_ms": 10.5, "fps_avg": 95.2,
               "low_1pct_ms": 20.25, "low_01pct_ms": 31.0, "step_avg_ms": 0.0,
               "worldline_avg_ms": 0.0, "render_avg_ms": 0.0, "step_dev_ms": 1.25,
               "render_dev_ms": 3.5, "frame_median_ms": 9.0}
    je = JEngine(_tiny(jconfig))
    pe = Engine(_tiny(config), device="cpu")
    monkeypatch.setattr(je.stats, "summary", lambda: summary)
    monkeypatch.setattr(pe._stats, "summary", lambda: summary)
    for frame, paused, fps in ((0, False, 72.0), (31, True, 0.0)):
        for e in (je, pe):
            e.frame, e.paused, e.hotswap["max_fps"] = frame, paused, fps
        assert overlay.stats_lines(pe) == joverlay.stats_lines(je)
    assert pe._overlay_nactive == (31, int(pe.particles.active.sum()))


OVERLAY_CASES = [("u8", {}), ("f32", {}), ("u8", {"origin": (20, 50)}),
                 ("f32", {"origin": (5, 90), "scale": 2}), ("u8", {"heading_rows": 2}),
                 ("f32", {"origin": (64, 0)})]


@pytest.mark.parametrize("dtype,kw", OVERLAY_CASES)
def test_composite_is_bit_equal_to_jax_draw_overlay(dtype, kw):
    lines = ["Profiling", "Frame Duration Minimum: 13.89ms (max fps 72)", "",
             "frame 3  particles 50  mode points"]
    f = _frame(64, 100)
    arr = _u8(f) if dtype == "u8" else f
    mask, line_h = joverlay._render_lines(lines)
    before = arr.copy()
    ours = overlay.composite(arr, mask, line_h, **kw)
    np.testing.assert_array_equal(ours, joverlay.draw_overlay(arr, lines, **kw))
    np.testing.assert_array_equal(arr, before)  # the input is not touched


def test_draw_overlay_draws_a_panel_with_the_builtin_font():
    f = np.full((48, 200, 3), 0.5, np.float32)
    out = overlay.draw_overlay(f, ["Profiling", "frame 1"])
    assert out.dtype == np.uint8 and out.shape == f.shape
    panel = out[8:8 + 2 * 10 + 12, 8:8 + 9 * 6 + 13]
    assert (panel < 127).any() and (panel > 200).any()  # darkened box and glyphs
    assert (out[:, 150:] == 127).all()  # outside the panel untouched


# --------------------------------------------------------------------------
# apply_key
# --------------------------------------------------------------------------

KEYS = ["a", "left", "ArrowLeft", "d", "right", "ArrowRight", "w", "up", "ArrowUp", "s",
        "down", "ArrowDown", "z", "x", "p", "q", "+", "=", "-", "o", "[", "]", "{", "}",
        "unknown", None]


@pytest.mark.parametrize("name", ["flagship_1080p", "worldline3d", "boosted_observer"])
def test_apply_key_matches_jax(name):
    """Every key of the table, down and up, then the spin keys past a full
    azimuth turn and the elevation clamps: the key dicts, hotswap, the
    camera-frame flag and the worldline3d angles equal JAX's after each
    event."""
    ours = types.SimpleNamespace(config=config.get_config(name), hotswap={"max_fps": 72.0})
    ref = types.SimpleNamespace(config=jconfig.get_config(name), hotswap={"max_fps": 72.0})
    keys, jkeys = {}, {}
    events = [(k, d) for k in KEYS for d in (True, False)]
    events += [("]", True)] * 33 + [("[", True)] * 5 + [("}", True)] * 12 + [("{", True)] * 14
    events += [("+", True)] * 40 + [("-", True)] * 50 + [("o", True)] * 2
    for key, down in events:
        viewer.apply_key(keys, ours, key, down)
        jviewer.apply_key(jkeys, ref, key, down)
        assert keys == jkeys and ours.hotswap == ref.hotswap, (key, down)
        assert ours.config.render.camera_frame == ref.config.render.camera_frame
        assert (ours.config.wl3d.azimuth, ours.config.wl3d.elevation) == (
            ref.config.wl3d.azimuth, ref.config.wl3d.elevation), (key, down)
    if name == "worldline3d":  # 33 steps of 0.2 pass 2 pi and wrap, snapped
        az = ours.config.wl3d.azimuth
        assert 0 <= az < 2 * math.pi and az == round(round(az / 0.2) * 0.2, 10)
    if name == "flagship_1080p":  # three 'o' presses in all flip the flag
        assert ours.config.render.camera_frame


# --------------------------------------------------------------------------
# no pillow, no matplotlib
# --------------------------------------------------------------------------

SLICE_MODULES = ["spacetime_tpu_torch.utils.png", "spacetime_tpu_torch.utils.jpeg",
                 "spacetime_tpu_torch.utils.native", "spacetime_tpu_torch.utils.framesink",
                 "spacetime_tpu_torch.utils.streamsink", "spacetime_tpu_torch.utils.overlay",
                 "spacetime_tpu_torch.utils.replay", "spacetime_tpu_torch.viewer",
                 "spacetime_tpu_torch.scene", "spacetime_tpu_torch.cli",
                 "spacetime_tpu_torch.bench"]


def test_slice_runs_without_pillow_or_matplotlib(monkeypatch, tmp_path):
    real = builtins.__import__

    def blocked(name, *a, **k):
        if name.split(".")[0] in ("PIL", "matplotlib", "jax", "spacetime_tpu"):
            raise ImportError(f"No module named {name!r}")
        return real(name, *a, **k)

    # fresh copies of the slice's modules, imported under the block; the
    # originals come back into sys.modules and their packages at teardown
    for name in SLICE_MODULES:
        parent, _, leaf = name.rpartition(".")
        monkeypatch.setattr(importlib.import_module(parent), leaf, importlib.import_module(name))
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setattr(builtins, "__import__", blocked)
    mods = {name: importlib.import_module(name) for name in SLICE_MODULES}
    f = _frame()
    rgb = mods["spacetime_tpu_torch.utils.png"].read_png(FIXTURES[0])
    assert rgb.shape == (64, 64, 3)
    body = mods["spacetime_tpu_torch.scene"].image_to_softbody(FIXTURES[1], 0, (0, 0), (0, 0))
    assert body["pos"].shape[0] == int((png.read_png(FIXTURES[1]) != 0).any(-1).sum())
    save_png(str(tmp_path / "s.png"), f)
    fs = mods["spacetime_tpu_torch.utils.framesink"]
    monkeypatch.setattr(fs, "_load", lambda: None)
    with fs.FrameSink(str(tmp_path / "frames"), 40, 30) as sink:
        sink.submit(0, f)
    ss = mods["spacetime_tpu_torch.utils.streamsink"]
    monkeypatch.setattr(ss, "_load", lambda: None)
    with ss.StreamSink(0, 40, 30) as sink:
        sink.submit(mods["spacetime_tpu_torch.utils.overlay"].draw_overlay(f, ["x"]))
        for _ in range(500):  # the encoder thread's first frame
            if sink.frames_encoded:
                break
            time.sleep(0.01)
        assert sink.frames_encoded == 1
    eng = Engine(_tiny(config), device="cpu")
    assert len(mods["spacetime_tpu_torch.utils.overlay"].stats_lines(eng)) >= 6
    with pytest.raises(RuntimeError, match="no matplotlib backend"):
        mods["spacetime_tpu_torch.viewer"].run_viewer(eng, max_frames=1, show=False)
    keys = {}
    mods["spacetime_tpu_torch.viewer"].apply_key(keys, eng, "d", True)
    assert keys == {"right": True}
