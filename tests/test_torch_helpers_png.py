"""The PNG reader at every legal colour type and bit depth, plain and
Adam7-interlaced, against pillow's `convert("RGB")`; the public helpers
`scene.two_blob_collision_scene`, `scene.single_blob_scene`,
`relativity.velocity_addition_2d`, `relativity.aberrate_direction` and
`Engine.step_physics` against their JAX counterparts on seeded inputs.

The PNG bytes are written by the test itself (`_encode`), with every
scanline filter and the seven Adam7 passes, since pillow writes neither
sub-byte gray nor interlaced files; pillow is the oracle that reads them.
"""

import dataclasses
import io
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import relativity as jrel
from spacetime_tpu import scene as jscene
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import relativity as rel
from spacetime_tpu_torch import scene
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config, png

Image = pytest.importorskip("PIL.Image")

# elementwise f32 maths in another order (tests/test_relativity.py's bounds)
RTOL, ATOL = 1e-6, 1e-7
# positions after a few steps: the same physics in another f32 order
# (tests/test_torch_engine.py)
POS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the Engines here run many small ops beside the
    suite's other workers (tests/test_torch_io.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
LEGAL = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
         (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One scanline's samples as bytes: big-endian 16-bit, bytes, or
    sub-byte samples packed MSB first and padded to a byte."""
    s = samples.reshape(-1).astype(np.uint32)
    if depth == 16:
        return s.astype(">u2").tobytes()
    if depth == 8:
        return s.astype(np.uint8).tobytes()
    bits = np.zeros(len(s) * depth, np.uint8)
    for k in range(depth):
        bits[k::depth] = (s >> (depth - 1 - k)) & 1
    return np.packbits(bits).tobytes()


def _filter(line: bytes, prev: bytes, ftype: int, bpp: int) -> bytes:
    """`line` filtered with PNG filter `ftype` against the row above."""
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 0xFF
    return bytes(out)


def _scanlines(samples: np.ndarray, depth: int, first_filter: int) -> bytes:
    """The filtered scanlines of one (sub)image, the filter types cycling
    through all five from `first_filter`; an empty image has none."""
    h, w, c = samples.shape
    if h == 0 or w == 0:
        return b""
    bpp = max(1, c * depth // 8)
    prev = bytes(len(_pack_row(samples[0], depth)))
    out = []
    for y in range(h):
        line = _pack_row(samples[y], depth)
        ftype = (first_filter + y) % 5
        out.append(bytes([ftype]) + _filter(line, prev, ftype, bpp))
        prev = line
    return b"".join(out)


def _encode(samples: np.ndarray, depth: int, ctype: int, interlace: int,
            palette=None) -> bytes:
    """PNG bytes of (H, W, channels) samples, plain or Adam7."""
    h, w, _ = samples.shape
    if interlace:
        raw = b"".join(_scanlines(samples[y0::dy, x0::dx], depth, p)
                       for p, (x0, y0, dx, dy) in enumerate(ADAM7))
    else:
        raw = _scanlines(samples, depth, 0)
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                                      interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
        out += _chunk(b"tRNS", bytes([7, 200]))
    idat = zlib.compress(raw)
    half = len(idat) // 2  # two IDAT chunks
    return (out + _chunk(b"IDAT", idat[:half]) + _chunk(b"IDAT", idat[half:])
            + _chunk(b"IEND", b""))


def _case(ctype: int, depth: int, interlace: int) -> bytes:
    """A seeded 13 x 11 image (a width that pads every sub-byte row, sizes
    that leave no Adam7 pass empty) of random samples; 16-bit samples
    include the edges 0, 1, 255, 256 and 65535."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    h, w, c = 11, 13, CHANNELS[ctype]
    top = 1 << depth
    samples = rng.integers(0, top, (h, w, c), dtype=np.int64)
    if depth == 16:
        samples.reshape(-1)[:5] = [0, 1, 255, 256, 65535]
    palette = None
    if ctype == 3:
        n_colors = min(top, 256) - (1 if depth > 1 else 0)  # an index past PLTE reads black
        palette = rng.integers(0, 256, (n_colors, 3))
    return _encode(samples, depth, ctype, interlace, palette)


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", LEGAL, ids=[f"type{c}_{d}bit" for c, d in LEGAL])
def test_read_png_equals_pillow_at_every_depth(ctype, depth, interlace, tmp_path):
    data = _case(ctype, depth, interlace)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    ours = png.read_png(path)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert ours.dtype == np.uint8 and ours.shape == ref.shape == (11, 13, 3)
    np.testing.assert_array_equal(ours, ref)


def test_read_png_of_pillows_own_16_bit_gray_and_1_bit_mask():
    """Files pillow writes itself: 16-bit gray clips to 255 ([0, 1, 255,
    256, 65535] reads [0, 1, 255, 255, 255]), and a 1-bit mask (the
    natural file for a softbody shape) lights its pixels."""
    buf = io.BytesIO()
    gray = np.array([[0, 1, 255, 256, 65535]], np.uint16)
    Image.fromarray(gray).save(buf, "PNG")
    ours = png.decode_png(buf.getvalue())
    np.testing.assert_array_equal(ours[0, :, 0], [0, 1, 255, 255, 255])
    np.testing.assert_array_equal(ours, np.asarray(Image.open(buf).convert("RGB")))
    mask = np.zeros((8, 8), bool)
    mask[2:6, 1:7] = True
    buf = io.BytesIO()
    Image.fromarray(mask).save(buf, "PNG")
    assert struct.unpack(">IIB", buf.getvalue()[16:25])[2] == 1  # 1-bit
    ours = png.decode_png(buf.getvalue())
    np.testing.assert_array_equal(ours.any(-1), mask)
    body = scene.image_to_softbody(ours, 0, (0.0, 0.0), (0.0, 0.0))
    ref = jscene.image_to_softbody(np.asarray(Image.open(buf).convert("RGB")), 0,
                                   (0.0, 0.0), (0.0, 0.0))
    for k in body:
        np.testing.assert_array_equal(body[k], np.asarray(ref[k]), err_msg=k)


# --------------------------------------------------------------------------
# scene and relativity helpers
# --------------------------------------------------------------------------


def _same_particles(ours, ref):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f.name)


def test_two_blob_collision_scene_matches_jax():
    (p, o), (jp, jo) = (scene.two_blob_collision_scene(radius_px=10, capacity=1024, device="cpu"),
                        jscene.two_blob_collision_scene(radius_px=10, capacity=1024))
    _same_particles(p, jp)
    _same_particles(o, jo)
    # tests/test_scene.py:77's counts
    assert int(p.active.sum()) == 2 * scene.disc_mask(10).sum()
    assert set(p.object_index[p.active].tolist()) == {0, 1}


def test_single_blob_scene_matches_jax():
    (p, o), (jp, jo) = (scene.single_blob_scene(count=300, vel=(0.2, -0.1), device="cpu"),
                        jscene.single_blob_scene(count=300, vel=(0.2, -0.1)))
    _same_particles(p, jp)
    _same_particles(o, jo)
    assert p.capacity % 256 == 0 and abs(int(p.active.sum()) - 300) < 30


def _vel_cases():
    """tests/test_relativity.py's velocity-addition cases, then seeded
    random pairs below c and a zero frame velocity among them."""
    rng = np.random.default_rng(1)
    u = rng.uniform(-0.99, 0.99, (64, 2)).astype(np.float32) * 0.7
    v = rng.uniform(-0.99, 0.99, (64, 2)).astype(np.float32) * 0.7
    v[5] = 0.0
    fixed_u = np.array([[0.5, 0.0], [0.3, -0.2], [0.0, 0.5]], np.float32)
    fixed_v = np.array([[0.5, 0.0], [0.0, 0.0], [0.6, 0.0]], np.float32)
    return np.concatenate([fixed_u, u]), np.concatenate([fixed_v, v])


def test_velocity_addition_2d_matches_jax():
    u, v = _vel_cases()
    ours = rel.velocity_addition_2d(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    ref = np.asarray(jrel.velocity_addition_2d(jnp.asarray(u), jnp.asarray(v)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    # the closed forms of tests/test_relativity.py:40-79
    np.testing.assert_allclose(ours[0], [0.8, 0.0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(ours[1], u[1], atol=ATOL)
    np.testing.assert_allclose(ours[2], [0.6, 0.4], rtol=RTOL, atol=ATOL)
    assert np.all(np.linalg.norm(ours, axis=-1) < 1.0)
    np.testing.assert_array_equal(ours[3 + 5], u[3 + 5])  # v = 0: u itself


def test_aberrate_direction_matches_jax():
    rng = np.random.default_rng(2)
    theta = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    d = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    v = (rng.uniform(-1, 1, (64, 2)) * 0.6).astype(np.float32)
    v[0] = (0.6, 0.0)
    d[0] = (0.0, 1.0)
    ours = rel.aberrate_direction(torch.from_numpy(d), torch.from_numpy(v)).numpy()
    ref = np.asarray(jrel.aberrate_direction(jnp.asarray(d), jnp.asarray(v)))
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL)
    # tests/test_relativity.py:83: a transverse ray tilts toward the motion
    assert ours[0, 0] > 0.0
    np.testing.assert_allclose(np.linalg.norm(ours, axis=-1), 1.0, rtol=RTOL)


# --------------------------------------------------------------------------
# Engine.step_physics
# --------------------------------------------------------------------------


def _tiny(mod, rp, **kw):
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
        render=rp(num_rays=256), width=48, height=48, history=32, steps_per_frame=2)
    base.update(kw)
    return mod.EngineConfig(**base)


def test_step_physics_then_run_frame_equals_run_frames():
    """A frame's ticks through step_physics, then a fused frame, give the
    bits of two fused frames: state, ring (cursor, times) and image."""
    a = Engine(_tiny(config, rt.RenderParams), device="cpu")
    b = Engine(_tiny(config, rt.RenderParams), device="cpu")
    for _ in range(2):
        a.run_frame()
    img_a = a.run_frame()
    b.run_frame()
    b.paused = True  # step_physics steps even while paused
    b.step_physics()
    b.paused = False
    img_b = b.run_frame()
    assert torch.equal(img_a, img_b)
    assert a.time == b.time
    for x, y in ((a.particles, b.particles), (a.worldline, b.worldline)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            assert (u is None and v is None) or torch.equal(u, v), f.name
    assert int(b.last_aux.bonds_broken) >= 0 and b.graph_stats["eager"] == 0


def test_step_physics_matches_jax():
    """Three step_physics calls from the same scene: positions, the ring's
    clock and cursor as the JAX Engine leaves them."""
    je = JEngine(_tiny(jconfig, jrt.RenderParams))
    pe = Engine(_tiny(config, rt.RenderParams), device="cpu")
    for _ in range(3):
        je.step_physics()
        pe.step_physics()
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act],
                               np.asarray(je.particles.pos)[act], rtol=0, atol=POS_ATOL)
    assert pe.time == pytest.approx(je.time, abs=1e-12) and pe.frame == je.frame == 0
    assert int(pe.worldline.cursor) == int(je.worldline.cursor)
    np.testing.assert_array_equal(pe.worldline.times.numpy(), np.asarray(je.worldline.times))
    # the next fused frame reads the same state as JAX's
    img, jimg = pe.run_frame().numpy(), np.asarray(je.run_frame())
    assert np.mean(np.abs(img - jimg).max(axis=-1) > 1e-3) <= 1e-3
