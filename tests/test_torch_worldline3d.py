"""The worldline3d view of the port (spacetime_tpu_torch.ops.worldline3d and
the Engine's worldline3d mode) against the JAX package on the CPU.

tests/test_worldline3d.py's hand-built rings with known worldlines: each
case renders in both packages from the same numpy state and is held to the
pixel gate (at most 0.1% of pixels off by more than 1e-3), and to the JAX
test's own closed-form checks (top-down parity with the point rasterizer,
edge-on time extrusion, nearest-wins depth order, age fade, the stride
keeping the newest tick, depth order beyond the zoom range).
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import state as jstate
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.ops import worldline3d as jw3d
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import rasterize
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.ops import worldline3d as w3d
from spacetime_tpu_torch.utils import config

H = 0.005
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
Q = 1.0 / 31 + 1e-6  # 5-bit colour quantization
RED = np.array([1.0, 0.2, 0.2])


def _fields(x):
    return {f: np.asarray(getattr(x, f)) for f in x.__dataclass_fields__
            if getattr(x, f) is not None}


def _particles(rows, capacity=8):
    """rows = [(x, y, vx, vy, obj)]: the JAX Particles."""
    rows = np.asarray(rows, np.float32)
    return jstate.pack_particles(pos=rows[:, 0:2], vel=rows[:, 2:4],
                                 neighbors=np.full((len(rows), 8), -1, np.int32),
                                 object_index=rows[:, 4].astype(np.int32), capacity=capacity)


def _ring(trajectory, capacity=16, n=8):
    """trajectory(i) -> particle rows at tick i; fills the whole ring."""
    buf = jwl.create(capacity=capacity, num_particles=n)
    for i in range(capacity):
        buf = jwl.push_frame(buf, _particles(trajectory(i), capacity=n), time=i * H)
    return buf


OBJECTS = jstate.make_objects(16, [{"base_color": (1.0, 0.2, 0.2)},
                                   {"base_color": (0.2, 0.2, 1.0)}])


def _render(jbuf, jp, cam, w=64, h=64, **kw):
    """(port image, JAX image), (H, W, 3) numpy, after the pixel gate."""
    jparams = jw3d.Worldline3DParams(**kw)
    jcam = JCamera.create(**cam)
    jimg = np.asarray(jw3d.render_worldline3d(jbuf, jp.object_index, OBJECTS, jcam, w, h, jparams,
                                              active=jp.active))
    p = convert.particles_from_numpy(_fields(jp))
    img = w3d.render_worldline3d(convert.worldline_from_numpy(_fields(jbuf)), p.object_index,
                                 convert.objects_from_numpy(_fields(OBJECTS)),
                                 convert.camera_from_numpy(_fields(jcam)), w, h,
                                 convert.worldline3d_params_from(jparams), active=p.active)
    img = img.numpy()
    assert img.shape == (h, w, 3) and np.isfinite(img).all()
    assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    return img, jimg


def _hits(img):
    return (img < 0.99).any(axis=-1)


def test_topdown_matches_the_point_rasterizer():
    """elevation pi/2 with no fade is the 2D point view: the newest tick wins
    every pixel (depth = age top-down)."""
    rows = [(0.45, 0.5, 0.0, 0.0, 0), (0.55, 0.5, 0.0, 0.0, 1)]
    jp = _particles(rows)
    img, _ = _render(_ring(lambda i: rows), jp, dict(pos=(0.5, 0.5), zoom=0.5), azimuth=0.0,
                     elevation=math.pi / 2, fade=0.0, shell_only=False)
    p = convert.particles_from_numpy(_fields(jp))
    ref = rasterize.render_points(p, convert.objects_from_numpy(_fields(OBJECTS)),
                                  convert.camera_from_numpy(_fields(
                                      JCamera.create(pos=(0.5, 0.5), zoom=0.5))),
                                  64, 64).numpy()
    np.testing.assert_array_equal(_hits(img), _hits(ref))
    assert _hits(img).sum() == 2
    assert np.abs(img[_hits(img)] - ref[_hits(img)]).max() <= Q


def test_edge_on_extrudes_the_time_axis():
    """A static particle edge-on (elevation 0): one column of samples
    extending down-screen only."""
    rows = [(0.5, 0.5, 0.0, 0.0, 0)]
    img, _ = _render(_ring(lambda i: rows), _particles(rows), dict(pos=(0.5, 0.5), zoom=0.2),
                     azimuth=0.0, elevation=0.0, time_scale=1.0, fade=0.0, shell_only=False)
    ys, xs = np.nonzero(_hits(img))
    assert len(np.unique(xs)) == 1 and len(np.unique(ys)) >= 12 and ys.min() >= 31


@pytest.mark.parametrize("far", [False, True], ids=["near", "beyond_zoom"])
def test_depth_order_near_wins(far):
    """Two coincident-projection worldlines: the sample nearer the viewer
    (red, object 0) wins every pixel, also when both sit far outside the
    zoom window (the depth range is the drawn samples' own)."""
    rows = ([(0.5, 5.5, 0.0, 0.0, 0), (0.5, 2.5, 0.0, 0.0, 1)] if far
            else [(0.5, 0.55, 0.0, 0.0, 0), (0.5, 0.45, 0.0, 0.0, 1)])
    img, _ = _render(_ring(lambda i: rows), _particles(rows), dict(pos=(0.5, 0.5), zoom=0.1),
                     azimuth=0.0, elevation=0.0, time_scale=10.0, fade=0.0, shell_only=False)
    hits = np.argwhere(_hits(img))
    assert len(hits) > 0
    for y, x in hits:
        assert np.abs(img[y, x] - RED).max() <= Q


def test_moving_particle_tilts_its_worldline():
    """Older (lower on screen) samples of a particle moving in +x sit at
    smaller x."""
    traj = lambda i: [(0.3 + 0.02 * i, 0.5, 0.0, 0.0, 0)]
    img, _ = _render(_ring(traj), _particles(traj(15)), dict(pos=(0.5, 0.5), zoom=0.6),
                     azimuth=0.0, elevation=0.0, time_scale=4.0, fade=0.0, shell_only=False)
    ys, xs = np.nonzero(_hits(img))
    order = np.argsort(ys)
    assert xs.max() - xs.min() >= 5 and xs[order[0]] > xs[order[-1]]


def test_age_fade_toward_the_background():
    rows = [(0.5, 0.5, 0.0, 0.0, 0)]
    img, _ = _render(_ring(lambda i: rows), _particles(rows), dict(pos=(0.5, 0.5), zoom=0.2),
                     azimuth=0.0, elevation=0.0, time_scale=1.0, fade=0.9, shell_only=False)
    ys, xs = np.nonzero(_hits(img))
    assert img[ys.max(), xs[0], 1] > img[ys.min(), xs[0], 1] + 0.3


def test_age_stride_keeps_the_newest_tick():
    """A stride of 4 over 16 ticks ((a_all - 1) % 4 = 3) still draws age 0,
    the present-time face, at u ~ 42, v ~ 32."""
    traj = lambda i: [(0.3 + 0.02 * i, 0.5, 0.0, 0.0, 0)]
    img, _ = _render(_ring(traj), _particles(traj(15)), dict(pos=(0.5, 0.5), zoom=0.6),
                     azimuth=0.0, elevation=0.0, time_scale=4.0, fade=0.0, shell_only=False,
                     age_stride=4)
    ys, xs = np.nonzero(_hits(img))
    assert ((np.abs(xs - 42) <= 1) & (np.abs(ys - 32) <= 1)).any()
    assert len(xs) <= 5  # one sample in four


@pytest.mark.parametrize("max_age", [0, 9])
def test_default_view_with_a_partly_written_ring(max_age):
    """The default view (azimuth 0.65, elevation 0.95, shell only) of a ring
    written 10 ticks into 16 slots, with the boundary mask: unwritten slots
    are not drawn, and max_age cuts the history."""
    traj = lambda i: [(0.45 + 0.01 * i, 0.5 + 0.005 * i, 0.0, 0.0, 0),
                      (0.55, 0.45 + 0.01 * i, 0.0, 0.0, 1)]
    jbuf = jwl.create(capacity=16, num_particles=8)
    for i in range(10):
        jbuf = jwl.push_frame(jbuf, _particles(traj(i)), time=i * H)
    jp = _particles(traj(9))
    jparams = jw3d.Worldline3DParams(max_age=max_age, time_scale=2.0)
    jcam = JCamera.create(pos=(0.5, 0.5), zoom=0.3)
    boundary = np.zeros(8, bool)
    boundary[1] = True
    jimg = np.asarray(jw3d.render_worldline3d(jbuf, jp.object_index, OBJECTS, jcam, 64, 48,
                                              jparams, active=jp.active,
                                              boundary=jnp.asarray(boundary)))
    p = convert.particles_from_numpy(_fields(jp))
    img = w3d.render_worldline3d(convert.worldline_from_numpy(_fields(jbuf)), p.object_index,
                                 convert.objects_from_numpy(_fields(OBJECTS)),
                                 convert.camera_from_numpy(_fields(jcam)), 64, 48,
                                 convert.worldline3d_params_from(jparams), active=p.active,
                                 boundary=torch.from_numpy(boundary), planar=True)
    assert img.shape == (3, 48, 64)
    img = img.permute(1, 2, 0).numpy()
    assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    hits = _hits(img)
    assert 0 < hits.sum() <= (max_age or 10)
    blue = np.array([0.2, 0.2, 1.0])
    assert all(np.abs(img[y, x] - blue).max() <= 0.8 for y, x in np.argwhere(hits))


def _engine_cfg(mod):
    """tests/test_worldline3d.py's Engine config."""
    return mod.EngineConfig(
        scene=mod.SceneSpec(bodies=(("disc", 30, (0.45, 0.45), (0.2, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
        render=mod.RenderParams(num_rays=128), width=64, height=64, history=32,
        render_mode="worldline3d", wl3d=mod.Worldline3DParams(time_scale=2.0, fade=0.5))


def test_engine_mode_end_to_end_matches_jax():
    """render_mode='worldline3d' through the fused Engine frame, against the
    JAX Engine's fused frames; then a paused (eager) frame re-renders the
    same image; the diag is the point views' PointsDiag."""
    je = JEngine(_engine_cfg(jconfig))
    jimgs = [np.asarray(je.run_frame()) for _ in range(3)]
    eng = Engine(_engine_cfg(config), device="cpu")
    assert eng._can_fuse()
    imgs = [eng.run_frame().numpy().copy() for _ in range(3)]
    for img, jimg in zip(imgs, jimgs):
        assert img.shape == (64, 64, 3) and _hits(img).any()
        assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    assert int(eng.last_diag.window_truncated) == 0 and len(eng._fused_cache) == 1
    eng.paused = True
    again = eng.run_frame().numpy()
    assert eng.graph_stats["eager"] == 1
    np.testing.assert_array_equal(again, imgs[-1])
    # the view parameters key the fused frame
    eng.paused = False
    eng.config = dataclasses.replace(eng.config, wl3d=w3d.Worldline3DParams(azimuth=1.2))
    eng.run_frame()
    assert len(eng._fused_cache) == 2


def test_worldline3d_config_is_the_jax_one():
    cfg = config.get_config("worldline3d")
    assert cfg.wl3d == convert.worldline3d_params_from(jconfig.get_config("worldline3d").wl3d)
    assert cfg.render_mode == "worldline3d" and cfg.wl3d.max_age == 384
    assert hash(cfg.wl3d) == hash(w3d.Worldline3DParams(time_scale=0.45, fade=0.75, max_age=384))


def test_ring_wraps_at_the_device_cursor():
    """The history slice follows the ring's device cursor after it wraps."""
    rows = lambda i: [(0.4 + 0.01 * i, 0.5, 0.0, 0.0, 0)]
    jbuf = _ring(rows, capacity=16)
    for i in range(16, 23):
        jbuf = jwl.push_frame(jbuf, _particles(rows(i)), time=i * H)
    buf = convert.worldline_from_numpy(_fields(jbuf))
    assert int(buf.cursor) == 6
    _render(jbuf, _particles(rows(22)), dict(pos=(0.5, 0.5), zoom=0.4), azimuth=0.3,
            elevation=0.5, time_scale=3.0, fade=0.4, shell_only=False)
    assert int(wl.slot_of_age(buf, 0)) == 6
