"""The retina mode (the observer's 360-degree strip with aberration) and
multi-view rendering of the port against the JAX package on the CPU.

`render_retina` and `_band_pairs_nocull` are held to the JAX functions on a
ring of eight static blobs around the camera (tests/test_retina.py's
scene) and on tests/test_multiview.py's two moving discs, for a static and
a moving camera; the three behaviours of tests/test_retina.py run on the
port; `render_views` is held to JAX's (pixel gate) and to single renders
(bit-equal), and the Engine's retina mode and `render_views` to the JAX
Engine's.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.camera import stack_cameras as jstack
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.camera import Camera, stack_cameras
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import config

H = 0.005
# the port's tolerances (tests/test_torch_render.py)
F32 = dict(rtol=1e-5, atol=1e-5)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
# positions: the same physics in another f32 order (tests/test_torch_engine.py)
POS_ATOL = 1e-5


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _port_params(jp):
    return rt.RenderParams(**{f.name: getattr(jp, f.name)
                              for f in dataclasses.fields(rt.RenderParams)})


def _port_cam(jcam):
    return convert.camera_from_numpy(_fields(jcam))


def _to_port(jbuf, jp, jo):
    return (convert.worldline_from_numpy(_fields(jbuf)), convert.particles_from_numpy(_fields(jp)),
            convert.objects_from_numpy(_fields(jo)))


@pytest.fixture(scope="module")
def ring():
    """tests/test_retina.py's ring of eight static blobs around the origin,
    128 ticks."""
    sb = jscene.SceneBuilder()
    for i, ang in enumerate(np.linspace(0, 2 * np.pi, 8, endpoint=False)):
        sb.add(jscene.disc_softbody(2, i % 2, (0.3 * np.cos(ang), 0.3 * np.sin(ang)), (0.0, 0.0)),
               base_color=(0.2, 0.9, 0.3) if i % 2 == 0 else (0.9, 0.3, 0.2))
    jp, jo = sb.build(capacity=512)
    jbuf = jwl.create(128, jp.capacity)
    for k in range(128):
        jbuf = jwl.push_frame(jbuf, jp, time=k * H)
    return (jbuf, jp, jo), _to_port(jbuf, jp, jo)


@pytest.fixture(scope="module")
def history():
    """tests/test_multiview.py's two moving discs over 48 ticks."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(5, 0, (0.45, 0.5), (0.3, 0.0)), base_color=(0.2, 0.9, 0.3))
    sb.add(jscene.disc_softbody(4, 1, (0.62, 0.52), (-0.2, 0.1)), base_color=(0.9, 0.2, 0.3))
    jp, jo = sb.build(capacity=256)
    jbuf = jwl.create(48, jp.capacity)
    for k in range(48):
        shifted = dataclasses.replace(jp, pos=jp.pos + jp.vel * (k * H))
        jbuf = jwl.push_frame(jbuf, shifted, time=k * H)
    return (jbuf, jp, jo), _to_port(jbuf, jp, jo)


RETINA = jrt.RenderParams(dt=H, num_rays=512, backend="xla")
VELS = {"static": (0.0, 0.0), "moving": (0.6, 0.2)}


# --------------------------------------------------------------------------
# render_retina
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vel", list(VELS))
def test_band_pairs_nocull_match_jax(ring, vel):
    """Every valid row, panorama-wide (no view cull), at F32."""
    (jbuf, jp, jo), (buf, tp, to) = ring
    jcam = JCamera.create(pos=(0.0, 0.0), zoom=1.0, vel=VELS[vel])
    ref = jrt._band_pairs_nocull(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                 RETINA)
    ours = rt._band_pairs_nocull(buf, tp.object_index, to, _port_cam(jcam),
                                 wl.newest_time(buf), _port_params(RETINA))
    valid = np.asarray(ref.pair_valid)
    np.testing.assert_array_equal(ours.pair_valid.numpy(), valid)
    assert int(ours.n_pairs) == int(ref.n_pairs) > 0
    np.testing.assert_allclose(ours.pdata.numpy()[valid], np.asarray(ref.pdata)[valid], **F32)


def _retina_pair(scene, jcam, jparams, height=4, planar=False):
    (jbuf, jp, jo), (buf, tp, to) = scene
    ref = np.asarray(jrt.render_retina(jbuf, jp.object_index, jo, jcam, jparams, height=height,
                                       planar=planar))
    ours = rt.render_retina(buf, tp.object_index, to, _port_cam(jcam), _port_params(jparams),
                            height=height, planar=planar).numpy()
    return ours, ref


@pytest.mark.parametrize("vel", list(VELS))
@pytest.mark.parametrize("scene", ["ring", "history"])
def test_render_retina_matches_jax(ring, history, scene, vel):
    """Hit masks equal, hit colours at F32, the strip repeated over rows."""
    data = ring if scene == "ring" else history
    pos = (0.0, 0.0) if scene == "ring" else (0.5, 0.45)
    jparams = dataclasses.replace(RETINA, ray_chunk=96)  # several chunks of the march
    ours, ref = _retina_pair(data, JCamera.create(pos=pos, zoom=1.0, vel=VELS[vel]), jparams)
    assert ours.shape == ref.shape == (4, 512, 3)
    assert (ours == ours[:1]).all()
    hit, jhit = (ours != 1.0).any(-1), (ref != 1.0).any(-1)
    np.testing.assert_array_equal(hit, jhit)
    assert 0 < hit[0].sum() < hit[0].size  # some rays hit, some see the sky
    np.testing.assert_allclose(ours[hit], ref[hit], **F32)


def test_render_retina_planar_and_spectral_match_jax(ring):
    jcam = JCamera.create(pos=(0.05, 0.0), zoom=1.0, vel=(0.3, 0.0))
    jparams = dataclasses.replace(RETINA, spectral=True)
    ours, ref = _retina_pair(ring, jcam, jparams, height=16, planar=True)
    assert ours.shape == (3, 16, 512)
    np.testing.assert_allclose(ours, ref, **F32)


def _strip(ring, vel):
    _, (buf, tp, to) = ring
    cam = Camera.create(pos=(0.0, 0.0), zoom=1.0, vel=vel, device="cpu")
    img = rt.render_retina(buf, tp.object_index, to, cam, _port_params(RETINA), height=4)
    return img.numpy()[0]  # (R, 3)


def test_static_camera_sees_ring(ring):
    """tests/test_retina.py: 8 blobs -> 8 hit runs around the panorama."""
    hit = _strip(ring, (0.0, 0.0)).min(-1) < 0.9
    assert np.sum(hit & ~np.roll(hit, 1)) == 8


def test_aberration_compresses_forward_view(ring):
    """tests/test_retina.py: a fast camera sees the ring's images bunched
    toward its motion."""
    hit = _strip(ring, (0.8, 0.0)).min(-1) < 0.9
    n = len(hit)
    theta = -np.pi + (np.arange(n) + 0.5) * 2 * np.pi / n
    runs = np.nonzero(hit & ~np.roll(hit, 1))[0]
    fwd_images = int(np.sum(np.abs(theta[runs]) < np.pi / 2))
    assert len(runs) >= 6
    assert fwd_images >= len(runs) - 2, (fwd_images, len(runs), theta[runs])


def test_forward_blueshift_for_moving_camera(ring):
    """tests/test_retina.py: forward hits brighter than backward ones
    (headlight boost)."""
    strip = _strip(ring, (0.6, 0.0))
    n = len(strip)
    theta = -np.pi + (np.arange(n) + 0.5) * 2 * np.pi / n
    hit = strip.min(-1) < 0.9
    fwd = hit & (np.abs(theta) < np.pi / 4)
    back = hit & (np.abs(theta) > 3 * np.pi / 4)
    assert fwd.any() and back.any()
    assert strip[fwd].sum(-1).mean() > strip[back].sum(-1).mean() * 1.3


# --------------------------------------------------------------------------
# render_views
# --------------------------------------------------------------------------

VIEWS = jrt.RenderParams(dt=H, bin_capacity=64, num_rays=512, backend="xla")
CAMS = [((0.5, 0.5), 0.6, (0.0, 0.0)), ((0.42, 0.55), 0.4, (0.0, 0.0)),
        ((0.6, 0.45), 0.8, (0.3, 0.0))]


@pytest.mark.parametrize("planar", [False, True])
def test_render_views_matches_jax_and_single_renders(history, planar):
    """B views in one call: each under the pixel gate against JAX's batch,
    and bit-equal to the port's own single render of that camera (with the
    boundary retina, as the Engine passes it)."""
    (jbuf, jp, jo), (buf, tp, to) = history
    w = h = 64
    params = dataclasses.replace(VIEWS, cell_px=jrt.auto_cell_px(VIEWS, w, h, 0.6),
                                 retina_budget=2048)
    jcams = [JCamera.create(pos=p, zoom=z, vel=v) for p, z, v in CAMS]
    cams = [_port_cam(c) for c in jcams]
    ref = np.asarray(jrt.render_views(jbuf, jp.object_index, jo, jstack(jcams), w, h, params,
                                      planar=planar, boundary=jwl.boundary_mask(jp)))
    batch = rt.render_views(buf, tp.object_index, to, stack_cameras(cams), w, h,
                            _port_params(params), planar=planar,
                            boundary=wl.boundary_mask(tp))
    assert batch.shape == ((3, 3, h, w) if planar else (3, h, w, 3)) == ref.shape
    for i, cam in enumerate(cams):
        single = rt.render_retarded(buf, tp.object_index, to, cam, w, h, _port_params(params),
                                    planar=planar, boundary=wl.boundary_mask(tp))
        assert torch.equal(batch[i], single), i
        a, b = batch[i].numpy(), ref[i]
        if not planar:
            a, b = a.transpose(2, 0, 1), b.transpose(2, 0, 1)
        assert np.mean(np.abs(a - b).max(axis=0) > PIXEL_TOL) <= PIXEL_SHARE, i
        assert (a < 0.99).mean() > 0.02  # the discs are in every view


def test_stack_cameras():
    cams = [Camera.create(pos=p, zoom=z, vel=v, device="cpu") for p, z, v in CAMS]
    s = stack_cameras(cams)
    assert s.pos.shape == (3, 2) and s.zoom.shape == (3,) and s.vel.shape == (3, 2)
    assert torch.equal(s.vel[2], cams[2].vel)
    with pytest.raises(ValueError, match="at least one"):
        stack_cameras([])


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------


def _small(mod, rp, **kw):
    cfg = dataclasses.replace(mod.get_config("single_blob"),
                              **{**dict(width=48, height=48, history=32), **kw})
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, num_rays=256))


def test_engine_retina_mode_matches_jax():
    """accelerated_camera's kind of run: the retina mode with an
    accelerating camera, 4 eager frames on both Engines."""
    # the blob is 0.49 ls from the camera: 128 ticks of history reach it
    kw = dict(render_mode="retina", cam_accel=(0.5, 0.0), history=128)
    je = JEngine(_small(jconfig, jrt.RenderParams, **kw))
    pe = Engine(_small(config, rt.RenderParams, **kw), device="cpu")
    assert not pe._can_fuse()
    for _ in range(4):
        jimg = np.asarray(je.run_frame())
        img = pe.run_frame().numpy()
    assert img.shape == jimg.shape == (16, 256, 3)
    hit, jhit = (img != 1.0).any(-1), (jimg != 1.0).any(-1)
    assert hit.any() and np.mean(hit != jhit) <= PIXEL_SHARE
    assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    np.testing.assert_allclose(pe.camera.vel.numpy(), np.asarray(je.camera.vel), rtol=1e-6)
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    assert pe.graph_stats["eager"] == 4 and pe.graph_stats["captures"] == 0
    assert pe.last_diag is None
    assert pe.render().shape == (16, 256, 3)


def test_engine_render_views_matches_jax():
    """tests/test_multiview.py's Engine case: view 0 is the Engine's own
    camera and bit-equals its render(); the batch matches the JAX Engine's
    under the pixel gate."""
    je = JEngine(_small(jconfig, jrt.RenderParams))
    pe = Engine(_small(config, rt.RenderParams), device="cpu")
    for _ in range(3):
        je.run_frame()
        pe.run_frame()
    zoom = float(pe.camera.zoom)
    batch = pe.render_views([pe.camera, Camera.create(pos=(0.52, 0.5), zoom=zoom, device="cpu")])
    jbatch = np.asarray(je.render_views([je.camera, JCamera.create(pos=(0.52, 0.5), zoom=zoom)]))
    assert batch.shape == jbatch.shape == (2, 48, 48, 3)
    assert torch.equal(batch[0], pe.render())
    for a, b in zip(batch.numpy(), jbatch):
        assert np.mean(np.abs(a - b).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE


@pytest.mark.parametrize("mode", ["points", "retina"])
def test_engine_render_views_rejects_other_modes(mode):
    eng = Engine(_small(config, rt.RenderParams, render_mode=mode), device="cpu")
    with pytest.raises(ValueError, match="render_views"):
        eng.render_views([eng.camera])
