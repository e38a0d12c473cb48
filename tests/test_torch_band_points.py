"""The plain versions of the port's band and points kernels
(spacetime_tpu_torch.ops.band_cuda / points_cuda, and ops.rasterize
around them) against the JAX reference on the CPU: the Pallas band and
points kernels in interpret mode, the XLA band sweep and the XLA scatter
rasterizer.  The CUDA kernels themselves are held to these plain versions
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.camera import world_to_pixel as jworld_to_pixel
from spacetime_tpu.models.softbody import SoftbodyModel as JModel
from spacetime_tpu.ops import band_pallas, points_pallas
from spacetime_tpu.ops import rasterize as jrasterize
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.camera import world_to_pixel
from spacetime_tpu_torch.ops import band_cuda, points_cuda, rasterize
from spacetime_tpu_torch.ops import raytrace as rt


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


# --------------------------------------------------------------------------
# band search
# --------------------------------------------------------------------------


def _band_ring(ramp: bool):
    """tests/test_band_pallas.py's scenes: capacity 512, T = 128; either a
    prefilled ring advanced 7 ticks (the cursor wraps off the prefill) or
    a fresh ring after 21 ticks (frames_in_use < T)."""
    sb = jscene.SceneBuilder()
    if ramp:
        sb.add(jscene.disc_softbody(4, 0, (0.48, 0.5), (0.1, 0.0), lattice_pad=True),
               base_color=(0, 0, 1))
    else:
        sb.add(jscene.disc_softbody(5, 0, (0.42, 0.48), (0.12, 0.05), lattice_pad=True),
               base_color=(0, 0, 1))
        sb.add(jscene.disc_softbody(4, 1, (0.62, 0.55), (-0.1, 0.0), lattice_pad=True),
               base_color=(1, 0, 0))
    p, objects = sb.build(capacity=512)
    model = JModel(capacity=512, use_pallas=False)
    buf = jwl.create(128, 512)
    if not ramp:
        buf = jwl.prefill_inertial(buf, p.pos, p.vel, p.active, jnp.float32(0.0),
                                   jnp.float32(model.params.h))
    t = 0.0
    for _ in range(21 if ramp else 7):
        p, _ = model.step(p)
        t += model.params.h
        buf = jwl.push_frame(buf, p, t)
    cam = JCamera.create(pos=(0.52, 0.5) if ramp else (0.5, 0.5), zoom=0.6)
    return buf, cam


@pytest.mark.parametrize("ramp,band", [(False, 6), (False, 2), (True, 6)])
def test_band_plain_matches_pallas_kernel_and_xla_sweep(ramp, band):
    """a0, alast and truncated are equal everywhere; the windows are equal
    (bit for bit) on lanes that entered the cone and whose window lies
    inside the swept rows — elsewhere the two TPU paths hold different dead
    values (band_pallas.py:31-36), which the pair validity discards."""
    jbuf, jcam = _band_ring(ramp)
    jparams = jrt.RenderParams(band=band, max_age=128, backend="xla")
    buf = convert.worldline_from_numpy(_fields(jbuf))
    cam = convert.camera_from_numpy(_fields(jcam))
    ours = band_cuda.cone_band_window_plain(buf, rt.RenderParams(band=band, max_age=128), cam)
    base_col, a_sw, col0, hi0 = band_cuda._sweep_bounds(buf, jparams)
    base_col, col0, hi0 = int(base_col), int(col0), int(hi0)  # () i32 tensors on the ring's device
    assert a_sw == 128 and (hi0 < 127) == ramp
    ka0, kalast, *kwin = band_pallas.cone_band_window_pallas(
        jbuf.pos_x, jbuf.pos_y, jbuf.vel_x, jbuf.vel_y, jnp.int32(col0), jnp.int32(hi0),
        jnp.int32(base_col), jcam.pos[0], jcam.pos[1], jnp.float32(jparams.dt),
        jnp.float32(jparams.rho + jparams.dt), a_sw=a_sw, band=band, interpret=True)
    xa0, xhi0, xtr, (*xwin, xages) = jrt._cone_band_window(jbuf, None, jparams, cam=jcam)

    a0, alast = ours.a0.numpy(), ours.alast.numpy()
    np.testing.assert_array_equal(a0, np.asarray(ka0))
    np.testing.assert_array_equal(a0, np.asarray(xa0))
    np.testing.assert_array_equal(alast, np.asarray(kalast))
    assert ours.hi0 == int(xhi0) == hi0
    assert int(ours.truncated) == int(xtr) == int((alast >= a0 + band).sum())
    assert (int(ours.truncated) > 0) == (band == 2)
    np.testing.assert_array_equal(ours.ages.numpy(), np.asarray(xages))

    w = band + 1
    start = ours.ages.numpy()[:, 0]  # age of the oldest window row
    inside = (a0 <= hi0) & (start <= a_sw - 1) & (start - band >= 0)
    assert inside.sum() > 0
    for got, k, x in zip((ours.wx, ours.wy, ours.wvx, ours.wvy), kwin, xwin):
        got = got.numpy()
        assert got.shape == (512, w)
        np.testing.assert_array_equal(got[inside], np.asarray(k)[inside])
        np.testing.assert_array_equal(got[inside], np.asarray(x)[inside])


def test_cone_band_window_routes_cpu_to_plain():
    """band_cuda.cone_band_window on CPU tensors is the plain version."""
    jbuf, jcam = _band_ring(False)
    buf = convert.worldline_from_numpy(_fields(jbuf))
    cam = convert.camera_from_numpy(_fields(jcam))
    params = rt.RenderParams(max_age=128)
    got = band_cuda.cone_band_window(buf, params, cam)
    ref = band_cuda.cone_band_window_plain(buf, params, cam)
    assert got.hi0 == ref.hi0
    for name in ("a0", "alast", "truncated", "wx", "wy", "wvx", "wvy", "ages"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name


# --------------------------------------------------------------------------
# points
# --------------------------------------------------------------------------


def _points_scene(n_bodies=2, seed=0):
    """tests/test_points_pallas.py's scene: non-lattice discs at seeded
    centres and colours."""
    sb = jscene.SceneBuilder()
    rng = np.random.default_rng(seed)
    for i in range(n_bodies):
        c = tuple(rng.uniform(0.2, 0.8, 2))
        sb.add(jscene.disc_softbody(5, i, c, (0.05, -0.02)),
               base_color=tuple(rng.uniform(0.1, 1.0, 3)))
    return sb.build()


def _port(jp, jo, jcam):
    return (convert.particles_from_numpy(_fields(jp)), convert.objects_from_numpy(_fields(jo)),
            convert.camera_from_numpy(_fields(jcam)))


def _candidates(jp, jcam, w, h):
    """Per covered pixel, the indices of the particles landing there."""
    px = np.asarray(jworld_to_pixel(jp.pos, w, h, jcam))
    xi, yi = np.round(px[:, 0]).astype(int), np.round(px[:, 1]).astype(int)
    act = np.asarray(jp.active)
    table = {}
    for i in range(len(xi)):
        if act[i] and 0 <= xi[i] < w and 0 <= yi[i] < h:
            table.setdefault((yi[i], xi[i]), []).append(i)
    return table


def test_world_to_pixel_matches_jax(rng):
    pos = rng.uniform(-2, 3, (257, 2)).astype(np.float32)
    jcam = JCamera.create(pos=(0.4, 0.7), zoom=1.3)
    cam = convert.camera_from_numpy(_fields(jcam))
    ours = world_to_pixel(torch.from_numpy(pos), 200, 100, cam).numpy()
    ref = jworld_to_pixel(jnp.asarray(pos), 200, 100, jcam)
    np.testing.assert_array_equal(ours, np.asarray(ref))


@pytest.mark.parametrize("wh", [(256, 128), (200, 100), (130, 50)])
def test_points_plain_matches_pallas_kernel(wh):
    """The same image as the Pallas kernel (both take the lowest index on a
    shared pixel), the coverage of the XLA scatter renderer, and on every
    shared pixel the lowest landing index's colour."""
    w, h = wh
    jp, jo = _points_scene()
    jcam = JCamera.create(pos=(0.5, 0.5), zoom=1.2)
    p, o, cam = _port(jp, jo, jcam)
    ours = points_cuda.render_points_plain(p, o, cam, w, h).numpy()
    kimg, kdiag = points_pallas.render_points_pallas(jp, jo, jcam, w, h, planar=True,
                                                     interpret=True)
    assert ours.shape == (3, h, w) and int(kdiag.window_truncated) == 0
    np.testing.assert_allclose(ours, np.asarray(kimg), rtol=0, atol=1e-6)
    scatter = np.asarray(jrasterize.render_points(jp, jo, jcam, w, h))
    np.testing.assert_array_equal(np.any(ours != 1.0, axis=0), np.any(scatter != 1.0, axis=-1))
    table = _candidates(jp, jcam, w, h)
    colors = np.asarray(jo.base_color)[np.asarray(jp.object_index)]
    assert any(len(c) > 1 for c in table.values())  # the rule is exercised
    for (y, x), cands in table.items():
        np.testing.assert_array_equal(ours[:, y, x], colors[min(cands)])


def test_points_plain_all_on_one_pixel_matches_pallas_kernel():
    """Every particle on one pixel of a 97 x 61 image (5,917 pixels, no
    multiple of 32): the Pallas kernel's image (interpret mode), one covered
    pixel in the lowest active index's colour.  Tolerance: atol 1e-6, the
    kernel's one-hot colour matmul in f32."""
    jp, jo = _points_scene()
    jp = dataclasses.replace(jp, pos=jnp.full_like(jp.pos, 0.5))
    jcam = JCamera.create(pos=(0.5, 0.5), zoom=1.2)
    p, o, cam = _port(jp, jo, jcam)
    ours = points_cuda.render_points_plain(p, o, cam, 97, 61).numpy()
    kimg, kdiag = points_pallas.render_points_pallas(jp, jo, jcam, 97, 61, planar=True,
                                                     interpret=True)
    assert ours.shape == (3, 61, 97) and int(kdiag.window_truncated) == 0
    np.testing.assert_allclose(ours, np.asarray(kimg), rtol=0, atol=1e-6)
    covered = np.argwhere(np.any(ours != 1.0, axis=0))
    first = int(np.argmax(np.asarray(jp.active)))
    assert covered.shape[0] == 1
    np.testing.assert_array_equal(ours[:, covered[0][0], covered[0][1]],
                                  np.asarray(jo.base_color)[int(jp.object_index[first])])


def test_points_plain_exact_on_unique_pixels():
    jp, jo = _points_scene(1)
    centre = np.asarray(jp.pos)[np.asarray(jp.active)].mean(axis=0)
    # zoomed in to 0.002 ls a pixel, under the 0.0035 ls lattice spacing
    jcam = JCamera.create(pos=tuple(centre), zoom=0.5)
    table = _candidates(jp, jcam, 256, 256)
    assert len(table) > 50 and all(len(c) == 1 for c in table.values())
    p, o, cam = _port(jp, jo, jcam)
    ours = rasterize.render_points(p, o, cam, 256, 256).numpy()
    ref = np.asarray(jrasterize.render_points(jp, jo, jcam, 256, 256))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_points_plain_excludes_inactive_and_offscreen():
    jp, jo = _points_scene(1)
    act = np.asarray(jp.active).copy()
    centre = np.asarray(jp.pos)[act].mean(axis=0)
    act[: act.sum() // 2] = False  # half of the disc's particles
    jp = dataclasses.replace(jp, active=jnp.asarray(act))
    # the view's left edge (1 ls left of the camera) cuts the disc
    jcam = JCamera.create(pos=(centre[0] + 1.0, centre[1]), zoom=2.0)
    p, o, cam = _port(jp, jo, jcam)
    ours = rasterize.render_points(p, o, cam, 128, 64).numpy()
    ref = np.asarray(jrasterize.render_points(jp, jo, jcam, 128, 64))
    kimg, _ = points_pallas.render_points_pallas(jp, jo, jcam, 128, 64, interpret=True)
    cov = np.any(ours != 1.0, axis=-1)
    np.testing.assert_array_equal(cov, np.any(ref != 1.0, axis=-1))
    np.testing.assert_array_equal(ours, np.asarray(kimg))
    px = np.asarray(jworld_to_pixel(jp.pos, 128, 64, jcam))
    on = (np.round(px) >= 0).all(-1) & (np.round(px[:, 0]) < 128) & (np.round(px[:, 1]) < 64)
    assert (act & ~on).any() and (act & on).any()  # actives off and on screen
    assert cov.sum() < (act & on).sum() + 1 and cov.any()


def test_points_planar_layout_and_no_drops():
    jp, jo = _points_scene(1)
    p, o, cam = _port(jp, jo, JCamera.create(pos=(0.5, 0.5), zoom=1.2))
    a = rasterize.render_points(p, o, cam, 128, 64)
    b = rasterize.render_points(p, o, cam, 128, 64, planar=True)
    assert a.shape == (64, 128, 3) and torch.equal(a, b.permute(1, 2, 0))
