"""Parity of the port's camera-frame (boosted) view — ops/boost.py and the
`camera_frame` branches of ops/raytrace.py and the plain pixel pass — with
the JAX reference, on the CPU at small sizes.

The warp functions are held against `spacetime_tpu.ops.boost`; the render
against JAX's `render_retarded(..., backend="pallas_interpret")` (its Pallas
pixel kernel with the `camera_frame` branch, in interpret mode), its XLA
path's tables, and both packages' brute-force oracles.  The scene is
tests/test_torch_render.py's: two lattice discs, a T=64 prefilled ring plus
one pushed tick, 96x64, with the camera moving at 0.5c.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.ops import boost as jboost
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.ops import boost
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl

H = 0.005
W, HT = 96, 64
VELS = [(0.0, 0.0), (0.3, 0.0), (0.0, -0.5), (0.4, 0.4), (0.69, 0.1)]
# the same f32 formula in the same order in XLA and in torch's CPU kernels
F32 = dict(rtol=0, atol=1e-6)
# whole images: a pixel may flip where an ulp moves a capsule edge or a ray
# across a bin boundary (tests/test_torch_render.py)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _offsets(rng, n=512):
    return [rng.uniform(-1.0, 1.0, n).astype(np.float32) for _ in range(2)]


# --------------------------------------------------------------------------
# ops/boost
# --------------------------------------------------------------------------


@pytest.mark.parametrize("v", VELS)
def test_warp_and_unwarp_match_jax(rng, v):
    dx, dy = _offsets(rng)
    vx, vy = np.float32(v[0]), np.float32(v[1])
    for ours_fn, ref_fn in ((boost.warp_xy, jboost.warp_xy), (boost.unwarp_xy, jboost.unwarp_xy)):
        ours = ours_fn(torch.from_numpy(dx), torch.from_numpy(dy), torch.tensor(vx),
                       torch.tensor(vy))
        ref = ref_fn(jnp.asarray(dx), jnp.asarray(dy), jnp.float32(vx), jnp.float32(vy))
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32)
    for ours, ref in ((boost.gamma_of(vx, vy), jboost.gamma_of(vx, vy)),
                      (boost.stretch(vx, vy), jboost.stretch(vx, vy))):
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


@pytest.mark.parametrize("v", VELS)
def test_warp_roundtrip(rng, v):
    dx, dy = (torch.from_numpy(a * 5) for a in _offsets(rng))
    ux, uy = boost.warp_xy(dx, dy, *v)
    bx, by = boost.unwarp_xy(ux, uy, *v)
    assert ((bx - dx).abs() + (by - dy).abs()).max() < 1e-5
    if v == (0.0, 0.0):  # a still camera: the identity, exactly
        assert torch.equal(ux, dx) and torch.equal(uy, dy)


def test_warp_physical_limits():
    """A source at ground cone distance d straight ahead plots at
    gamma (1 + v) d; straight behind at gamma (1 - v) d; transverse offsets
    keep their perpendicular component (tests/test_boost.py)."""
    v = 0.6
    g = 1.0 / np.sqrt(1 - v * v)
    one = lambda x: torch.tensor([x], dtype=torch.float32)
    ux, _ = boost.warp_xy(one(2.0), one(0.0), v, 0.0)
    assert abs(float(ux[0]) - g * (1 + v) * 2.0) < 1e-5
    ux, _ = boost.warp_xy(one(-2.0), one(0.0), v, 0.0)
    assert abs(float(ux[0]) + g * (1 - v) * 2.0) < 1e-5
    _, uy = boost.warp_xy(one(0.0), one(1.5), v, 0.0)
    assert abs(float(uy[0]) - 1.5) < 1e-6


def test_warp_jacobian_bounded_by_stretch(rng):
    dx, dy = (torch.from_numpy(a * 3) for a in _offsets(rng, 2048))
    eps = 1e-3
    for vx, vy in [(0.5, 0.0), (0.3, 0.4)]:
        s = float(boost.stretch(vx, vy))
        ux0, uy0 = boost.warp_xy(dx, dy, vx, vy)
        for ex, ey in [(eps, 0.0), (0.0, eps), (eps / 1.414, eps / 1.414)]:
            ux1, uy1 = boost.warp_xy(dx + ex, dy + ey, vx, vy)
            assert (torch.sqrt((ux1 - ux0) ** 2 + (uy1 - uy0) ** 2) / eps).max() <= s * 1.01


# --------------------------------------------------------------------------
# the camera-frame render
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def frame():
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(5, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(jscene.disc_softbody(5, 1, (0.42, 0.43), (-0.25, -0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    jp, jo = sb.build()
    jbuf = jwl.prefill_inertial(jwl.create(64, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    jbuf = jwl.push_frame(jbuf, dataclasses.replace(jp, pos=jp.pos + jp.vel * H), H)
    jcam = JCamera.create(pos=(0.36, 0.41), zoom=0.2, vel=(0.5, 0.0))
    tp = convert.particles_from_numpy(_fields(jp))
    return dict(
        j=(jbuf, jp, jo, jcam),
        t=(convert.worldline_from_numpy(_fields(jbuf)), tp,
           convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam))),
    )


def _jparams(**kw):
    base = dict(dt=H, num_rays=512, pair_budget=2048, bin_capacity=64, cell_px=16,
                occlusion_downsample=2, ray_chunk=256, retina_budget=256, max_age=48,
                entry_budget=8192, camera_frame=True, backend="pallas_interpret")
    base.update(kw)
    return jrt.RenderParams(**base)


def _port_params(jp):
    return rt.RenderParams(**{f.name: getattr(jp, f.name)
                              for f in dataclasses.fields(rt.RenderParams)})


def _mismatch(a, b):
    return np.mean(np.abs(a - b).max(axis=0) > PIXEL_TOL)


def _band(frame, jparams):
    """Both packages' band pairs; the hull cull as JAX's render passes it."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jpairs, _, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                   W, HT, jparams, cull_hull=not jparams.camera_frame)
    pairs, _, _ = rt._band_pairs(buf, tp.object_index, to, cam, buf.times[buf.cursor], W, HT,
                                 _port_params(jparams))
    return jpairs, pairs


def test_band_pairs_without_hull_cull_match_jax(frame):
    """The camera-frame render skips the view-hull cull: the same valid pairs
    as the JAX package's, and more than the cull keeps for a narrow view."""
    jparams = _jparams()
    jpairs, pairs = _band(frame, jparams)
    valid = np.asarray(jpairs.pair_valid)
    np.testing.assert_array_equal(pairs.pair_valid.numpy(), valid)
    np.testing.assert_allclose(pairs.pdata.numpy()[valid], np.asarray(jpairs.pdata)[valid],
                               rtol=1e-5, atol=1e-5)
    buf, tp, to, cam = frame["t"]
    narrow = dataclasses.replace(cam, zoom=torch.tensor(0.02))
    culled, _, _ = rt._band_pairs(buf, tp.object_index, to, narrow, buf.times[buf.cursor], W,
                                  HT, dataclasses.replace(_port_params(jparams),
                                                          camera_frame=False))
    assert int(pairs.n_pairs) > int(culled.n_pairs) > 0


@pytest.mark.parametrize("budgets", [dict(), dict(bin_capacity=6, entry_budget=600)])
def test_warped_splat_matches_jax_vslot(frame, budgets):
    """Warped centres and stretched reach: the CSR's per-cell entries are the
    rows of JAX's vslot table, and the drop and coverage diagnostics agree."""
    jparams = _jparams(backend="xla", **budgets)
    params = _port_params(jparams)
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jpairs, pairs = _band(frame, jparams)
    vslot, jbin, jent, jsmall, _ = jrt._splat_vslot(jpairs, jcam, W, HT, jparams)
    entries, lo, hi, nbin, nent, small, geom = rt._splat_csr(pairs, cam, W, HT, params)
    assert (int(nbin), int(nent), bool(small)) == (int(jbin), int(jent), bool(jsmall))
    vs = np.asarray(vslot).reshape(geom[1] * geom[0], -1)
    pd = pairs.pdata.numpy()
    assert (vs >= 0).sum() > 0
    for c in range(vs.shape[0]):
        ids = vs[c][vs[c] >= 0]
        np.testing.assert_array_equal(entries[lo[c]:hi[c]].numpy(), pd[ids])
    # the coverage bound scales by the stretch: 3 px cells hold the ground
    # reach but not gamma (1 + v) times it
    small3 = rt._splat_csr(pairs, cam, W, HT, dataclasses.replace(params, cell_px=3))[5]
    assert bool(small3) and not bool(rt._splat_csr(
        pairs, cam, W, HT, dataclasses.replace(params, cell_px=3, camera_frame=False))[5])


def test_retina_lookup_unwarps_like_jax(frame):
    buf, tp, to, cam = frame["t"]
    jcam = frame["j"][3]
    s_first = torch.arange(512, dtype=torch.float32)  # the index itself: exact check
    gx = torch.arange(0, 96, 3, dtype=torch.int32)[None, :].expand(20, -1)
    gy = torch.arange(0, 60, 3, dtype=torch.int32)[:, None].expand(-1, 32)
    ps = float(cam.zoom) / W
    x0 = cam.pos[0] - (W - 1) / 2.0 * ps
    y0 = cam.pos[1] - (HT - 1) / 2.0 * ps
    for cf in (True, False):
        ours = rt._sfirst_lookup(s_first, gx, gy, x0, y0, ps, cam, 512, 0.5, cf)
        ref = jrt._sfirst_lookup(jnp.asarray(s_first.numpy()), jnp.asarray(gx.numpy()),
                                 jnp.asarray(gy.numpy()), jnp.float32(x0), jnp.float32(y0),
                                 jnp.float32(ps), jcam, 512, 0.5, camera_frame=cf)
        mism = (ours.numpy() != np.asarray(ref)).mean()
        assert mism <= 2e-3  # an angle on a bin edge may round across it
    assert not torch.equal(
        rt._sfirst_lookup(s_first, gx, gy, x0, y0, ps, cam, 512, 0.5, True),
        rt._sfirst_lookup(s_first, gx, gy, x0, y0, ps, cam, 512, 0.5, False))


@pytest.mark.parametrize("case", ["base", "odd_saturated"])
@pytest.mark.parametrize("opaque", [True, False])
def test_camera_frame_render_matches_jax_pallas_interpret(frame, opaque, case):
    """The camera-frame render against the JAX package's Pallas pixel
    kernel in interpret mode: at 96 x 64, and at 97 x 61 (no multiple of 4
    wide, no multiple of cell_px 16 high) with every crowded cell filled to
    a bin_capacity of 32.  At most PIXEL_SHARE of pixels off by more than
    PIXEL_TOL; every diagnostic equal (`bin_dropped` to the JAX XLA path's
    count once cells overflow: its Pallas path counts the drops of its
    sorted windows, which differ)."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    w, h = (97, 61) if case == "odd_saturated" else (W, HT)
    jparams = _jparams(opaque=opaque, **(dict(bin_capacity=32) if case == "odd_saturated" else {}))
    jimg, jdiag = jrt.render_retarded_with_diag(jbuf, jp.object_index, jo, jcam, w, h,
                                                jparams, planar=True,
                                                boundary=jwl.boundary_mask(jp))
    img, diag = rt.render_retarded_with_diag(buf, tp.object_index, to, cam, w, h,
                                             _port_params(jparams), planar=True,
                                             boundary=wl.boundary_mask(tp))
    img, jimg = img.numpy(), np.asarray(jimg)
    assert img.shape == (3, h, w) and np.isfinite(img).all()
    if case == "odd_saturated":
        _, xdiag = jrt.render_retarded_with_diag(
            jbuf, jp.object_index, jo, jcam, w, h, dataclasses.replace(jparams, backend="xla"),
            planar=True, boundary=jwl.boundary_mask(jp))
        assert int(diag.bin_dropped) == int(xdiag.bin_dropped) > 0
        jdiag = jdiag._replace(bin_dropped=xdiag.bin_dropped)
    assert (img < 0.99).mean() > 0.01  # the discs are in view
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    for name in ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small",
                 "retina_dropped", "entry_dropped"):
        a, b = getattr(diag, name), getattr(jdiag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name
    # the boosted view differs from the ground view
    ground = rt.render_retarded(buf, tp.object_index, to, cam, w, h,
                                dataclasses.replace(_port_params(jparams), camera_frame=False),
                                planar=True, boundary=wl.boundary_mask(tp)).numpy()
    assert _mismatch(img, ground) > 0.01


def test_camera_frame_brute_oracles_match(frame):
    """The port's brute oracle vs the JAX package's, and the fast x-ray
    render vs the oracle (no retina, so no angular quantization)."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jparams = _jparams(backend="xla", cell_px=9, occlusion_downsample=1, pair_budget=0,
                       entry_budget=0, opaque=False)
    ref = np.asarray(jrt.render_retarded_brute(jbuf, jp.object_index, jo, jcam, 48, 32,
                                               jparams))
    ours = rt.render_retarded_brute(buf, tp.object_index, to, cam, 48, 32,
                                    _port_params(jparams)).numpy()
    assert (ours < 0.99).mean() > 0.01
    assert _mismatch(ours.transpose(2, 0, 1), ref.transpose(2, 0, 1)) <= PIXEL_SHARE
    fast = rt.render_retarded(buf, tp.object_index, to, cam, 48, 32,
                              _port_params(jparams)).numpy()
    assert _mismatch(fast.transpose(2, 0, 1), ours.transpose(2, 0, 1)) <= PIXEL_SHARE


def test_camera_frame_displaces_ahead_source():
    """A static blob ahead of a camera moving at v plots gamma (1 + v) times
    farther in the boosted view (tests/test_boost.py)."""
    from spacetime_tpu_torch import scene
    from spacetime_tpu_torch.camera import Camera

    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(8, 0, (0.6, 0.45), (0.0, 0.0)), base_color=(0.2, 0.9, 0.3))
    p, objects = sb.build(capacity=512, device="cpu")
    buf = wl.prefill_inertial(wl.create(192, p.capacity, device="cpu"), p.pos, p.vel, p.active,
                              0.0, H)
    v = 0.5
    cam = Camera.create(pos=(0.35, 0.5), zoom=1.2, vel=(v, 0.0), device="cpu")
    base = rt.RenderParams(dt=H, bin_capacity=64, num_rays=512, opaque=False)
    base = dataclasses.replace(base, cell_px=rt.auto_cell_px(base, 72, 72, 1.2))

    def centroid_x(params):
        img = rt.render_retarded(buf, p.object_index, objects, cam, 72, 72, params).numpy()
        ys, xs = np.nonzero(img.min(-1) < 0.9)
        assert len(xs) > 0
        return (xs.mean() - (72 - 1) / 2) * (1.2 / 72)

    dg = centroid_x(base)
    db = centroid_x(dataclasses.replace(base, camera_frame=True))
    g = 1.0 / np.sqrt(1 - v * v)
    assert abs(db / dg - g * (1 + v)) < 0.05, (dg, db)


def test_camera_frame_requires_retarded(frame):
    buf, tp, to, cam = frame["t"]
    params = _port_params(_jparams(retarded=False))
    with pytest.raises(ValueError, match="retarded=True"):
        rt.prepare_pixel_pass(buf, tp.object_index, to, cam, W, HT, params)
