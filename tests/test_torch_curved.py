"""The conical mode of the port (spacetime_tpu_torch.ops.curved and the
Engine's conical frames) against the JAX package on the CPU, and against
its own exhaustive oracle.

The scene: two small lattice discs inertially prefilled into a T=128 ring
(one moving at 0.35c past a defect of deficit 5, one crossing between it
and the camera), a 48x48 view at cell_px 8.  Both packages get the same
numpy state; the JAX conical renderer is pure XLA on the CPU, as
tests/test_curved.py runs it.  Images are held to the flat render's pixel
gate (at most 0.1% of pixels off by more than 1e-3), f32 results to
rtol = atol = 1e-5, the RenderDiag counters exactly; the fast renderer is
held to the oracle within tests/test_curved.py's budget (3% of pixels off
by more than 0.05: retina binning and the per-candidate route-2 sign).
Parity with JAX runs at segments=0, where JAX's dropped count (which it
throws away) cannot differ; the port's `segment_dropped` (the sum over the
routes) is held to the rank-compaction oracle instead.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import curved as jcurved
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import band_cuda, curved
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import config
from spacetime_tpu_torch.utils import logging as logmod

H = 0.005
W = HT = 48
F32 = dict(rtol=1e-5, atol=1e-5)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
ORACLE_TOL, ORACLE_SHARE = 0.05, 0.03
DIAG = ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
        "entry_dropped", "segment_dropped")
ONE = ((0.02, 0.03), 5.0)
TWO = (ONE, ((-0.1, 0.08), 4.5))


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _jparams(**kw):
    base = dict(dt=H, num_rays=512, cell_px=8, bin_capacity=128, ray_chunk=1024, backend="xla")
    base.update(kw)
    return jrt.RenderParams(**base)


def _port_params(jp):
    return rt.RenderParams(**{f.name: getattr(jp, f.name)
                              for f in dataclasses.fields(rt.RenderParams)})


def _jdefects(specs):
    return tuple(jcurved.ConicalDefect.create(c, d) for c, d in specs)


def _mismatch(a, b, tol=PIXEL_TOL):
    return np.mean(np.abs(a - b).max(axis=-1) > tol)


def _lit(img):
    return int(((img < 0.99) & (np.abs(img - 0.78) > 1e-6)).any(axis=-1).sum())


@pytest.fixture(scope="module")
def scene():
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.0, -0.08), (0.0, 0.35)), base_color=(0.2, 0.9, 0.3))
    sb.add(jscene.disc_softbody(3, 1, (-0.05, -0.03), (0.05, 0.0)), base_color=(0.9, 0.4, 0.2))
    jp, jo = sb.build(capacity=128)
    jbuf = jwl.prefill_inertial(jwl.create(128, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(127 * H), jnp.float32(H))
    jcam = JCamera.create(pos=(-0.08, 0.0), zoom=0.25)
    port = (convert.worldline_from_numpy(_fields(jbuf)), convert.particles_from_numpy(_fields(jp)),
            convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam)))
    return dict(j=(jbuf, jp, jo, jcam), t=port)


def _render(scene, jparams, specs, brute=False):
    """(port image, port diag, JAX image, JAX diag), (H, W, 3) numpy; with
    `brute` the two oracles, diags None."""
    jbuf, jp, jo, jcam = scene["j"]
    buf, p, o, cam = scene["t"]
    jd = _jdefects(specs)
    d = convert.defects_from_numpy(jd)
    params = _port_params(jparams)
    if brute:
        img = curved.render_conical_brute(buf, p.object_index, o, cam, d, W, HT, params)
        jimg = jcurved.render_conical_brute(jbuf, jp.object_index, jo, jcam, jd, W, HT, jparams)
        return img.numpy(), None, np.asarray(jimg), None
    img, diag = curved.render_retarded_conical_with_diag(buf, p.object_index, o, cam, d, W, HT,
                                                         params)
    jimg, jdiag = jcurved.render_retarded_conical_with_diag(jbuf, jp.object_index, jo, jcam, jd,
                                                            W, HT, jparams)
    return img.numpy(), diag, np.asarray(jimg), jdiag


def _diag_equal(diag, jdiag):
    for name in DIAG:
        a, b = getattr(diag, name), getattr(jdiag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name


# --------------------------------------------------------------------------
# geodesics
# --------------------------------------------------------------------------


@pytest.mark.parametrize("deficit", [0.0, 1.2, 4.0])
def test_geodesic_lengths_match_jax(deficit):
    """Random point pairs around a defect: l1, l2 (where route 2 exists)
    and its validity as the JAX function gives them."""
    rng = np.random.default_rng(7)
    a = rng.uniform(-0.5, 0.5, (400, 2)).astype(np.float32)
    b = rng.uniform(-0.5, 0.5, (400, 2)).astype(np.float32)
    jd = jcurved.ConicalDefect.create(center=(0.03, -0.02), deficit=deficit)
    l1, l2, v2 = curved.geodesic_lengths(torch.from_numpy(a), torch.from_numpy(b),
                                         convert.defects_from_numpy(jd))
    jl1, jl2, jv2 = (np.asarray(x) for x in jcurved.geodesic_lengths(a, b, jd))
    np.testing.assert_allclose(l1.numpy(), jl1, **F32)
    np.testing.assert_array_equal(v2.numpy(), jv2)
    assert v2.any() == (deficit > 0)  # at zero deficit the back route spans 2 pi - d_phi >= pi
    np.testing.assert_allclose(l2.numpy()[jv2], jl2[jv2], **F32)
    assert (l2.numpy()[~jv2] == np.float32(rt._BIG)).all()


def test_geodesic_triangle_law():
    """90 degrees apart, deficit 4: the back route spans (2 pi - 4) - pi/2."""
    d = curved.ConicalDefect.create(center=(0.0, 0.0), deficit=4.0, device="cpu")
    l1, l2, v2 = curved.geodesic_lengths(torch.tensor([[0.3, 0.0]]), torch.tensor([[0.0, 0.4]]),
                                         d)
    back = (2 * np.pi - 4.0) - np.pi / 2
    assert bool(v2[0])
    np.testing.assert_allclose(float(l1[0]), 0.5, rtol=1e-6)
    np.testing.assert_allclose(float(l2[0]), np.sqrt(0.25 - 0.24 * np.cos(back)), rtol=1e-5)


def test_route2_theta_and_rotation_match_jax():
    """The route-2 rotation angle (the floored wrap of the bearing
    difference, JAX's jnp.mod) and the rotation about the defect."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.6, 0.6, (2000, 2)).astype(np.float32)
    jcam = JCamera.create(pos=(-0.2, 0.1))
    cam = convert.camera_from_numpy(_fields(jcam))
    jd = jcurved.ConicalDefect.create(center=(0.05, 0.02), deficit=1.7)
    d = convert.defects_from_numpy(jd)
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    theta = curved._route2_theta(px, py, cam, d)
    jtheta = np.array(jcurved._route2_theta(pts[:, 0], pts[:, 1], jcam, jd))
    # an atan2 ulp can flip the sign at the bearing seam; away from it, equal
    assert np.mean(theta.numpy() != jtheta) <= PIXEL_SHARE
    assert set(np.unique(jtheta)) == {np.float32(-(2 * np.pi - 1.7)), np.float32(2 * np.pi - 1.7)}
    rx, ry = curved._rotate_about(px, py, torch.from_numpy(jtheta), d)
    jrx, jry = jcurved._rotate_about(pts[:, 0], pts[:, 1], jtheta, jd)
    np.testing.assert_allclose(rx.numpy(), np.asarray(jrx), **F32)
    np.testing.assert_allclose(ry.numpy(), np.asarray(jry), **F32)


def test_route_band_window_matches_jax(scene):
    """The route-2 cone sweep (plain on every device): a0, the oldest
    crossing age and the truncation count equal JAX's, the window rows
    inside the swept ages equal; route 1 passed as a function equals the
    default route (which takes the band kernel on the card)."""
    jbuf, jp, jo, jcam = scene["j"]
    buf, p, o, cam = scene["t"]
    jparams = _jparams()
    params = _port_params(jparams)
    jd = _jdefects((ONE,))[0]
    d = convert.defects_from_numpy(jd)
    route2 = lambda qx, qy: curved.geodesic_lengths_xy(qx, qy, cam.pos[0], cam.pos[1], d)[1]
    jroute2 = lambda qx, qy: jcurved.geodesic_lengths_xy(qx, qy, jcam.pos[0], jcam.pos[1], jd)[1]
    bw = band_cuda.cone_band_window_plain(buf, params, cam, route2)
    a0, hi0, jtr, (jwx, jwy, jwvx, jwvy, jages) = jrt._cone_band_window(jbuf, jroute2, jparams,
                                                                         jcam)
    np.testing.assert_array_equal(bw.a0.numpy(), np.asarray(a0))
    assert int(bw.hi0) == int(hi0) and int(bw.truncated) == int(jtr)
    assert (bw.a0.numpy() <= int(hi0)).sum() > 50  # the route crosses the stored ticks
    ages = np.asarray(jages)
    np.testing.assert_array_equal(bw.ages.numpy(), ages)
    inside = (ages >= 0) & (ages <= int(hi0))
    for ours, ref in ((bw.wx, jwx), (bw.wy, jwy), (bw.wvx, jwvx), (bw.wvy, jwvy)):
        np.testing.assert_array_equal(ours.numpy()[inside], np.asarray(ref)[inside])
    euclid = rt._euclid_route(cam.pos[0], cam.pos[1])
    for a, b in zip(band_cuda.cone_band_window(buf, params, cam),
                    band_cuda.cone_band_window_plain(buf, params, cam, euclid)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the renderer
# --------------------------------------------------------------------------


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("specs", [(ONE,), TWO], ids=["one", "two"])
def test_conical_matches_jax(scene, specs, opaque):
    """render_retarded_conical_with_diag, single- and multi-defect, opaque
    and x-ray: the pixel gate, every diag counter equal."""
    img, diag, jimg, jdiag = _render(scene, _jparams(opaque=opaque), specs)
    assert img.shape == (HT, W, 3) and np.isfinite(img).all()
    assert _lit(img) > 30 and int(diag.pairs_used) > 0
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    _diag_equal(diag, jdiag)
    assert diag.retina_dropped is None and diag.segment_dropped is None


@pytest.mark.parametrize("specs", [(ONE,), TWO], ids=["one", "two"])
def test_conical_opaque_matches_brute(scene, specs):
    """The fast opaque renderer against the port's exhaustive oracle within
    the JAX test's budget, the oracle against JAX's under the pixel gate,
    and occlusion doing something (opaque differs from x-ray)."""
    jparams = _jparams()
    fast = _render(scene, jparams, specs)[0]
    oracle, _, joracle, _ = _render(scene, jparams, specs, brute=True)
    assert _mismatch(oracle, joracle) <= PIXEL_SHARE
    assert _mismatch(fast, oracle, ORACLE_TOL) < ORACLE_SHARE
    xray = _render(scene, _jparams(opaque=False), specs)[0]
    assert np.any(np.abs(fast - xray) > ORACLE_TOL)


@pytest.mark.parametrize("opaque", [False, True])
def test_zero_deficit_matches_flat_render(scene, opaque):
    """A far defect of zero deficit has no back route: the conical image is
    the flat render's (tests/test_curved.py's budgets: 1% of pixels off by
    1e-3 in x-ray, 2% off by 1e-2 opaque, the retinas being binned
    differently)."""
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams(opaque=opaque))
    d = curved.ConicalDefect.create(center=(-5.0, -5.0), deficit=0.0, device="cpu")
    img = curved.render_retarded_conical(buf, p.object_index, o, cam, d, W, HT, params).numpy()
    flat = rt.render_retarded(buf, p.object_index, o, cam, W, HT, params).numpy()
    assert _lit(flat) > 10
    if opaque:
        assert _mismatch(img, flat, 1e-2) < 0.02
    else:
        assert _mismatch(img, flat, 1e-3) < 0.01


def test_double_image_appears(scene):
    """The moving disc near the defect shows a second image: more pixels lit
    than in the flat render, on rows (the motion axis) where the flat
    render shows nothing."""
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams(opaque=False))
    flat = rt.render_retarded(buf, p.object_index, o, cam, W, HT, params).numpy()
    d = convert.defects_from_numpy(_jdefects((ONE,)))
    img = curved.render_retarded_conical(buf, p.object_index, o, cam, d, W, HT, params).numpy()
    rows_flat = np.nonzero((flat < 0.9).any(axis=-1))[0]
    rows = np.nonzero((img < 0.9).any(axis=-1))[0]
    assert _lit(img) > _lit(flat) * 1.3 > 0
    assert len(set(rows.tolist()) - set(rows_flat.tolist())) >= 3


def test_single_defect_tuple_identical(scene):
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams())
    d = convert.defects_from_numpy(_jdefects((ONE,)))
    a = curved.render_retarded_conical(buf, p.object_index, o, cam, d[0], W, HT, params)
    b = curved.render_retarded_conical(buf, p.object_index, o, cam, d, W, HT, params)
    assert torch.equal(a, b)


def test_planar_is_the_transposed_image(scene):
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams())
    d = convert.defects_from_numpy(_jdefects(TWO))
    a = curved.render_retarded_conical(buf, p.object_index, o, cam, d, W, HT, params)
    b = curved.render_retarded_conical(buf, p.object_index, o, cam, d, W, HT, params, planar=True)
    assert b.shape == (3, HT, W) and torch.equal(a, b.permute(1, 2, 0))


# --------------------------------------------------------------------------
# segment_dropped, which the JAX conical path throws away
# --------------------------------------------------------------------------


def _route_vcounts(scene, specs, band=6):
    """Valid crossings per particle of each route's uncompacted layout."""
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams(band=band))
    defects = convert.defects_from_numpy(_jdefects(specs))
    out = []
    for d in (None,) + defects:
        fn = None if d is None else (
            lambda qx, qy, d=d: curved.geodesic_lengths_xy(qx, qy, cam.pos[0], cam.pos[1], d)[1])
        pairs, _, none = rt._band_pairs(buf, p.object_index, o, cam, wl.newest_time(buf), W, HT,
                                        params, cull_hull=False, route_lengths=fn)
        assert none is None
        out.append(pairs.pair_valid.reshape(-1, band).sum(dim=1))
    return out


@pytest.mark.parametrize("specs", [(ONE,), TWO], ids=["one", "two"])
def test_conical_segment_dropped_oracle(scene, specs):
    """segment_dropped == sum over the routes of sum(max(vcount - k, 0)) at
    segments=2."""
    vcounts = _route_vcounts(scene, specs)
    want = sum(int(torch.clamp(v - 2, min=0).sum()) for v in vcounts)
    _, diag, _, _ = _render(scene, _jparams(band=6, segments=2), specs)
    assert int(diag.segment_dropped) == want > 0


def test_conical_segments_render_equals_uncompacted_when_nothing_drops(scene):
    """With k at the most valid crossings any particle has on any route,
    nothing drops and the compacted conical frame equals the uncompacted
    one (both layouts compacted to a pair budget, valid rows in order)."""
    k = max(int(v.max()) for v in _route_vcounts(scene, TWO))
    assert 1 < k < 6
    base = dict(band=6, pair_budget=512)
    img0, diag0, _, _ = _render(scene, _jparams(**base), TWO)
    imgk, diagk, _, _ = _render(scene, _jparams(segments=k, **base), TWO)
    assert int(diagk.segment_dropped) == 0 and diag0.segment_dropped is None
    assert int(diagk.pairs_used) == int(diag0.pairs_used) > 0
    assert np.array_equal(imgk, img0)


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------


def _small(mod, **over):
    """tests/test_curved.py's shrunk conical_defect: 48x48, discs of 60
    that never meet, a 128-tick ring covering the light delay."""
    cfg = mod.get_config("conical_defect")
    return dataclasses.replace(
        cfg, width=48, height=48, history=128,
        render=dataclasses.replace(cfg.render, num_rays=256),
        scene=dataclasses.replace(cfg.scene, bodies=(
            ("disc", 60, (0.25, 0.50), (0.0, 0.2), (0.2, 0.3, 1.0)),
            ("disc", 60, (0.75, 0.50), (0.0, -0.2), (1.0, 0.3, 0.2)))),
        **over)


FRAMES = 3


@pytest.fixture(scope="module")
def engines():
    """The small conical config, FRAMES frames: the JAX Engine (fused), the
    port's fused Engine and the port's eager (stage-timing) Engine."""
    je = JEngine(_small(jconfig))
    jimgs = [np.asarray(je.run_frame()) for _ in range(FRAMES)]
    pe = Engine(_small(config), device="cpu")
    imgs = [pe.run_frame().numpy().copy() for _ in range(FRAMES)]
    ue = Engine(_small(config, stage_timing=True), device="cpu")
    uimgs = [ue.run_frame().numpy().copy() for _ in range(FRAMES)]
    return je, jimgs, pe, imgs, ue, uimgs


def test_engine_conical_matches_jax(engines):
    je, jimgs, pe, imgs, _, _ = engines
    assert je._can_fuse() and pe._can_fuse()
    np.testing.assert_array_equal(pe.worldline.times.numpy(), np.asarray(je.worldline.times))
    for img, jimg in zip(imgs, jimgs):
        assert _mismatch(img, jimg) <= PIXEL_SHARE
    _diag_equal(pe.last_diag, je.last_diag)
    assert int(pe.last_diag.pairs_used) > 0 and _lit(imgs[-1]) > 0
    (d,), (jd,) = pe._defects(), je._defects()
    np.testing.assert_array_equal(d.center.numpy(), np.asarray(jd.center))


def test_conical_fused_matches_unfused(engines):
    """The fused conical frame (defects from the device clock inside the
    render stage) equals the eager stage-timing one (the host clock)."""
    _, _, pe, imgs, ue, uimgs = engines
    assert not ue._can_fuse() and ue.graph_stats["eager"] == FRAMES
    for a, b in zip(imgs, uimgs):
        np.testing.assert_allclose(a, b, atol=2e-5)
    assert len(pe._fused_cache) == 1


def test_fused_key_tracks_the_defect_geometry():
    """A new defect between frames makes a new fused frame (the cache key
    holds the defect fields, as JAX's does), and its image changes."""
    eng = Engine(_small(config), device="cpu")
    eng.run_frame()
    first = eng.render().numpy()
    eng.config = dataclasses.replace(eng.config, defect=((0.45, 0.5), 2.0))
    eng.run_frame()
    assert len(eng._fused_cache) == 2
    assert not np.array_equal(eng.render().numpy(), first)


def test_pair_budget_overflow_warns_and_adapts(caplog):
    """An overloaded shared pair_budget warns and doubles _pair_boost; the
    boost is live in the next frame's params."""
    cfg = _small(config, diag_every=1)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, pair_budget=64))
    eng = Engine(cfg, device="cpu")
    logger = logmod.get()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=logmod.NAME):
            eng.run_frame()
            eng.run_frame()
    finally:
        logger.removeHandler(caplog.handler)
    assert eng._pair_boost >= 1
    assert any("pair_budget" in r.getMessage() for r in caplog.records)
    assert eng._render_params().pair_budget == 64 << eng._pair_boost


def test_defect_motion_quasi_static():
    """defect_vel moves the defect with the clock: c0 + v time."""
    eng = Engine(_small(config, defect_vel=((0.1, -0.05),)), device="cpu")
    (d0,) = eng._defects()
    for _ in range(2):
        eng.run_frame()
    (d1,) = eng._defects()
    assert eng.time > 0
    np.testing.assert_allclose(d1.center.numpy(),
                               d0.center.numpy() + np.array([0.1, -0.05]) * eng.time,
                               rtol=1e-5, atol=1e-7)


def test_retarded_defect_motion_is_the_static_defect_at_its_retarded_position():
    """defect_retarded puts a moving defect where the camera's past light
    cone meets its track (the closed-form root, as JAX's _defects computes
    it); the image equals a static defect pinned there."""
    v = (0.4, -0.2)
    eng = Engine(_small(config, defect_vel=(v,), defect_retarded=True), device="cpu")
    for _ in range(2):
        img_r = eng.run_frame().numpy()
    t = eng.time
    (d_used,) = eng._defects(t)
    c0, deficit = config.get_config("conical_defect").defect
    cam = eng.camera.pos.numpy().astype(np.float64)
    q, vv = np.asarray(c0) - cam, np.asarray(v)
    a, b, c_ = vv @ vv - 1.0, 2.0 * (q @ vv + t), q @ q - t * t
    t_r = (-b + np.sqrt(b * b - 4 * a * c_)) / (2 * a)
    assert t_r <= t
    np.testing.assert_allclose(d_used.center.numpy(), np.asarray(c0) + vv * t_r, rtol=1e-5)
    # JAX's _defects at the same clock and camera
    jeng = JEngine(_small(jconfig, defect_vel=(v,), defect_retarded=True))
    (jd,) = jeng._defects(t, cam=JCamera.create(pos=tuple(cam)))
    np.testing.assert_allclose(d_used.center.numpy(), np.asarray(jd.center), **F32)
    static = Engine(_small(config, defect=(tuple(d_used.center.tolist()), deficit)),
                    device="cpu")
    for _ in range(2):
        img_s = static.run_frame().numpy()
    np.testing.assert_allclose(img_r, img_s, atol=2e-5)


@pytest.mark.parametrize("over,match", [
    (dict(defect_vel=((1.0, 0.0),)), "not below c"),
    (dict(defect_vel=((0.1, 0.0), (0.0, 0.1))), "one \\(vx, vy\\) per defect"),
])
def test_defect_vel_refusals(over, match):
    eng = Engine(_small(config, **over), device="cpu")
    with pytest.raises(ValueError, match=match):
        eng._defects()


@pytest.mark.parametrize("over,routes2", [
    (dict(stage_timing=True), 1),  # eager frames
    ({}, 1),  # fused frames
    (dict(defect=TWO), 2),  # two defects: two back routes
    (dict(render_mode="retarded"), 0),  # a mode without a defect
])
def test_engine_counts_the_route_work_of_each_frame(over, routes2):
    """Engine.render_work after two frames: the route pass's tests (the
    view-cell grid's pixels x bin_capacity x routes) and the back routes'
    swept rows (ring ticks x particles, one sweep a defect), from the
    frames' shapes; every other mode counts frames only."""
    eng = Engine(_small(config, **over), device="cpu")
    for _ in range(2):
        eng.run_frame()
    assert eng._can_fuse() == ("stage_timing" not in over)
    p = eng._render_params()
    pixels = (-(-W // p.cell_px) * p.cell_px) * (-(-HT // p.cell_px) * p.cell_px)
    tests = pixels * p.bin_capacity * (1 + routes2) if routes2 else 0
    rows = eng.config.history * eng.worldline.num_particles * routes2
    assert eng.render_work == {"frames": 2, "route_pass_tests": 2 * tests,
                               "route2_sweep_rows": 2 * rows}
