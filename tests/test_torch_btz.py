"""The btz mode of the port (spacetime_tpu_torch.ops.btz and the Engine's
btz frames) against the JAX package on the CPU, against float64
quadrature, and against its own exhaustive oracle.

Closed forms: a seeded grid of emitters around a hole (radii from inside
the horizon out to six horizon radii, all bearings, and points a few
milliradians off the camera's bearing for the near-radial branch) at
spins 0, 0.004 and -0.004, every base route and windings 0 and 1.  They
are held to JAX at rtol = atol = 1e-5: every near-radial and every
inside-horizon point, and at least 95% of the rest.  The others lie where
the f32 closed form is itself ill-conditioned (A ~ 1/dphi cancels near the
camera's bearing, the exponentials grow with the separation): there XLA's
and torch's f32 exp and log, an ulp apart, land on either side of the
formula's float64 value.  Each such point must be no further from JAX's
own functions run in float64 (jax.enable_x64) than twice JAX's f32
distance to that value plus 1e-4 relative.  Independently of both
packages' code, route delays (direct, reflected, winding, spinning) and
the drag integrals are held in float64 to the trapezoid quadratures of
tests/test_btz.py.

Renders: the 96x96 scene of tests/test_btz.py's opaque oracle test (two
small discs, an inertially prefilled ring plus 80 RK4 steps, the camera
at (-0.38, 0), M = 0.03, l = 0.45), here with a T=1024 ring so that the
boundary echoes and winding images have a history to show.  Images are
held to the pixel gate (at most 0.1% of pixels off by more than 1e-3),
the RenderDiag counters exactly but for pairs_used, held within 1% (a
crossing on a branch seam of the closed forms, see _diag_equal).  The
fast opaque render is held to the port's oracle within tests/test_btz.py's
5% budget on a small scene built for occlusion (the oracle tests every
pixel against every segment).
"""

import dataclasses
import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.models.softbody import SoftbodyModel as JModel
from spacetime_tpu.ops import btz as jbtz
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import band_cuda, btz
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import config
from spacetime_tpu_torch.utils import logging as logmod

H = 0.005
M, L = 0.03, 0.45
R_H = L * math.sqrt(M)
CAM = (0.1, -0.35)
TOL = 1e-5
# an f32 evaluation's distance to the float64 value where the closed form
# cancels (see the module docstring)
F32_NOISE = 1e-4
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
ORACLE_TOL, ORACLE_SHARE = 0.05, 0.05
PAIR_SEAM = 0.01  # share of pairs_used that may differ at branch seams (_diag_equal)
DIAG = ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
        "entry_dropped", "segment_dropped")
SPINS = (0.0, 0.004, -0.004)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tests run tens of thousands of elementwise torch ops on tensors
    big enough for torch's intra-op threads; beside the suite's other
    workers, each op's thread team then waits on busy cores.  One thread a
    worker keeps their time that of the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _holes(spin, center=(0.0, 0.0)):
    jh = jbtz.BTZBlackHole.create(center=center, mass=M, ads_l=L, spin=spin)
    return jh, convert.btz_hole_from_numpy(jh)


def _hole64(hole):
    return btz.BTZBlackHole(**{f: getattr(hole, f).double()
                               for f in ("center", "mass", "ads_l", "spin")})


def _jax64(fn, *args, hole):
    """JAX's fn(*args, hole) run in float64 (jax.enable_x64) on the float64
    values of the f32 arguments and of the f32 JAX `hole`: the reference
    where both f32 evaluations cancel, independent of the port's code."""
    with jax.enable_x64(True):
        hole = jbtz.BTZBlackHole(**{f: jnp.asarray(np.asarray(getattr(hole, f)), jnp.float64)
                                    for f in ("center", "mass", "ads_l", "spin")})
        out = fn(*(jnp.asarray(np.asarray(a), jnp.float64) for a in args), hole)
        return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), out)


def _grid():
    """(qx, qy) f32: 1,500 emitters from 0.3 to 6 horizon radii about the
    hole at every bearing, and 100 within 3e-3 rad of the camera's bearing
    (the near-radial branch), beyond and inside the camera's radius."""
    rng = np.random.default_rng(5)
    r = rng.uniform(0.3 * R_H, 6.0 * R_H, 1500)
    th = rng.uniform(-np.pi, np.pi, 1500)
    phi_c = math.atan2(CAM[1], CAM[0])
    r2 = rng.uniform(1.2 * R_H, 0.6, 100)
    th2 = phi_c + rng.uniform(-3e-3, 3e-3, 100)
    r, th = np.concatenate([r, r2]), np.concatenate([th, th2])
    return (r * np.cos(th)).astype(np.float32), (r * np.sin(th)).astype(np.float32)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _assert_close(ours, ref, ref64, strict):
    """ours (port, f32) against ref (JAX, f32) and ref64 (JAX in float64):
    every `strict` point and at least 95% of all within rtol = atol = TOL
    of JAX; every other point no further from ref64 than twice JAX's own
    distance to it plus F32_NOISE relative."""
    ours, ref, ref64 = (np.asarray(x, np.float64) for x in (ours, ref, ref64))
    assert np.isfinite(ours).all() and np.isfinite(ref).all()
    close = np.abs(ours - ref) <= TOL + TOL * np.abs(ref)
    assert close[strict].all(), np.flatnonzero(strict & ~close)[:5]
    assert np.mean(close) >= 0.95, np.mean(close)
    noise = F32_NOISE * (1.0 + np.abs(ref64))
    as_good = np.abs(ours - ref64) <= 2.0 * np.abs(ref - ref64) + noise
    assert (close | as_good).all(), np.flatnonzero(~(close | as_good))[:5]


@pytest.mark.parametrize("spin", SPINS)
def test_delay_and_drag_closed_forms_match_jax(spin):
    """btz_null_delay, its reflected form, btz_drag_integral and its
    reflected form, the signed-u cores, _spin_delay / _spin_delay_u, and
    _polar_separation / _travel_sense / route_delays_xy on the grid; the
    near-radial (dphi < 3e-3) and inside-horizon branches are taken, and
    held to JAX outright."""
    jh, th = _holes(spin)
    qx, qy = _grid()
    rq, rc, dphi = (x.numpy() for x in btz._polar_separation(_t(qx), _t(qy), _t(CAM[0]),
                                                             _t(CAM[1]), th))
    jrq, jrc, jdphi = (np.asarray(x) for x in jbtz._polar_separation(
        qx, qy, jnp.float32(CAM[0]), jnp.float32(CAM[1]), jh))
    for a, b in ((rq, jrq), (rc, jrc), (dphi, jdphi)):
        np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
    inside = jrq < 0.99 * R_H
    assert (dphi < 3e-3).sum() >= 20 and inside.sum() >= 100
    s = btz._travel_sense(_t(qx), _t(qy), _t(CAM[0]), _t(CAM[1]), th)
    js = np.asarray(jbtz._travel_sense(qx, qy, jnp.float32(CAM[0]), jnp.float32(CAM[1]), jh))
    assert np.mean(s.numpy() != js) <= 1e-3
    js_t = _t(js)
    seps = (jdphi, 2 * np.pi - jdphi, jdphi + 2 * np.pi)
    for sep in seps:
        sep = np.maximum(sep, 1e-6).astype(np.float32)
        strict = inside | (sep < 3e-3)
        args = (jrq, jrc, sep)
        for name in ("btz_null_delay", "btz_null_delay_reflected", "btz_drag_integral",
                     "btz_drag_integral_reflected"):
            ours = getattr(btz, name)(*(_t(a) for a in args), th.mass, th.ads_l)
            ref = getattr(jbtz, name)(*args, jh.mass, jh.ads_l)
            ref64 = _jax64(lambda *a, fn=getattr(jbtz, name): fn(*a[:-1], a[-1].mass,
                                                                  a[-1].ads_l), *args, hole=jh)
            _assert_close(ours.numpy(), ref, ref64, strict)
        base = jbtz.btz_null_delay(*args, jh.mass, jh.ads_l)
        ours = btz._spin_delay(_t(base), *(_t(a) for a in args), js_t, th)
        ref = jbtz._spin_delay(base, *args, js, jh)
        ref64 = _jax64(jbtz._spin_delay, base, *args, js, hole=jh)
        _assert_close(ours.numpy(), ref, ref64, strict)
        ua, ub = 1.0 / jrc, -1.0 / jrq
        base = jbtz._null_delay_u(ua, ub, sep, jh.mass, jh.ads_l)
        ours = btz._spin_delay_u(_t(base), _t(ua), _t(ub), _t(sep), js_t, th)
        ref = jbtz._spin_delay_u(base, ua, ub, sep, js, jh)
        ref64 = _jax64(jbtz._spin_delay_u, base, ua, ub, sep, js, hole=jh)
        _assert_close(ours.numpy(), ref, ref64, strict)
    ours = btz.route_delays_xy(_t(qx), _t(qy), _t(CAM[0]), _t(CAM[1]), th)
    ref = jbtz.route_delays_xy(qx, qy, jnp.float32(CAM[0]), jnp.float32(CAM[1]), jh)
    ref64 = _jax64(jbtz.route_delays_xy, qx, qy, np.float32(CAM[0]), np.float32(CAM[1]),
                   hole=jh)
    for a, b, c, strict in zip(ours, ref, ref64, (inside | (jdphi < 3e-3), inside)):
        _assert_close(a.numpy(), b, c, strict)
        assert (a.numpy() == np.float32(rt._BIG)).sum() >= 100  # the horizon's +BIG


@pytest.mark.parametrize("spin", SPINS)
@pytest.mark.parametrize("route", range(8))
def test_route_optics_match_jax(route, spin):
    """route_optics_xy (bearing, delay, emitter direction) and
    route_delay_xy for base routes 0-3 at windings 0 and 1; the route
    encoding base = route % 4, winding = route // 4.  Delays at the
    near-radial and inside-horizon points are held to JAX outright."""
    jh, th = _holes(spin)
    qx, qy = _grid()
    q, jq = (_t(qx), _t(qy), _t(CAM[0]), _t(CAM[1])), (
        qx, qy, jnp.float32(CAM[0]), jnp.float32(CAM[1]))
    ob, job = btz._orbit_setup(*q, th, route), jbtz._orbit_setup(*jq, jh, route)
    assert ob["dphi"].min() >= 2 * np.pi * (route // 4)
    assert (ob["u_q_bvp"] < 0).all() == (route % 4 >= 2)
    inside = np.asarray(job["rq"]) < 0.99 * R_H
    near = np.asarray(job["dphi"]) < 3e-3
    assert near.sum() >= (20 if route in (0, 2) else 0) and inside.sum() >= 100
    ours = btz.route_optics_xy(*q, th, route)
    ref = jbtz.route_optics_xy(*jq, jh, route)
    ref64 = _jax64(lambda *a: jbtz.route_optics_xy(*a, route), *jq, hole=jh)
    # bearings wrap at +-pi: compare them on the circle
    wrap = lambda a, b: np.abs((np.asarray(a, np.float64) - b + np.pi) % (2 * np.pi) - np.pi)
    bear_err, bear_ref = wrap(ours[0].numpy(), ref[0]), wrap(ref[0], ref64[0])
    assert np.mean(bear_err <= 2 * TOL) >= 0.99 and (bear_err <= 2 * TOL + bear_ref).all()
    for a, b, c, strict in zip(ours[1:], ref[1:], ref64[1:], (inside | near, inside, inside)):
        _assert_close(a.numpy(), b, c, strict)
    for a, b in zip(btz.arrival_bearing_xy(*q, th, route), ours[:2]):
        assert torch.equal(a, b)
    for a, b in zip(btz.emitter_direction_xy(*q, th, route), ours[2:]):
        assert torch.equal(a, b)
    ours_d = btz.route_delay_xy(*q, th, route)
    _assert_close(ours_d.numpy(), jbtz.route_delay_xy(*jq, jh, route),
                  _jax64(lambda *a: jbtz.route_delay_xy(*a, route), *jq, hole=jh),
                  inside | near)
    assert job["dphi"].shape == ob["dphi"].shape
@pytest.mark.parametrize("route", [0, 1, 2, 3, 4, 6])
def test_sample_orbit_and_tangent_match_jax(route):
    """sample_orbit's points and delays and _tangent_at along a route
    (rtol 1e-4: the samples' partial boundary problems cancel like the
    closed forms' near-radial ones)."""
    jh, th = _holes(0.004)
    for q in ((0.3, 0.25), (-0.2, -0.3)):
        args = (_t(q[0]), _t(q[1]), _t(CAM[0]), _t(CAM[1]))
        jargs = tuple(jnp.float32(v) for v in (q[0], q[1], CAM[0], CAM[1]))
        xs, ys, dl = btz.sample_orbit(*args, th, route, 512)
        jxs, jys, jdl = jbtz.sample_orbit(*jargs, jh, route, 512)
        # near a reflected orbit's bounce r = 1/|u| runs off to the AdS
        # boundary, where an ulp of u is a long way: points there compare
        # by bearing
        near = np.hypot(np.asarray(jxs), np.asarray(jys)) < 5.0
        assert near.mean() > 0.9
        np.testing.assert_allclose(xs.numpy()[near], np.asarray(jxs)[near], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(ys.numpy()[near], np.asarray(jys)[near], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.arctan2(ys.numpy(), xs.numpy()),
                                   np.arctan2(np.asarray(jys), np.asarray(jxs)), atol=1e-4)
        np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose([xs[-1].item(), ys[-1].item()], q, atol=1e-4)
        ob, job = btz._orbit_setup(*args, th, route), jbtz._orbit_setup(*jargs, jh, route)
        for sigma in (1.0, -1.0):
            phi = ob["dphi"] * 0.5
            a = btz._tangent_at(ob, phi, sigma)
            b = jbtz._tangent_at(job, job["dphi"] * 0.5, sigma)
            np.testing.assert_allclose([float(v) for v in a], [float(v) for v in b],
                                       rtol=1e-4, atol=1e-5)


def _quadratures(ra, rb, dphi, reflected, m, l, n=400_000):
    """(delay, drag integral) along the orbit from (ra, 0) to (rb, dphi) by
    tests/test_btz.py's float64 oracles: the orbit's boundary problem
    solved in float64, then dt/dphi = (E/L) l^2 / (1 - M l^2 u^2) and
    dphi / f = l^2 u^2 / (1 - M l^2 u^2) integrated by trapezoid.  A
    reflected orbit has its far endpoint negated in u; both integrands are
    even in u, so integrating through its one u = 0 crossing is the
    physical two-leg path."""
    mu = np.sqrt(m)
    ua, ub = 1.0 / ra, (-1.0 if reflected else 1.0) / rb
    e = np.exp(mu * dphi)
    a = (ub - ua / e) / (e - 1.0 / e)
    b = ua - a
    e_over_l = np.sqrt(1.0 / l ** 2 - 4.0 * a * b * m)
    phi = np.linspace(0.0, dphi, n)
    u = a * np.exp(mu * phi) + b * np.exp(-mu * phi)
    assert np.sum(np.diff(np.sign(u)) != 0) == int(reflected)
    over_f = l * l * u * u / (1.0 - m * l * l * u * u)
    assert (over_f >= 0).all()
    return (float(np.trapezoid(e_over_l * l * l / (1.0 - m * l * l * u * u), phi)),
            float(np.trapezoid(over_f, phi)))


@pytest.mark.parametrize("route", range(8))
def test_route_delay_matches_quadrature_in_float64(route):
    """The port's route_delay_xy on float64 tensors against the float64
    quadratures of the same orbit (tests/test_btz.py's oracles), for every
    base route (direct, around the back, each once reflected off the AdS
    boundary) at windings 0 and 1, at J = 0 and J = 0.004:
    t(J) = t(0) + s (J / 2) I, with s the sense of the camera -> emitter
    sweep (+1 counterclockwise)."""
    cx, cy = 4.0 * R_H, 0.0
    for spin in (0.0, 0.004):
        hole = _hole64(btz.BTZBlackHole.create(center=(0.0, 0.0), mass=M, ads_l=L, spin=spin,
                                               device="cpu"))
        m, l, j = (float(getattr(hole, f)) for f in ("mass", "ads_l", "spin"))
        rng = np.random.default_rng(31 + route)
        for _ in range(8):
            rq = rng.uniform(1.5 * R_H, 5.0 * R_H)
            ang = rng.uniform(0.1, np.pi - 0.1) * rng.choice([-1.0, 1.0])
            qx, qy = rq * np.cos(ang), rq * np.sin(ang)
            direct = route % 2 == 0
            sep = (abs(ang) if direct else 2 * np.pi - abs(ang)) + 2 * np.pi * (route // 4)
            sense = np.sign(ang) if direct else -np.sign(ang)
            delay, drag = _quadratures(cx, rq, sep, route % 4 >= 2, m, l)
            got = btz.route_delay_xy(*(torch.tensor(v, dtype=torch.float64)
                                       for v in (qx, qy, cx, cy)), hole, route)
            np.testing.assert_allclose(float(got), delay + sense * 0.5 * j * drag, rtol=1e-6)


@pytest.mark.parametrize("reflected", [False, True], ids=["direct", "reflected"])
def test_drag_integrals_match_quadrature_in_float64(reflected):
    """btz_drag_integral and btz_drag_integral_reflected on float64 tensors
    against the float64 quadrature (tests/test_btz.py's
    _drag_quadrature[_reflected]), at separations up to one winding."""
    rng = np.random.default_rng(41 + reflected)
    fn = btz.btz_drag_integral_reflected if reflected else btz.btz_drag_integral
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    for _ in range(12):
        ra, rb = rng.uniform(1.5 * R_H, 6.0 * R_H, 2)
        dphi = rng.uniform(0.1, 4.0 * np.pi - 0.1)
        _, want = _quadratures(ra, rb, dphi, reflected, M, L)
        assert want > 0
        got = fn(f64(ra), f64(rb), f64(dphi), f64(M), f64(L))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


# --------------------------------------------------------------------------
# the renderer
# --------------------------------------------------------------------------

W = HT = 96


def _scene(ring: int):
    """tests/test_btz.py's opaque-oracle scene on a `ring`-tick ring."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.28, -0.25), (0.0, 0.3)), base_color=(0.2, 0.9, 0.3))
    sb.add(jscene.disc_softbody(3, 1, (-0.2, -0.08), (0.05, 0.0)), base_color=(0.9, 0.4, 0.2))
    jp, jo = sb.build(capacity=256)
    model = JModel(capacity=jp.capacity)
    jbuf = jwl.prefill_inertial(jwl.create(ring, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    t = 0.0
    for _ in range(80):
        jp, _ = model.step(jp)
        t += H
        jbuf = jwl.push_frame(jbuf, jp, t)
    jcam = JCamera.create(pos=(-0.38, 0.0), zoom=1.2)
    port = (convert.worldline_from_numpy(_fields(jbuf)), convert.particles_from_numpy(_fields(jp)),
            convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam)))
    return dict(j=(jbuf, jp, jo, jcam), t=port)


@pytest.fixture(scope="module")
def scene():
    return _scene(1024)


def _jparams(**kw):
    base = jrt.RenderParams(dt=H, num_rays=2048)
    return dataclasses.replace(base, cell_px=jrt.auto_cell_px(base, W, HT, 1.2), **kw)


def _port_params(jp):
    return rt.RenderParams(**{f.name: getattr(jp, f.name)
                              for f in dataclasses.fields(rt.RenderParams)})


def _mismatch(a, b, tol=PIXEL_TOL):
    return np.mean(np.abs(a - b).max(axis=-1) > tol)


def _lit(img):
    return int((img.min(axis=-1) < 0.9).sum())


def _render(scene, jparams, spin=0.0, size=(W, HT)):
    """(port image, port diag, JAX image, JAX diag), images (H, W, 3)."""
    jbuf, jp, jo, jcam = scene["j"]
    buf, p, o, cam = scene["t"]
    jh, th = _holes(spin)
    img, diag = btz.render_btz_with_diag(buf, p.object_index, o, cam, th, *size,
                                         _port_params(jparams))
    jimg, jdiag = jbtz.render_btz_with_diag(jbuf, jp.object_index, jo, jcam, jh, *size, jparams)
    return img.numpy(), diag, np.asarray(jimg), jdiag


def _diag_equal(diag, jdiag):
    """Every RenderDiag counter equal, but pairs_used within PAIR_SEAM of
    JAX's: a crossing whose delay sits on one of the closed forms' seams
    (the a2 < 1e-9 and dphi < 3e-3 branch switches, the travel sense's
    sign) can take the other branch on an ulp of acos or atan2, moving its
    band window by one tick."""
    for name in DIAG:
        a, b = getattr(diag, name), getattr(jdiag, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        if name == "pairs_used":
            assert abs(int(a) - int(b)) <= PAIR_SEAM * int(b), (name, int(a), int(b))
        else:
            assert int(a) == int(b), name


VARIANTS = {"plain": ({}, 0.0), "reflections": ({"btz_reflections": True}, 0.0),
            "spin": ({}, 0.004), "windings": ({"btz_windings": 1}, 0.0)}


@pytest.mark.parametrize("opaque", [False, True], ids=["xray", "opaque"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_render_btz_with_diag_matches_jax(scene, variant, opaque):
    """The pixel gate and every diag counter, in x-ray and opaque mode, for
    the plain hole, the boundary-reflected routes, a spinning hole and the
    winding routes; the horizon disc is black."""
    kw, spin = VARIANTS[variant]
    img, diag, jimg, jdiag = _render(scene, _jparams(opaque=opaque, **kw), spin)
    assert img.shape == (HT, W, 3) and np.isfinite(img).all()
    assert _lit(img) > 50 and int(diag.pairs_used) > 0
    assert (img.max(axis=-1) < 0.05).sum() > 0
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    _diag_equal(diag, jdiag)
    assert diag.retina_dropped is None and diag.segment_dropped is None


def test_extra_routes_add_images(scene):
    """The echo and winding routes find crossings in the T=1024 ring: more
    pairs and more lit pixels than the two direct routes."""
    buf, p, o, cam = scene["t"]
    _, th = _holes(0.0)
    render = lambda **kw: btz.render_btz_with_diag(buf, p.object_index, o, cam, th, W, HT,
                                                   _port_params(_jparams(opaque=False, **kw)))
    base_img, base = render()
    for kw in ({"btz_reflections": True}, {"btz_windings": 1}):
        img, diag = render(**kw)
        assert int(diag.pairs_used) > int(base.pairs_used)
        assert _lit(img.numpy()) > _lit(base_img.numpy())


@pytest.fixture(scope="module")
def occluded():
    """A small scene for the oracle: a disc of 29 particles on the line of
    sight from the camera at (-0.38, 0) to a farther disc of 49, both
    drifting slowly, on an inertially prefilled T=128 ring; a 48x48 view at
    zoom 0.7."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (-0.6, -0.28), (0.0, 0.05)), base_color=(0.2, 0.9, 0.3))
    sb.add(jscene.disc_softbody(3, 1, (-0.49, -0.14), (0.0, 0.02)), base_color=(0.9, 0.4, 0.2))
    jp, jo = sb.build(capacity=128)
    jbuf = jwl.prefill_inertial(jwl.create(128, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    jcam = JCamera.create(pos=(-0.38, 0.0), zoom=0.7)
    port = (convert.worldline_from_numpy(_fields(jbuf)), convert.particles_from_numpy(_fields(jp)),
            convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam)))
    return dict(j=(jbuf, jp, jo, jcam), t=port)


def test_opaque_matches_brute(occluded):
    """The fast opaque render against the port's exhaustive oracle (its
    occlusion walks each pixel's geodesic at 8 points) within
    tests/test_btz.py's budget; the oracle's x-ray image against JAX's
    under the pixel gate; and occlusion doing something in both."""
    buf, p, o, cam = occluded["t"]
    jbuf, jp, jo, jcam = occluded["j"]
    jh, th = _holes(0.0)
    params = _port_params(_jparams())
    xparams = _jparams(opaque=False)
    fast = btz.render_btz_xray(buf, p.object_index, o, cam, th, 48, 48, params).numpy()
    fast_xray = btz.render_btz_xray(buf, p.object_index, o, cam, th, 48, 48,
                                    _port_params(xparams)).numpy()
    oracle = btz.render_btz_brute(buf, p.object_index, o, cam, th, 48, 48, params,
                                  n_samples=8).numpy()
    xray = btz.render_btz_brute(buf, p.object_index, o, cam, th, 48, 48,
                                _port_params(xparams)).numpy()
    jxray = np.asarray(jbtz.render_btz_brute(jbuf, jp.object_index, jo, jcam, jh, 48, 48,
                                             xparams))
    assert _lit(fast) > 20
    assert _mismatch(fast, oracle, ORACLE_TOL) < ORACLE_SHARE
    assert _mismatch(xray, jxray) <= PIXEL_SHARE
    assert np.any(np.abs(oracle - xray) > ORACLE_TOL)
    assert np.any(np.abs(fast - fast_xray) > ORACLE_TOL)


def test_planar_and_alias(scene):
    buf, p, o, cam = scene["t"]
    _, th = _holes(0.0)
    params = _port_params(_jparams())
    a = btz.render_btz(buf, p.object_index, o, cam, th, W, HT, params)
    b = btz.render_btz_xray(buf, p.object_index, o, cam, th, W, HT, params, planar=True)
    assert btz.render_btz is btz.render_btz_xray
    assert b.shape == (3, HT, W) and torch.equal(a, b.permute(1, 2, 0))


# --------------------------------------------------------------------------
# segment_dropped, which the JAX BTZ path throws away
# --------------------------------------------------------------------------


def _route_vcounts(scene, band=6, **kw):
    """Valid crossings per particle of each route's uncompacted layout."""
    buf, p, o, cam = scene["t"]
    params = _port_params(_jparams(band=band, **kw))
    _, th = _holes(0.0)
    out = []
    for r in btz.route_ids(params):
        fn = lambda qx, qy, r=r: btz.route_delay_xy(qx, qy, cam.pos[0], cam.pos[1], th, r)
        pairs, _, none = rt._band_pairs(buf, p.object_index, o, cam, wl.newest_time(buf), W, HT,
                                        params, cull_hull=False, route_lengths=fn)
        assert none is None
        out.append(pairs.pair_valid.reshape(-1, band).sum(dim=1))
    return out


@pytest.mark.parametrize("kw", [{}, {"btz_reflections": True}], ids=["direct", "reflected"])
def test_btz_segment_dropped_oracle(scene, kw):
    """segment_dropped == sum over the routes of sum(max(vcount - k, 0)) at
    segments=2."""
    vcounts = _route_vcounts(scene, **kw)
    want = sum(int(torch.clamp(v - 2, min=0).sum()) for v in vcounts)
    buf, p, o, cam = scene["t"]
    _, th = _holes(0.0)
    _, diag = btz.render_btz_with_diag(buf, p.object_index, o, cam, th, W, HT,
                                       _port_params(_jparams(band=6, segments=2, **kw)))
    assert int(diag.segment_dropped) == want > 0


def test_btz_segments_render_equals_uncompacted_when_nothing_drops(scene):
    """With k at the most valid crossings any particle has on any route,
    nothing drops and the compacted frame equals the uncompacted one (both
    compacted to one pair budget, valid rows in order)."""
    k = max(int(v.max()) for v in _route_vcounts(scene))
    assert 1 < k < 6
    buf, p, o, cam = scene["t"]
    _, th = _holes(0.0)
    base = dict(band=6, pair_budget=2048)
    img0, diag0 = btz.render_btz_with_diag(buf, p.object_index, o, cam, th, W, HT,
                                           _port_params(_jparams(**base)))
    imgk, diagk = btz.render_btz_with_diag(buf, p.object_index, o, cam, th, W, HT,
                                           _port_params(_jparams(segments=k, **base)))
    assert int(diagk.segment_dropped) == 0 and diag0.segment_dropped is None
    assert int(diagk.pairs_used) == int(diag0.pairs_used) > 0
    assert torch.equal(imgk, img0)


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------


def _small(mod, **over):
    """tests/test_btz.py's shrunk btz_hole (48x48, history 32) with discs of
    60 on the config's tracks and a 256-ray retina."""
    cfg = mod.get_config("btz_hole")
    return dataclasses.replace(
        cfg, width=48, height=48, history=32,
        render=dataclasses.replace(cfg.render, num_rays=256),
        scene=dataclasses.replace(cfg.scene, bodies=(
            ("disc", 60, (0.25, 0.50), (0.0, 0.3), (0.2, 0.3, 1.0)),
            ("disc", 60, (0.75, 0.50), (0.0, -0.3), (1.0, 0.3, 0.2)))),
        **over)


FRAMES = 3


@pytest.fixture(scope="module")
def engines():
    """The small btz_hole config, FRAMES frames: the JAX Engine (fused), the
    port's fused Engine and the port's eager (stage-timing) Engine."""
    je = JEngine(_small(jconfig))
    jimgs = [np.asarray(je.run_frame()) for _ in range(FRAMES)]
    pe = Engine(_small(config), device="cpu")
    imgs = [pe.run_frame().numpy().copy() for _ in range(FRAMES)]
    ue = Engine(_small(config, stage_timing=True), device="cpu")
    uimgs = [ue.run_frame().numpy().copy() for _ in range(FRAMES)]
    return je, jimgs, pe, imgs, ue, uimgs


def test_engine_btz_matches_jax(engines):
    je, jimgs, pe, imgs, _, _ = engines
    assert je._can_fuse() and pe._can_fuse()
    np.testing.assert_array_equal(pe.worldline.times.numpy(), np.asarray(je.worldline.times))
    act = pe.particles.active.numpy()
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=1e-5, atol=1e-6)
    for img, jimg in zip(imgs, jimgs):
        assert _mismatch(img, jimg) <= PIXEL_SHARE
        assert (img.max(axis=-1) < 0.05).sum() > 0  # the horizon disc
    _diag_equal(pe.last_diag, je.last_diag)
    hole, jhole = pe._btz_hole(), je._btz_hole()
    for f in ("center", "mass", "ads_l", "spin"):
        np.testing.assert_array_equal(getattr(hole, f).numpy(), np.asarray(getattr(jhole, f)))


def test_btz_fused_matches_unfused(engines):
    _, _, pe, imgs, ue, uimgs = engines
    assert not ue._can_fuse() and ue.graph_stats["eager"] == FRAMES
    for a, b in zip(imgs, uimgs):
        np.testing.assert_allclose(a, b, atol=2e-5)
    assert len(pe._fused_cache) == 1


def test_fused_key_tracks_the_btz_geometry():
    """New BTZ geometry between frames makes a new fused frame (the key
    holds config.btz, as JAX's does), and its image changes."""
    eng = Engine(_small(config), device="cpu")
    eng.run_frame()
    first = eng.render().numpy()
    eng.config = dataclasses.replace(eng.config, btz=((0.5, 0.45), 0.05, 0.45, 0.002))
    eng.run_frame()
    assert len(eng._fused_cache) == 2
    assert not np.array_equal(eng.render().numpy(), first)


def test_four_route_pair_budget_overflow_grows_the_budget(caplog):
    """The 4-route layout (btz_reflected) overflows a small shared
    pair_budget: the Engine warns and doubles it, as for the conical
    routes."""
    cfg = config.get_config("btz_reflected")
    cfg = dataclasses.replace(
        cfg, width=48, height=48, history=256, diag_every=1,
        render=dataclasses.replace(cfg.render, num_rays=256, pair_budget=64),
        scene=dataclasses.replace(cfg.scene, bodies=(
            ("disc", 60, (0.25, 0.50), (0.0, 0.3), (0.2, 0.3, 1.0)),
            ("disc", 60, (0.75, 0.50), (0.0, -0.3), (1.0, 0.3, 0.2)))))
    eng = Engine(cfg, device="cpu")
    assert len(btz.route_ids(eng._render_params())) == 4
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


def test_btz_hole_first_frame_at_full_physics_matches_jax():
    """btz_hole's first render at its full physics (6,002 of 8,192 particles
    on the inertially prefilled T=512 ring; the image cut to 64x64 and 256
    rays) in JAX and in the port: the image under the pixel gate, the bin
    drops and pairs within 1% and the band truncations within 5% of JAX's.
    Those truncations are the f32 closed form's: where its smaller root
    (a1 - sq) / (2 a2) cancels (the ring's far tails) both packages' delays
    stray from the float64 ones by over 1e-2, each its own way, and the
    same sweep over JAX's float64 delays truncates none."""
    def shrink(mod):
        cfg = mod.get_config("btz_hole")
        return dataclasses.replace(cfg, width=64, height=64,
                                   render=dataclasses.replace(cfg.render, num_rays=256))

    je, pe = JEngine(shrink(jconfig)), Engine(shrink(config), device="cpu")
    np.testing.assert_array_equal(pe.worldline.pos_x.numpy(), np.asarray(je.worldline.pos_x))
    params = pe._render_params()
    cam, jcam, hole, jhole = pe.camera, je.camera, pe._btz_hole(), je._btz_hole()
    jcx, jcy = np.asarray(jcam.pos[0]), np.asarray(jcam.pos[1])
    for route in (0, 1):
        seen = {}

        def ours(qx, qy):
            seen["q"] = qx.numpy(), qy.numpy()
            seen["ours"] = btz.route_delay_xy(qx, qy, cam.pos[0], cam.pos[1], hole, route)
            return seen["ours"]

        def exact(qx, qy):
            seen["exact"] = _jax64(lambda x, y, cx, cy, h: jbtz.route_delay_xy(x, y, cx, cy, h,
                                                                                 route),
                                   qx.numpy(), qy.numpy(), jcx, jcy, hole=jhole)
            return torch.tensor(seen["exact"])

        sweep = lambda fn: int(band_cuda.cone_band_window_plain(pe.worldline, params, cam,
                                                                route_lengths=fn).truncated)
        n_ours, n_exact = sweep(ours), sweep(exact)
        outside = seen["exact"] < 1e30
        err = lambda d: np.abs(np.asarray(d, np.float64) - seen["exact"])[outside].max()
        jfn = jax.jit(lambda x, y: jbtz.route_delay_xy(x, y, jcam.pos[0], jcam.pos[1], jhole,
                                                       route))
        e_ours, e_ref = err(seen["ours"].numpy()), err(jfn(*seen["q"]))
        print(f"btz_hole route {route}: band truncations port {n_ours}, float64 {n_exact}; "
              f"largest |f32 - float64| delay on the sweep JAX {e_ref:.6f}, port {e_ours:.6f}")
        assert n_ours > 100 and n_exact == 0 and e_ref > 1e-2 and e_ours > 1e-2
    img, diag = btz.render_btz_with_diag(pe.worldline, pe.particles.object_index, pe.objects,
                                         cam, hole, 64, 64, params)
    jimg, jdiag = jax.jit(lambda b, oi, o, c, h: jbtz.render_btz_with_diag(
        b, oi, o, c, h, 64, 64, je._render_params()))(
        je.worldline, je.particles.object_index, je.objects, jcam, jhole)
    img, jimg = img.numpy(), np.asarray(jimg)
    counts = {name: (int(getattr(diag, name)), int(getattr(jdiag, name)))
              for name in ("band_truncated", "bin_dropped", "pairs_used")}
    print(f"btz_hole's first render, (port, JAX): {counts}")
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    for name, share in (("band_truncated", 0.05), ("bin_dropped", 0.01), ("pairs_used", 0.01)):
        ours, ref = counts[name]
        assert ref > 0 and abs(ours - ref) <= share * ref, (name, ours, ref)


def test_profile_ranges_reach_the_btz_sub_stages(scene):
    """The program's sub-stage spans open on the BTZ render's sub-stages
    (each route's band sweep, the compaction, the view tables with the
    splat inside, the bearing retina, the pixel optics, the route pass)
    under a plain torch.profiler trace; a route's band sweep is the
    innermost span over its band search (raytrace's own `cone sweep +
    pairs` does not open inside it)."""
    buf, p, o, cam = scene["t"]
    _, th = _holes(0.0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    params = _port_params(_jparams(pair_budget=256))
    with torch.profiler.profile(activities=acts) as prof:
        btz.render_btz_with_diag(buf, p.object_index, o, cam, th, W, HT, params)
    names = {e.name for e in prof.events()}
    for label in ("band sweep + pairs, route 0", "band sweep + pairs, route 1",
                  "pair compaction", "view tables", "splat CSR", "bearing retina",
                  "route optics (all pixels)", "route pass"):
        assert label in names, label
    assert "cone sweep + pairs" not in names
