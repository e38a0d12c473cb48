"""The exact rotating-BTZ optics of the port (spacetime_tpu_torch.ops.
btz_exact) against the JAX package on the CPU.

The solver bisects 54 times inside per-branch brackets; once |F - target|
is below f32 noise the bisection random-walks, and an ulp of difference
between XLA's and torch's exp, log or atan2 can flip a step.  Its own
budget is about 1e-3 relative delay error (spacetime_tpu/ops/btz_exact.py),
so exact delays are held to JAX at 1e-3 relative, the fallback masks
exactly.  Next to the mono/apo junction JAX is not reproducible to that
budget itself: its jitted batch and its op-by-op solve of one point
differ by up to 6e-3 there (its 1e-2 acceptance admits both).  So every
delay must be within 1e-3 of one of JAX's two evaluations, and at least
90% within 1e-3 of the jitted batch.  The exact-spin render is held to
JAX at that budget: at most 1% of pixels off by more than 0.05
(tests/test_btz_exact.py's J = 0 bound).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.ops import btz as jbtz
from spacetime_tpu.ops import btz_exact as jexact
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.ops import btz, btz_exact

M, L = 0.03, 0.45  # extremal at |J| = M l = 0.0135
R_H = L * math.sqrt(M)
CAM = (0.1, -0.35)
DELAY_RTOL = 1e-3
BEARING_TOL = 1e-2


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


def _holes(spin):
    jh = jbtz.BTZBlackHole.create(center=(0.0, 0.0), mass=M, ads_l=L, spin=spin)
    return jh, convert.btz_hole_from_numpy(jh)


def _scene_grid():
    """tests/test_btz_exact.py's test_no_fallbacks_on_scene_grid points."""
    rng = np.random.default_rng(11)
    r = rng.uniform(2.5 * R_H, 6.0 * R_H, 24).astype(np.float32)
    th = rng.uniform(-math.pi, math.pi, 24).astype(np.float32)
    return r * np.cos(th), r * np.sin(th)


def _port_optics(qx, qy, hole, route, cam=CAM):
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    return btz_exact.exact_route_optics_xy(t(qx), t(qy), t(cam[0]), t(cam[1]), hole, route)


def _jax_optics(qx, qy, hole, route, cam=CAM):
    return jax.jit(jexact.exact_route_optics_xy, static_argnums=(5,))(
        jnp.asarray(qx, jnp.float32), jnp.asarray(qy, jnp.float32), jnp.float32(cam[0]),
        jnp.float32(cam[1]), hole, route)


def _wrapped(a, b):
    return np.abs((np.asarray(a, np.float64) - b + np.pi) % (2 * np.pi) - np.pi)


@pytest.mark.parametrize("route", range(8))
def test_exact_optics_match_jax_without_fallbacks(route):
    """Near-extremal spin (89% of M l) on the scene grid, every route: the
    fallback masks equal and empty; every delay within 1e-3 relative of
    JAX's jitted batch or of JAX's op-by-op solve of that one point, and at
    least 90% within 1e-3 of the batch; bearings and emitter directions
    within 1e-2."""
    jh, th = _holes(0.012)
    qx, qy = _scene_grid()
    b, d, nx, ny, fb = (x.numpy() for x in _port_optics(qx, qy, th, route))
    jb, jd, jnx, jny, jfb = (np.asarray(x) for x in _jax_optics(qx, qy, jh, route))
    np.testing.assert_array_equal(fb, jfb)
    assert not fb.any()
    rel = lambda a, ref: np.abs(np.asarray(a, np.float64) - ref) / np.abs(ref)
    off = rel(d, jd) > DELAY_RTOL
    assert off.mean() <= 0.1
    for i in np.flatnonzero(off):
        one = jexact.exact_route_optics_xy(jnp.asarray(qx[i:i + 1]), jnp.asarray(qy[i:i + 1]),
                                           jnp.float32(CAM[0]), jnp.float32(CAM[1]), jh, route)
        assert rel(d[i], float(one[1][0])) <= DELAY_RTOL, (i, d[i], jd[i], float(one[1][0]))
    assert _wrapped(b, jb).max() < BEARING_TOL
    assert np.abs(nx - jnx).max() < BEARING_TOL and np.abs(ny - jny).max() < BEARING_TOL
    np.testing.assert_array_equal(
        btz_exact.exact_route_delay_xy(*(torch.from_numpy(np.array(v, np.float32))
                                         for v in (qx, qy, CAM[0], CAM[1])), th, route).numpy(),
        d)


@pytest.mark.parametrize("route", range(8))
def test_exact_reduces_to_slow_rotation_at_zero_spin(route):
    """J = 0: the exact solve reproduces the static closed forms on every
    route class, with no fallback (tests/test_btz_exact.py's bounds)."""
    _, th = _holes(0.0)
    pts = np.array([(0.3, 0.25), (-0.33, 0.1), (-0.2, -0.3), (0.15, 0.3), (-0.1, 0.25)],
                   np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    args = (t(pts[:, 0]), t(pts[:, 1]), t(CAM[0]), t(CAM[1]))
    b0, d0, x0, _ = btz.route_optics_xy(*args, th, route)
    b1, d1, x1, _, fb = btz_exact.exact_route_optics_xy(*args, th, route)
    assert not fb.any()
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=4e-3)
    assert (b1 - b0).abs().max() < 5e-3 and (x1 - x0).abs().max() < 5e-3


def test_solver_pieces_match_jax():
    """The closed-form brackets and segment integrals the bisection runs on:
    _horizons_x, _k_edge_rr2, _k_apo_edge and _path on each branch, at
    spins 0.004 and -0.012, rtol = atol = 1e-5."""
    rng = np.random.default_rng(3)
    xc = rng.uniform((1.5 * R_H) ** 2, (6 * R_H) ** 2, 256).astype(np.float32)
    xq = rng.uniform((1.5 * R_H) ** 2, (6 * R_H) ** 2, 256).astype(np.float32)
    k = rng.uniform(0.01, 0.44, 256).astype(np.float32)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    close = lambda a, b: np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                                    atol=1e-5, equal_nan=True)
    for spin in (0.004, -0.012):
        jm, jl, jj = jnp.float32(M), jnp.float32(L), jnp.float32(spin)
        m, l, j = t(M), t(L), t(spin)
        for a, b in zip(btz_exact._horizons_x(m, l, j), jexact._horizons_x(jm, jl, jj)):
            close(a, b)
        close(btz_exact._k_edge_rr2(t(xc), m, l, j), jexact._k_edge_rr2(xc, jm, jl, jj))
        close(btz_exact._k_apo_edge(t(xc), m, l, j), jexact._k_apo_edge(xc, jm, jl, jj))
        for branch in ("mono", "apo", "peri", "bounce"):
            ours = btz_exact._path(t(xc), t(xq), t(k), m, l, j, branch)
            ref = jexact._path(xc, xq, k, jm, jl, jj, branch)
            assert np.array_equal(np.isnan(ours[0].numpy()), np.isnan(np.asarray(ref[0])))
            close(*(torch.nan_to_num(o) for o in ours[:1]), np.nan_to_num(np.asarray(ref[0])))
            finite = ~np.isnan(np.asarray(ref[0]))
            np.testing.assert_allclose(ours[1].numpy()[finite], np.asarray(ref[1])[finite],
                                       rtol=1e-5, atol=1e-5)


def test_fallback_marks_the_slow_rotation_values():
    """An endpoint inside the horizon brackets nothing: fallback is set
    there, and the slow-rotation values (the delay's +BIG) stand, as in
    JAX."""
    jh, th = _holes(0.012)
    qx = np.array([0.3, 0.5 * R_H], np.float32)
    qy = np.array([0.25, 0.0], np.float32)
    b, d, _, _, fb = _port_optics(qx, qy, th, 0)
    jb, jd, _, _, jfb = _jax_optics(qx, qy, jh, 0)
    np.testing.assert_array_equal(fb.numpy(), [False, True])
    np.testing.assert_array_equal(fb.numpy(), np.asarray(jfb))
    slow = btz.route_optics_xy(*(torch.from_numpy(np.array(v, np.float32))
                                 for v in (qx, qy, CAM[0], CAM[1])), th, 0)
    assert float(d[1]) == float(slow[1][1]) == np.float32(3.0e38) == float(np.asarray(jd)[1])
    assert float(b[1]) == float(slow[0][1])


def test_extremal_fallbacks_on_the_ring_match_jax():
    """btz_extremal's prefilled ring at its full physics (every 16th tick
    and every 4th particle: 47,968 of route 0's sweep points; the image
    size, which the solve does not read, is cut): the solver falls back to
    the slow-rotation values at about 1% of the points outside the horizon
    in JAX and in the port alike (mostly the ring's far tails, where no
    branch brackets the target); the port's share within 10% of JAX's, the
    masks differing at under 1% of the points."""
    from spacetime_tpu_torch.engine import Engine
    from spacetime_tpu_torch.utils import config

    eng = Engine(dataclasses.replace(config.get_config("btz_extremal"), width=64, height=64),
                 device="cpu")
    hole, cam, buf = eng._btz_hole(), eng.camera, eng.worldline
    jh = jbtz.BTZBlackHole.create(*(np.asarray(getattr(hole, f)) for f in
                                    ("center", "mass", "ads_l", "spin")))
    cols = torch.arange(0, buf.num_particles, 4)
    cols = cols[eng.particles.active[cols]]
    qx, qy = (plane[:buf.capacity:16][:, cols].reshape(-1) for plane in (buf.pos_x, buf.pos_y))
    fb = btz_exact.exact_route_optics_xy(qx, qy, cam.pos[0], cam.pos[1], hole, 0)[4].numpy()
    jfb = np.asarray(_jax_optics(qx.numpy(), qy.numpy(), jh, 0,
                                 cam=(float(cam.pos[0]), float(cam.pos[1])))[4])
    hx, hy = (float(v) for v in hole.center)
    outside = np.hypot(qx.numpy() - hx, qy.numpy() - hy) > float(hole.r_h)
    share, jshare = (fb & outside).mean(), (jfb & outside).mean()
    print(f"btz_extremal route 0 over {fb.size} ring points: fallbacks outside the horizon "
          f"JAX {jshare:.6f}, port {share:.6f}; masks differ at {(fb != jfb).mean():.6f}")
    assert jshare > 0.005 and abs(share - jshare) <= 0.1 * jshare
    assert (fb != jfb).mean() < 0.01


def test_exact_spin_render_matches_jax():
    """render_btz_xray with btz_exact_spin on tests/test_btz_exact.py's
    64x64 scene (a disc passing the hole, an inertially pushed T=256 ring)
    at near-extremal spin: at most 1% of pixels off by more than 0.05, the
    diag counters equal but pairs_used (within 1%, see tests/
    test_torch_btz.py), images drawn, and the frame dragging moving image
    area against the hole at J = 0."""
    from spacetime_tpu import scene as jscene
    from spacetime_tpu.camera import Camera as JCamera
    from spacetime_tpu.ops import raytrace as jrt
    from spacetime_tpu.ops import worldline as jwl
    from spacetime_tpu_torch.ops import raytrace as rt

    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.25, -0.3), (0.0, 0.4)), base_color=(0.2, 0.9, 0.3))
    jp, jo = sb.build(capacity=256)
    jbuf = jwl.create(256, jp.capacity)
    for k in range(256):
        jbuf = jwl.push_frame(jbuf, dataclasses.replace(jp, pos=jp.pos + jp.vel * (k * 0.005)),
                              time=k * 0.005)
    jcam = JCamera.create(pos=(-0.35, 0.0), zoom=1.4)
    base = jrt.RenderParams(dt=0.005, opaque=False)
    jparams = dataclasses.replace(base, cell_px=jrt.auto_cell_px(base, 64, 64, 1.4),
                                  btz_exact_spin=True)
    params = rt.RenderParams(**{f.name: getattr(jparams, f.name)
                                for f in dataclasses.fields(rt.RenderParams)})
    fields = lambda x: {f.name: np.asarray(getattr(x, f.name))
                        for f in dataclasses.fields(x) if getattr(x, f.name) is not None}
    buf, p = convert.worldline_from_numpy(fields(jbuf)), convert.particles_from_numpy(fields(jp))
    o, cam = convert.objects_from_numpy(fields(jo)), convert.camera_from_numpy(fields(jcam))
    jh, th = _holes(0.012)
    img, diag = btz.render_btz_with_diag(buf, p.object_index, o, cam, th, 64, 64, params)
    jimg, jdiag = jbtz.render_btz_with_diag(jbuf, jp.object_index, jo, jcam, jh, 64, 64, jparams)
    img, jimg = img.numpy(), np.asarray(jimg)
    assert np.isfinite(img).all() and (img.min(axis=-1) < 0.9).sum() > 0
    assert np.mean(np.abs(img - jimg).max(axis=-1) > 0.05) <= 0.01
    for name in ("band_truncated", "bin_dropped", "cell_too_small", "entry_dropped"):
        assert int(getattr(diag, name)) == int(getattr(jdiag, name)), name
    assert abs(int(diag.pairs_used) - int(jdiag.pairs_used)) <= 0.01 * int(jdiag.pairs_used)
    # J = 0, where the exact solve is the static closed form (above)
    _, th0 = _holes(0.0)
    still = btz.render_btz_xray(buf, p.object_index, o, cam, th0, 64, 64,
                                dataclasses.replace(params, btz_exact_spin=False)).numpy()
    assert np.mean(np.abs(img - still).max(axis=-1) > 0.05) > 0.0
