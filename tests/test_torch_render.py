"""Parity of the port's flat retarded renderer (spacetime_tpu_torch.ops.
raytrace + render_cuda's plain pixel pass) with the JAX reference's XLA path
(`backend="xla"`, as the JAX package's own CPU tests run it), at small sizes.

The scene: two lattice discs approaching each other, a T=64 inertially
prefilled ring plus one pushed tick, a 96x64 view.  Both packages get the
same numpy state.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl

H = 0.005
W, HT = 96, 64
# f32 results of the same formulas evaluated by XLA and by torch's CPU
# kernels: equal up to a few ulps
F32 = dict(rtol=1e-5, atol=1e-5)
# whole images: a pixel may flip where an ulp moves a capsule edge or a ray
# across a bin boundary; the JAX suite's own accelerated-vs-oracle tests
# allow 1-3% of pixels, the port is held to 0.1% (measured: 0)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _jparams(**kw):
    base = dict(dt=H, num_rays=512, pair_budget=512, bin_capacity=64, cell_px=16,
                occlusion_downsample=2, ray_chunk=256, retina_budget=128, max_age=48,
                entry_budget=4096, backend="xla")
    base.update(kw)
    return jrt.RenderParams(**base)


def _port_params(jp):
    return rt.RenderParams(**{f.name: getattr(jp, f.name) for f in dataclasses.fields(rt.RenderParams)})


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
    jcam = JCamera.create(pos=(0.39, 0.41), zoom=0.15)
    tp = convert.particles_from_numpy(_fields(jp))
    return dict(
        j=(jbuf, jp, jo, jcam),
        t=(convert.worldline_from_numpy(_fields(jbuf)), tp,
           convert.objects_from_numpy(_fields(jo)), convert.camera_from_numpy(_fields(jcam))),
    )


# --------------------------------------------------------------------------
# shading
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [
    dict(), dict(spectral=True), dict(doppler=False), dict(beaming=False, doppler_strength=0.5),
])
def test_shade_channels_match_jax(rng, mode):
    c = rng.uniform(0, 1, (3, 256)).astype(np.float32)
    d = np.exp(rng.uniform(-1.5, 1.5, 256)).astype(np.float32)
    jp = _jparams(**mode)
    ref = jrt.shade_channels(*(jnp.asarray(x) for x in c), jnp.asarray(d), jp)
    ours = rt.shade_channels(*(torch.from_numpy(x) for x in c), torch.from_numpy(d),
                             _port_params(jp))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32)


# --------------------------------------------------------------------------
# cone band search, pairs, compaction, retina
# --------------------------------------------------------------------------


@pytest.mark.parametrize("band", [6, 2])
def test_cone_band_window_and_pairs_match_jax(frame, band):
    """a0, truncated and the valid pair rows; band=2 forces truncation."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jparams = _jparams(band=band)
    params = _port_params(jparams)
    ja0, jhi0, jtr, _ = jrt._cone_band_window(jbuf, None, jparams, cam=jcam)
    a0, hi0, tr, _ = rt._cone_band_window(buf, params, cam)
    np.testing.assert_array_equal(a0.numpy(), np.asarray(ja0))
    assert hi0 == int(jhi0) and int(tr) == int(jtr)
    assert (int(tr) > 0) == (band == 2)
    t_now = jbuf.times[jbuf.cursor]
    jpairs, jtr2, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, t_now, W, HT, jparams)
    pairs, tr2, _ = rt._band_pairs(buf, tp.object_index, to, cam, buf.times[buf.cursor],
                                   W, HT, params)
    valid = np.asarray(jpairs.pair_valid)
    np.testing.assert_array_equal(pairs.pair_valid.numpy(), valid)
    assert int(pairs.n_pairs) == int(jpairs.n_pairs) > 0 and int(tr2) == int(jtr2)
    np.testing.assert_allclose(pairs.pdata.numpy()[valid], np.asarray(jpairs.pdata)[valid], **F32)


def test_compaction_matches_jax(frame):
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jparams = _jparams()
    jpairs, _, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                   W, HT, jparams)
    pairs, _, _ = rt._band_pairs(buf, tp.object_index, to, cam, buf.times[buf.cursor], W, HT,
                                 _port_params(jparams))
    budget = 96  # below the valid count: the budget cuts
    assert int(pairs.n_pairs) > budget
    a = rt._compact_pairs_to_budget(pairs, budget)
    ja = jrt._compact_pairs_to_budget(jpairs, budget)
    np.testing.assert_array_equal(a.pair_valid.numpy(), np.asarray(ja.pair_valid))
    np.testing.assert_allclose(a.pdata.numpy(), np.asarray(ja.pdata), **F32)
    rmask = wl.boundary_mask(tp).repeat_interleave(jparams.band)
    b, nb = rt._compact_pairs_two_segment(pairs, rmask, budget)
    jb, jnb = jrt._compact_pairs_two_segment(jpairs, jnp.asarray(rmask.numpy()), budget)
    assert int(nb) == int(jnb) > 0
    np.testing.assert_array_equal(b.pair_valid.numpy(), np.asarray(jb.pair_valid))
    np.testing.assert_allclose(b.pdata.numpy(), np.asarray(jb.pdata), **F32)


def test_retina_s_first_matches_jax(frame):
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jparams = _jparams()
    jpairs, _, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                   W, HT, jparams)
    pairs, _, _ = rt._band_pairs(buf, tp.object_index, to, cam, buf.times[buf.cursor], W, HT,
                                 _port_params(jparams))
    ref = np.asarray(jrt._retina(jpairs, jcam, jbuf.times[jbuf.cursor], jparams))
    ours = rt._retina(pairs, cam, buf.times[buf.cursor], _port_params(jparams)).numpy()
    hit = ref < 1e30
    assert 0 < hit.sum() < hit.size  # some rays hit, some see the sky
    np.testing.assert_array_equal(ours < 1e30, hit)
    np.testing.assert_allclose(ours[hit], ref[hit], **F32)


@pytest.mark.parametrize("budgets", [dict(), dict(bin_capacity=6, entry_budget=600),
                                     dict(cell_px=3)])
def test_splat_csr_matches_vslot(frame, budgets):
    """The CSR's per-cell entries are the rows of JAX's vslot table, and the
    diagnostics agree — with no drops, with bin and entry drops, and with
    cells too small for the capsule reach."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jparams = _jparams(**budgets)
    params = _port_params(jparams)
    jpairs, _, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                   W, HT, jparams)
    pairs, _, _ = rt._band_pairs(buf, tp.object_index, to, cam, buf.times[buf.cursor], W, HT,
                                 params)
    vslot, jbin, jent, jsmall, _ = jrt._splat_vslot(jpairs, jcam, W, HT, jparams)
    entries, lo, hi, nbin, nent, small, geom = rt._splat_csr(pairs, cam, W, HT, params)
    assert (int(nbin), int(nent), bool(small)) == (int(jbin), int(jent), bool(jsmall))
    if budgets.get("bin_capacity"):
        assert int(nbin) > 0 and int(nent) > 0
    if budgets.get("cell_px"):
        assert bool(small)
    vs = np.asarray(vslot).reshape(geom[1] * geom[0], -1)
    pd = pairs.pdata.numpy()
    for c in range(vs.shape[0]):
        ids = vs[c][vs[c] >= 0]
        np.testing.assert_array_equal(entries[lo[c]:hi[c]].numpy(), pd[ids])


# --------------------------------------------------------------------------
# whole frames
# --------------------------------------------------------------------------


def _images(frame, jparams, w=W, h=HT):
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    jimg, jdiag = jrt.render_retarded_with_diag(jbuf, jp.object_index, jo, jcam, w, h, jparams,
                                                planar=True, boundary=jwl.boundary_mask(jp))
    img, diag = rt.render_retarded_with_diag(buf, tp.object_index, to, cam, w, h,
                                             _port_params(jparams), planar=True,
                                             boundary=wl.boundary_mask(tp))
    return img.numpy(), np.asarray(jimg), diag, jdiag


def _mismatch(a, b):
    return np.mean(np.abs(a - b).max(axis=0) > PIXEL_TOL)


@pytest.mark.parametrize("opaque", [True, False])
@pytest.mark.parametrize("cell_px", [16, 9])
def test_render_matches_jax(frame, opaque, cell_px):
    img, jimg, diag, jdiag = _images(frame, _jparams(opaque=opaque, cell_px=cell_px))
    assert img.shape == (3, HT, W) and np.isfinite(img).all()
    assert (img < 0.99).mean() > 0.05  # the discs are in view
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    for name in ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small",
                 "retina_dropped", "entry_dropped"):
        a, b = getattr(diag, name), getattr(jdiag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name


def test_render_odd_size_and_pixel_quads_match_jax(frame):
    """A width/height not divisible by the cell size (partial last cells)
    and per-pixel (d = 1) occlusion lookups."""
    img, jimg, _, _ = _images(frame, _jparams(cell_px=9, occlusion_downsample=1), 90, 60)
    assert _mismatch(img, jimg) <= PIXEL_SHARE


def test_brute_oracle_matches_jax_and_fast_path(frame):
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    # no budgets: the fast path's only approximation left is the retina's
    # angular quantization, made fine here
    jparams = _jparams(cell_px=9, occlusion_downsample=1, pair_budget=0, entry_budget=0,
                       num_rays=8192)
    ref = np.asarray(jrt.render_retarded_brute(jbuf, jp.object_index, jo, jcam, 48, 32, jparams))
    ours = rt.render_retarded_brute(buf, tp.object_index, to, cam, 48, 32,
                                    _port_params(jparams)).numpy()
    assert _mismatch(ours.transpose(2, 0, 1), ref.transpose(2, 0, 1)) <= PIXEL_SHARE
    fast = rt.render_retarded(buf, tp.object_index, to, cam, 48, 32, _port_params(jparams))
    # the tolerance of tests/test_render.py's opaque oracle test: the retina
    # quantizes shadow edges to num_rays bins
    assert _mismatch(fast.numpy().transpose(2, 0, 1), ours.transpose(2, 0, 1)) < 0.03


@pytest.mark.parametrize("change", [dict(camera_frame=True), dict(retarded=False),
                                    dict(segments=2)])
def test_unported_modes_raise(frame, change):
    buf, tp, to, cam = frame["t"]
    params = dataclasses.replace(_port_params(_jparams()), **change)
    with pytest.raises(NotImplementedError):
        rt.render_retarded(buf, tp.object_index, to, cam, W, HT, params)
