"""`segments` rank compaction and the 2x2 splat (`splat_cells=4`) of the
port's retarded renderer against the JAX package's XLA path
(`backend="xla"`, as its own CPU tests run it), and the oracle the
reference never had: a particle keeps its first `segments` valid crossings,
`segment_dropped` counts the rest, and with nothing dropped the compacted
render equals the uncompacted one.

The scene: two lattice discs approaching each other at 0.25c, a T=64
inertially prefilled ring plus one pushed tick, a 96x64 view (the frame of
tests/test_torch_render.py).  Both packages get the same numpy state.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.utils import logging as logmod
from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec

H = 0.005
W, HT = 96, 64
# the port's tolerances (tests/test_torch_render.py): f32 results of the
# same formulas in XLA and torch; whole images at most 0.1% of pixels off
F32 = dict(rtol=1e-5, atol=1e-5)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
DIAG = ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small", "retina_dropped",
        "entry_dropped", "segment_dropped")


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
    return rt.RenderParams(**{f.name: getattr(jp, f.name)
                              for f in dataclasses.fields(rt.RenderParams)})


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


def _pairs(frame, jparams):
    """(JAX (pairs, truncated, dropped), port (pairs, truncated, dropped))."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    ref = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor], W, HT,
                          jparams)
    ours = rt._band_pairs(buf, tp.object_index, to, cam, wl.newest_time(buf), W, HT,
                          _port_params(jparams))
    return ref, ours


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


def _diag_equal(diag, jdiag):
    for name in DIAG:
        a, b = getattr(diag, name), getattr(jdiag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name


def _vcount(frame, band=6):
    """Valid crossings per particle of the uncompacted layout."""
    (_, _, _), (pairs, _, _) = _pairs(frame, _jparams(band=band))
    return pairs.pair_valid.reshape(-1, band).sum(dim=1)


# --------------------------------------------------------------------------
# rank compaction
# --------------------------------------------------------------------------


@pytest.mark.parametrize("segments", [1, 2])
def test_band_pairs_with_segments_match_jax(frame, segments):
    """Valid masks equal, valid rows at F32, segment_dropped exactly."""
    (jpairs, jtr, jsd), (pairs, tr, sd) = _pairs(frame, _jparams(segments=segments))
    valid = np.asarray(jpairs.pair_valid)
    assert pairs.pdata.shape == (frame["t"][1].capacity * segments, 10)
    np.testing.assert_array_equal(pairs.pair_valid.numpy(), valid)
    assert int(pairs.n_pairs) == int(jpairs.n_pairs) > 0 and int(tr) == int(jtr)
    assert int(sd) == int(jsd) > 0  # this scene has particles past 2 crossings
    np.testing.assert_allclose(pairs.pdata.numpy()[valid], np.asarray(jpairs.pdata)[valid],
                               **F32)


@pytest.mark.parametrize("segments", [1, 2, 3])
def test_segments_oracle(frame, segments):
    """segment_dropped == sum(max(vcount - k, 0)), and each particle's k
    rows are its first k valid rows of the uncompacted layout, in age order
    (its youngest crossings are the ones dropped)."""
    band = 6
    (_, _, _), (full, _, none) = _pairs(frame, _jparams(band=band))
    (_, _, _), (comp, _, dropped) = _pairs(frame, _jparams(band=band, segments=segments))
    assert none is None
    vcount = full.pair_valid.reshape(-1, band).sum(dim=1)
    assert int(dropped) == int(torch.clamp(vcount - segments, min=0).sum())
    fv = full.pair_valid.reshape(-1, band)
    fd = full.pdata.reshape(-1, band, 10)
    cv = comp.pair_valid.reshape(-1, segments)
    cd = comp.pdata.reshape(-1, segments, 10)
    assert torch.equal(cv.sum(dim=1), torch.clamp(vcount, max=segments))
    for i in torch.nonzero(vcount).flatten().tolist():
        rows = fd[i][fv[i]][:segments]
        assert torch.equal(cd[i][cv[i]], rows), i


def test_segments_render_equals_uncompacted_when_nothing_drops(frame):
    """With k >= every particle's valid crossings nothing is dropped; the
    valid rows keep their order, so once both layouts are compacted to a
    pair budget below N k the frames are bit-equal; with no budget (the
    invalid rows sit elsewhere, and equal splat keys tie by row) the pixel
    gate holds."""
    k = int(_vcount(frame).max())
    n = frame["t"][1].capacity
    assert 1 < k < 6
    for budget in (n * k // 2, 0):
        base = dict(band=6, pair_budget=budget, retina_budget=64)
        img0, _, diag0, _ = _images(frame, _jparams(**base))
        imgk, _, diagk, _ = _images(frame, _jparams(segments=k, **base))
        assert int(diagk.segment_dropped) == 0 and diag0.segment_dropped is None
        assert int(diagk.pairs_used) == int(diag0.pairs_used) > 0
        assert int(diagk.retina_dropped) == int(diag0.retina_dropped)
        if budget:
            assert np.array_equal(imgk, img0)
        else:
            assert _mismatch(imgk, img0) <= PIXEL_SHARE
        assert (img0 < 0.99).mean() > 0.05  # the discs are in view


@pytest.mark.parametrize("segments", [1, 2])
def test_boundary_retina_with_segments_matches_jax(frame, segments):
    """The boundary-first compaction with rank compaction on: a particle
    owns `segments` rows, so its boundary flag covers those rows (a
    retina budget below the row count takes that path)."""
    jparams = _jparams(segments=segments, retina_budget=48, pair_budget=0)
    img, jimg, diag, jdiag = _images(frame, jparams)
    _diag_equal(diag, jdiag)
    assert diag.retina_dropped is not None and int(diag.segment_dropped) > 0
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    # the retina prefix holds boundary particles' rows only
    buf, tp, to, cam = frame["t"]
    (_, _, _), (raw, _, _) = _pairs(frame, jparams)
    owner = torch.arange(tp.capacity).repeat_interleave(segments)
    bnd = wl.boundary_mask(tp)
    pairs, n_b = rt._compact_pairs_two_segment(raw, bnd[owner], jparams.pair_budget)
    assert int(n_b) == int((raw.pair_valid & bnd[owner]).sum()) > 0
    front = pairs.pdata[:int(n_b)]
    ids = [int(torch.nonzero((raw.pdata == r).all(dim=1))[0]) for r in front[:8]]
    assert all(bool(bnd[owner[i]]) for i in ids)


# --------------------------------------------------------------------------
# the 2x2 splat
# --------------------------------------------------------------------------


@pytest.mark.parametrize("camera_frame", [False, True])
def test_splat_keys_2x2_match_jax(frame, camera_frame):
    """Same pairs in: the same keys, values and coverage flag, for the
    nearest-corner 2x2 splat (4 keys a pair) in the ground and the boosted
    view."""
    jbuf, jp, jo, jcam = frame["j"]
    buf, tp, to, cam = frame["t"]
    if camera_frame:
        jcam = dataclasses.replace(jcam, vel=jnp.asarray([0.3, 0.1], jnp.float32))
        cam = dataclasses.replace(cam, vel=torch.tensor([0.3, 0.1]))
    jparams = _jparams(splat_cells=4, camera_frame=camera_frame)
    jpairs, _, _ = jrt._band_pairs(jbuf, jp.object_index, jo, jcam, jbuf.times[jbuf.cursor],
                                   W, HT, jparams, cull_hull=not camera_frame)
    pairs = rt.PairData(pdata=torch.from_numpy(np.array(jpairs.pdata)),
                        pair_valid=torch.from_numpy(np.array(jpairs.pair_valid)),
                        n_pairs=torch.tensor(int(jpairs.n_pairs)))
    jkey, jval, jwc, jhc, _, jsmall = jrt._splat_keys(jpairs, jcam, W, HT, jparams)
    key, val, wc, hc, _, small = rt._splat_keys(pairs, cam, W, HT, _port_params(jparams))
    assert key.shape == (pairs.pdata.shape[0] * 4,) and (wc, hc) == (jwc, jhc)
    np.testing.assert_array_equal(key.numpy(), np.asarray(jkey))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    assert bool(small) == bool(jsmall)
    used = (key < wc * hc * rt._DQ).reshape(-1, 4).sum(dim=1)
    assert int(used.max()) > 1  # pairs reach into neighbouring cells


@pytest.mark.parametrize("case", [dict(), dict(segments=2), dict(cell_px=9),
                                  dict(bin_capacity=6, entry_budget=600)])
def test_render_2x2_splat_matches_jax(frame, case):
    """render_retarded with splat_cells=4 under the pixel gate, every diag
    counter equal (with rank compaction, at another cell size, and with
    bin and entry drops)."""
    img, jimg, diag, jdiag = _images(frame, _jparams(splat_cells=4, **case))
    assert img.shape == (3, HT, W) and np.isfinite(img).all()
    assert (img < 0.99).mean() > 0.05
    assert _mismatch(img, jimg) <= PIXEL_SHARE
    _diag_equal(diag, jdiag)
    if "bin_capacity" in case:
        assert int(diag.bin_dropped) > 0 and int(diag.entry_dropped) > 0


@pytest.mark.parametrize("splat_cells", [9, 4])
def test_cell_too_small_at_twice_the_reach(frame, splat_cells):
    """Cells between the reach and twice it: enough for the 3x3 splat, too
    small for the 2x2 one, as the JAX package says."""
    jbuf, jp, jo, jcam = frame["j"]
    base = _jparams()
    pixel = 0.15 / W
    cell = int(np.ceil(1.5 * base.reach / pixel))  # 1.5 reach: between the two bounds
    assert base.reach <= cell * pixel < 2 * base.reach
    img, jimg, diag, jdiag = _images(frame, _jparams(cell_px=cell, splat_cells=splat_cells))
    assert bool(diag.cell_too_small) == bool(jdiag.cell_too_small) == (splat_cells == 4)
    # auto_cell_px ignores splat_cells, as the JAX function does
    p = _port_params(_jparams(splat_cells=splat_cells))
    assert rt.auto_cell_px(p, W, HT, 0.15) == jrt.auto_cell_px(base, W, HT, 0.15)


# --------------------------------------------------------------------------
# the Engine's segments adaptation
# --------------------------------------------------------------------------


def test_grow_budget_logs_the_clamped_segments(caplog):
    """segment_dropped > 0 doubles `segments` up to the band, and the log
    names the value _render_params applies (the JAX Engine logs the
    unclamped 2 << boost)."""
    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=rt.RenderParams(num_rays=256, band=6, segments=2), width=48, height=48,
        history=32, diag_every=1)
    eng = Engine(cfg, device="cpu")
    logger = logmod.get()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=logmod.NAME):
            applied = []
            for _ in range(3):
                eng.last_diag = rt.RenderDiag(*(torch.tensor(0) for _ in range(6)),
                                              segment_dropped=torch.tensor(7))
                eng._check_diag()
                applied.append(eng._render_params().segments)
    finally:
        logger.removeHandler(caplog.handler)
    logged = [int(r.getMessage().rsplit(" ", 1)[1]) for r in caplog.records
              if "segments slots" in r.getMessage()]
    assert applied == [4, 6, 6] and logged == applied  # JAX would log 4, 8, 16
    assert eng._seg_boost == 3


def test_refdemo_params_are_the_reference_demos_but_two():
    """headline.refdemo_params is tools/refdemo.py's render_params with
    bin_capacity 128 and segments 3 (each the smallest value at which the
    reference demo's frame drops nothing); every other field the port has
    is the reference's."""
    import importlib.util
    import pathlib

    from spacetime_tpu_torch import headline

    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / "refdemo.py"
    spec = importlib.util.spec_from_file_location("refdemo_tool", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    ref, ours = tool.render_params(H), headline.refdemo_params(H)
    differ = {f.name: (getattr(ours, f.name), getattr(ref, f.name))
              for f in dataclasses.fields(rt.RenderParams)
              if getattr(ours, f.name) != getattr(ref, f.name)}
    assert differ == {"bin_capacity": (128, 96), "segments": (3, 2)}
    assert ours.splat_cells == 4 and 0 < ours.segments < ours.band
