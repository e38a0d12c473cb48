"""The port's Engine against the JAX Engine on the CPU, at the tiny config of
tests/test_engine.py (one 50-particle disc, capacity 256, 48x48, history
32): 15 frames in each of the three ported modes, the budget adaptation
rules on synthetic diagnostics, and the render parameters chosen at
several zooms.  The JAX side runs as its own tests run it on the CPU (the
fused frame, XLA render paths).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import engine as engine_mod
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config

FRAMES = 15
# positions: the same physics in another f32 order (tests/test_torch_slice.py)
POS_ATOL = 1e-5
# images: at most 0.1% of pixels may flip at capsule edges (test_torch_slice.py)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
MODES = ("points", "retarded", "instant")


def _tiny(mod, rp, **kw):
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256),
        render=rp(num_rays=256), width=48, height=48, history=32)
    base.update(kw)
    return mod.EngineConfig(**base)


def _shared(port, ref):
    """Fields of a port dataclass with their JAX counterparts' values."""
    return ({f.name: getattr(port, f.name) for f in dataclasses.fields(port)},
            {f.name: getattr(ref, f.name) for f in dataclasses.fields(port)})


@pytest.fixture(scope="module")
def runs():
    """Per mode: (JAX final state, JAX images, port engine, port images)."""
    out = {}
    for mode in MODES:
        je = JEngine(_tiny(jconfig, jrt.RenderParams, render_mode=mode))
        jimgs = []
        je.run(FRAMES, on_frame=lambda i, img: jimgs.append(np.asarray(img)))
        pe = Engine(_tiny(config, rt.RenderParams, render_mode=mode), device="cpu")
        imgs = []
        pe.run(FRAMES, on_frame=lambda i, img: imgs.append(img.numpy().copy()))
        out[mode] = (je, jimgs, pe, imgs)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_engine_frames_match_jax(runs, mode):
    je, jimgs, pe, imgs = runs[mode]
    act = np.asarray(je.particles.active)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    assert pe.frame == je.frame == FRAMES and pe.time == pytest.approx(je.time, abs=1e-9)
    assert len(imgs) == FRAMES and imgs[0].shape == (48, 48, 3)
    assert np.isfinite(imgs[-1]).all() and (imgs[-1].min(-1) < 0.9).any()
    if mode == "points":
        # equal coverage, and each covered pixel shows the disc's colour
        # (the JAX scatter keeps the last writer, the port the lowest index)
        for img, jimg in zip(imgs, jimgs):
            cov = np.any(img != 1.0, axis=-1)
            np.testing.assert_array_equal(cov, np.any(jimg != 1.0, axis=-1))
            np.testing.assert_array_equal(img[cov], np.broadcast_to((0.2, 0.2, 1.0), img[cov].shape)
                                          .astype(np.float32))
    else:
        for img, jimg in zip(imgs, jimgs):
            assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE


def test_engine_diag_matches_jax(runs):
    je, _, pe, _ = runs["retarded"]
    for name in ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small",
                 "retina_dropped", "entry_dropped"):
        a, b = getattr(pe.last_diag, name), getattr(je.last_diag, name)
        assert (a is None) == (b is None) and (a is None or int(a) == int(b)), name
    assert int(pe.last_diag.pairs_used) > 0


def test_render_params_match_jax_at_zooms():
    """The cell ladder, the boosts and the view-derived max_age agree field
    for field, at zooms from deep zoom-in to far out."""
    kw = dict(width=256, height=128, history=512)
    rkw = dict(num_rays=256, pair_budget=4096, entry_budget=8192, retina_budget=512, segments=2)
    je = JEngine(_tiny(jconfig, jrt.RenderParams, **kw, render=jrt.RenderParams(**rkw)))
    pe = Engine(_tiny(config, rt.RenderParams, **kw, render=rt.RenderParams(**rkw)), device="cpu")
    seen = set()
    for boosts in ((0, 0, 0, 0, 0, 0), (2, 64, 1, 2, 1, 1)):
        for eng in (je, pe):
            for name, v in zip(Engine._ADAPT_FIELDS, boosts):
                setattr(eng, name, v)
        for zoom in (0.01, 0.05, 0.3, 1.0, 2.5):
            je.camera = JCamera(pos=je.camera.pos, zoom=jnp.float32(zoom), vel=je.camera.vel)
            pe.camera = Camera.create(pos=(0.5, 0.5), zoom=zoom, device="cpu")
            ours, ref = _shared(pe._render_params(), je._render_params())
            assert ours == ref, zoom
            seen.add((ours["cell_px"], ours["max_age"]))
    assert len({k for k, _ in seen}) >= 3 and len({a for _, a in seen}) >= 2


def _diag(mod, **kw):
    base = dict(pairs_used=1000, band_truncated=0, bin_dropped=0, cell_too_small=False,
                retina_dropped=0, entry_dropped=0, segment_dropped=0)
    base.update(kw)
    return mod.RenderDiag(**base)


def test_check_diag_adapts_as_jax():
    """A sequence of synthetic RenderDiags: the port raises band,
    bin_capacity and every budget exactly as the JAX rules do, through
    their ceilings."""
    rkw = dict(num_rays=128, bin_capacity=64, pair_budget=1024, entry_budget=4096,
               retina_budget=256, segments=2)
    je = JEngine(_tiny(jconfig, jrt.RenderParams, diag_every=1, render=jrt.RenderParams(**rkw)))
    pe = Engine(_tiny(config, rt.RenderParams, diag_every=1, render=rt.RenderParams(**rkw)),
                device="cpu")
    je.last_aux = None
    seq = [dict(bin_dropped=500), dict(bin_dropped=1), dict(band_truncated=3),
           dict(pairs_used=5000), dict(retina_dropped=7), dict(entry_dropped=9),
           dict(segment_dropped=4), dict(cell_too_small=True)]
    seq += [dict(band_truncated=1, bin_dropped=5000, pairs_used=1 << 20, retina_dropped=1,
                 entry_dropped=1, segment_dropped=1)] * 6  # to every ceiling
    for change in seq:
        je.last_diag = _diag(jrt, **{k: np.asarray(v) for k, v in change.items()})
        pe.last_diag = _diag(rt, **{k: torch.tensor(v) for k, v in change.items()})
        je._check_diag()
        pe._check_diag()
        for name in Engine._ADAPT_FIELDS:
            assert getattr(pe, name) == getattr(je, name), (name, change)
    assert pe._band_boost == 6 and pe._cap_boost == 384 - 64
    assert pe._pair_boost == pe._retina_boost == pe._entry_boost == pe._seg_boost == 4
    ours, ref = _shared(pe._render_params(), je._render_params())
    assert ours == ref


def test_build_scene_matches_jax():
    from spacetime_tpu.engine import build_scene as jbuild

    spec = dict(bodies=(("disc", 200, (0.1, 0.2), (0.1, 0.0), (1, 0, 0)),
                        ("box", (7, 3), (0.4, 0.2), (0.0, -0.1), (0, 1, 0))),
                material_indices=(0, 1))
    jp, jo = jbuild(jconfig.SceneSpec(**spec))
    p, o = engine_mod.build_scene(config.SceneSpec(**spec), device="cpu")
    for a, b in ((p, jp), (o, jo)):
        for f in dataclasses.fields(a):
            if getattr(a, f.name) is not None:
                np.testing.assert_array_equal(getattr(a, f.name).numpy(),
                                              np.asarray(getattr(b, f.name)), f.name)
