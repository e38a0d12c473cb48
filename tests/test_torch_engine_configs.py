"""The port's Engine on the paths this slice opened, against the JAX Engine
on the CPU: `plastic_collision` (materials, damping, plastic creep),
`boosted_observer` (the camera-frame view) and a `lattice_pad=False` scene
(the row-gather physics), each shrunk to small discs and a 48x48 view, and
`png_demo` (its PNG bodies at full size, a 48x48 view and a 32-tick ring),
each run for a few frames; then what the Engine keeps of creep state (the
checkpoint, particles passed in) and the CLI on the two named configs.
The JAX side runs as its own tests run it on the CPU (the fused frame, XLA
physics and render paths).
"""

import dataclasses

import numpy as np
import pytest
import torch

from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import cli
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config

# through the plastic discs' impact; their damping amplifies f32 rounding
# (the JAX XLA path sums the springs in another order) ~10x a frame after
# frame 9 of the contact
FRAMES = 8
# the tolerances of tests/test_torch_engine.py: positions the same physics
# in another f32 order; at most 0.1% of pixels may flip at capsule edges
POS_ATOL = 1e-5
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
BLUE, RED = config.BLUE, config.RED
# png_demo's two 2,332-particle PNG bodies sum their springs in another f32
# order than JAX's XLA path: positions part by 1 ulp (6e-8) from frame 2,
# and at frame 8 one cone crossing on the band's edge counts in one package
# only (126 against 127 pairs, the images equal); every other counter exact
PAIRS_SLACK = {"png_demo": 1}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The Engines here run thousands of small torch ops; beside the
    suite's other workers each op's intra-op thread team waits on busy
    cores.  One thread a worker keeps their time that of the work."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# per case: the named config it shrinks, its bodies, and config overrides.
# plastic: two 50-particle discs touching within two frames at the config's
# 0.12c each; boosted: two static discs ahead of and beside the 0.5c
# camera; rows: two unpadded 450-particle discs (their row widths give more
# than 8 distinct bond offsets per slot, so the Engine takes the row-gather
# physics).  No camera sits at a pixel-symmetric point: there a ray at
# exactly 45 degrees falls on a retina bin edge, which atan2's last ulp
# decides differently in XLA and torch.
CASES = {
    "plastic_collision": dict(
        bodies=(("disc", 50, (0.40, 0.45), (0.12, 0.0), BLUE),
                ("disc", 50, (0.4295, 0.453), (-0.12, 0.0), RED)),
        scene_kw=dict(material_indices=(0, 1)),
        cfg_kw=dict(cam_pos=(0.4113, 0.4437), cam_zoom=0.2, history=32)),
    "boosted_observer": dict(
        bodies=(("disc", 50, (0.55, 0.45), (0.0, 0.0), BLUE),
                ("disc", 50, (0.40, 0.53), (0.0, 0.0), RED)),
        scene_kw={}, cfg_kw=dict(cam_pos=(0.4513, 0.4437), cam_zoom=0.25, history=256)),
    "lattice_pad_false": dict(
        bodies=(("disc", 450, (0.40, 0.45), (0.1, 0.0), BLUE),
                ("disc", 450, (0.52, 0.452), (-0.1, 0.0), RED)),
        scene_kw=dict(lattice_pad=False),
        cfg_kw=dict(cam_pos=(0.4613, 0.4437), cam_zoom=0.3, history=32)),
    # the config's own two PNG bodies (4,664 particles, read by each
    # package's PNG import), cut to a 48x48 view of a 32-tick ring
    "png_demo": dict(bodies=None, scene_kw={}, cfg_kw=dict(history=32)),
}


def _tiny(mod, rp, case):
    c = CASES[case]
    base = mod.get_config("plastic_collision" if case == "lattice_pad_false" else case)
    render = dataclasses.replace(base.render, num_rays=256)
    if case == "lattice_pad_false":
        base = dataclasses.replace(base, materials=None)
    scene = base.scene if c["bodies"] is None else mod.SceneSpec(
        bodies=c["bodies"], capacity=None, **c["scene_kw"])
    return dataclasses.replace(base, scene=scene, render=render, width=48, height=48,
                               **c["cfg_kw"])


@pytest.fixture(scope="module")
def runs():
    """Per case: (JAX engine, JAX images, port engine, port images)."""
    out = {}
    for case in CASES:
        je = JEngine(_tiny(jconfig, jrt.RenderParams, case))
        jimgs = []
        je.run(FRAMES, on_frame=lambda i, img: jimgs.append(np.asarray(img)))
        pe = Engine(_tiny(config, rt.RenderParams, case), device="cpu")
        imgs = []
        pe.run(FRAMES, on_frame=lambda i, img: imgs.append(img.numpy().copy()))
        out[case] = (je, jimgs, pe, imgs)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_engine_config_frames_match_jax(runs, case):
    je, jimgs, pe, imgs = runs[case]
    act = np.asarray(je.particles.active)
    np.testing.assert_array_equal(pe.particles.active.numpy(), act)
    np.testing.assert_allclose(pe.particles.pos.numpy()[act], np.asarray(je.particles.pos)[act],
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_array_equal(pe.particles.neighbors.numpy(),
                                  np.asarray(je.particles.neighbors))
    assert pe.frame == je.frame == FRAMES
    for img, jimg in zip(imgs, jimgs):
        assert np.isfinite(img).all()
        assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    assert (imgs[-1].min(-1) < 0.9).any()  # matter in view
    for name in ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small"):
        slack = PAIRS_SLACK.get(case, 0) if name == "pairs_used" else 0
        assert abs(int(getattr(pe.last_diag, name)) - int(getattr(je.last_diag, name))) <= slack, \
            name


def test_engine_plastic_creep_state_matches_jax(runs):
    je, _, pe, _ = runs["plastic_collision"]
    act = np.asarray(je.particles.active)
    assert pe.materials is not None and pe.materials.creep_rate is not None
    np.testing.assert_allclose(pe.particles.rest_len.numpy()[act],
                               np.asarray(je.particles.rest_len)[act], rtol=1e-6, atol=1e-9)
    obj = pe.particles.object_index.numpy()
    grown = pe.particles.rest_len.numpy() - pe.config.physics.rest_lengths()[None, :]
    assert grown[act & (obj == 0)].max() > 0  # the blue body crept in the impact
    assert not grown[act & (obj == 1)].any()  # the red body cannot creep


def test_engine_rows_and_camera_frame_paths(runs):
    """The lattice_pad=False scene runs the row-gather physics, and the
    boosted config's view-derived max_age is the JAX Engine's."""
    assert runs["lattice_pad_false"][2].model.spring_offsets is None
    assert runs["plastic_collision"][2].model.spring_offsets is not None
    je, _, pe, _ = runs["boosted_observer"]
    ours, ref = pe._render_params(), je._render_params()
    assert ours.camera_frame and ours.max_age == ref.max_age > 0
    still = dataclasses.replace(pe.config.render, camera_frame=False)
    pe_still = Engine(dataclasses.replace(pe.config, render=still), device="cpu")
    assert ours.max_age > pe_still._render_params().max_age  # the wider ground footprint


def test_checkpoint_round_trips_rest_len(runs, tmp_path):
    _, _, pe, _ = runs["plastic_collision"]
    path = str(tmp_path / "plastic.npz")
    pe.save_checkpoint(path)
    resumed = []
    for _ in range(2):
        eng = Engine(pe.config, device="cpu")
        assert not torch.equal(eng.particles.rest_len, pe.particles.rest_len)
        eng.load_checkpoint(path)
        assert torch.equal(eng.particles.rest_len, pe.particles.rest_len)
        resumed.append(eng)
    for eng in resumed:
        eng.run(2)
    assert torch.equal(resumed[0].particles.rest_len, resumed[1].particles.rest_len)
    assert torch.equal(resumed[0].particles.pos, resumed[1].particles.pos)
    # a creep-free engine has no rest_len and refuses the checkpoint
    plain = Engine(dataclasses.replace(pe.config, materials=None), device="cpu")
    assert plain.particles.rest_len is None
    with pytest.raises(ValueError, match="rest_len is unexpected"):
        plain.load_checkpoint(path, strict=False)


def test_engine_keeps_an_evolved_rest_len(runs):
    """Particles passed in with an evolved rest_len keep it (the Engine
    initializes the creep state only when it is absent)."""
    _, _, pe, _ = runs["plastic_collision"]
    eng = Engine(pe.config, pe.particles, pe.objects, device="cpu")
    assert torch.equal(eng.particles.rest_len, pe.particles.rest_len)


@pytest.mark.parametrize("name", ["boosted_observer", "plastic_collision"])
def test_cli_runs_the_new_configs_on_the_cpu(name):
    eng, img, summary = cli.run(["--config", name, "--frames", "1", "--width", "24",
                                 "--height", "24", "--cpu"])
    assert eng.frame == 1 and img.shape == (24, 24, 3) and torch.isfinite(img).all()
    assert summary["frame_avg_ms"] > 0
    assert (eng.materials is not None) == (name == "plastic_collision")
    assert eng.config.render.camera_frame == (name == "boosted_observer")
