"""Matter-sourced defects of the port (spacetime_tpu_torch.ops.gravity) against
the JAX package on the CPU: energy centroids, the per-age centroid track,
the retarded centroid (also against the linear closed form and clamped to
a short history), sourced defects and their renders, the `selfgravity`
Engine's fused frames, and its head-on impact's physics shrunk to two
300-count discs (the port against the JAX Pallas path in interpret mode).

tests/test_gravity.py's two-blob state and rings; both packages get the
same numpy state.  f32 results are held to rtol = atol = 1e-5 (sums over
particles in another order), images to the pixel gate (at most 0.1% of
pixels off by more than 1e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.camera import Camera as JCamera
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.engine import build_scene as jbuild_scene
from spacetime_tpu.models.softbody import SoftbodyModel as JSoftbodyModel
from spacetime_tpu.models.softbody import default_bin_resolution as jbin_resolution
from spacetime_tpu.ops import curved as jcurved
from spacetime_tpu.ops import forces as jforces
from spacetime_tpu.ops import forces_pallas as jforces_pallas
from spacetime_tpu.ops import gravity as jgravity
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.ops import worldline as jwl
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu.utils import diagnostics as jdiagnostics
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.models.softbody import SoftbodyModel
from spacetime_tpu_torch.ops import curved, forces, gravity
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config

H = 0.005
F32 = dict(rtol=1e-5, atol=1e-5)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _state(v0=(0.2, 0.0), v1=(-0.1, 0.05), t_cap=64):
    """(JAX (particles, objects, ring), port (particles, objects, ring)):
    two discs, inertially prefilled ring of t_cap ticks at t0 = 0."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.3, 0.5), v0), base_color=(0, 0, 1))
    sb.add(jscene.disc_softbody(4, 1, (0.7, 0.5), v1), base_color=(1, 0, 0))
    jp, jo = sb.build()
    jbuf = jwl.prefill_inertial(jwl.create(t_cap, jp.capacity), jp.pos, jp.vel, jp.active,
                                jnp.float32(0.0), jnp.float32(H))
    port = (convert.particles_from_numpy(_fields(jp)), convert.objects_from_numpy(_fields(jo)),
            convert.worldline_from_numpy(_fields(jbuf)))
    return (jp, jo, jbuf), port


def _close(ours, ref):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(ref), **F32)


@pytest.mark.parametrize("obj", [0, 1])
def test_object_energy_com_matches_jax_and_numpy(obj):
    (jp, _, _), (p, _, _) = _state()
    cx, cy, en = gravity.object_energy_com(p, obj)
    for a, b in zip((cx, cy, en), jgravity.object_energy_com(jp, obj)):
        _close(a, b)
    act = p.active.numpy() & (p.object_index.numpy() == obj)
    v = p.vel.numpy().astype(np.float64)[act]
    w = p.rest_mass.numpy().astype(np.float64)[act] / np.sqrt(1.0 - (v ** 2).sum(-1))
    pos = p.pos.numpy().astype(np.float64)[act]
    np.testing.assert_allclose([float(cx), float(cy), float(en)],
                               [(w * pos[:, 0]).sum() / w.sum(), (w * pos[:, 1]).sum() / w.sum(),
                                w.sum()], rtol=1e-5)


@pytest.mark.parametrize("max_age", [0, 40])
def test_com_history_matches_jax_and_the_inertial_track(max_age):
    """Uniform velocity: the track is linear in age and the energy constant;
    every component equals JAX's, ages descending."""
    (jp, _, jbuf), (p, _, buf) = _state(v0=(0.15, -0.1))
    track = gravity.com_history(buf, p.object_index, p.rest_mass, p.active, 0, max_age)
    jtrack = jgravity.com_history(jbuf, jp.object_index, jp.rest_mass, jp.active, 0, max_age)
    for a, b in zip(track[:3], jtrack[:3]):
        _close(a, b)
    np.testing.assert_array_equal(track[3].numpy(), np.asarray(jtrack[3]))
    assert track[3].shape == (max_age or 64,)
    cx0, cy0, en0 = gravity.object_energy_com(p, 0)
    ages = track[3].numpy().astype(np.float64)
    np.testing.assert_allclose(track[0].numpy(), float(cx0) - 0.15 * ages * H, atol=1e-5)
    np.testing.assert_allclose(track[1].numpy(), float(cy0) + 0.1 * ages * H, atol=1e-5)
    np.testing.assert_allclose(track[2].numpy(), float(en0), rtol=1e-6)


def test_com_history_reads_the_ring_at_its_cursor():
    """After pushes that wrap the ring, the track follows the device cursor
    (no host read of it): equal to JAX's on the same ring."""
    (jp, _, jbuf), (p, _, buf) = _state(t_cap=16)
    for k in range(1, 21):
        moved = dataclasses.replace(jp, pos=jp.pos + jp.vel * (k * H))
        jbuf = jwl.push_frame(jbuf, moved, k * H)
    buf = convert.worldline_from_numpy(_fields(jbuf))
    assert int(buf.cursor) == (15 + 20) % 16  # the prefill leaves it at 15
    track = gravity.com_history(buf, p.object_index, p.rest_mass, p.active, 1)
    jtrack = jgravity.com_history(jbuf, jp.object_index, jp.rest_mass, jp.active, 1)
    for a, b in zip(track[:3], jtrack[:3]):
        _close(a, b)


def test_retarded_com_matches_jax_and_the_linear_closed_form():
    """Inertial motion: the retarded centroid equals JAX's and the closed-form
    retarded-time root the Engine uses for prescribed linear defects."""
    vx, vy = 0.2, -0.05
    (jp, _, jbuf), (p, _, buf) = _state(v0=(vx, vy), t_cap=256)
    cam = torch.tensor([0.9, 0.1])
    got = gravity.retarded_com(buf, p.object_index, p.rest_mass, p.active, 0, cam[0], cam[1], H)
    ref = jgravity.retarded_com(jbuf, jp.object_index, jp.rest_mass, jp.active, 0,
                                jnp.float32(0.9), jnp.float32(0.1), H)
    for a, b in zip(got, ref):
        _close(a, b)
    c0x, c0y, _ = gravity.object_energy_com(p, 0)
    qx, qy = float(c0x) - 0.9, float(c0y) - 0.1
    a, b, c_ = vx * vx + vy * vy - 1.0, 2.0 * (qx * vx + qy * vy), qx * qx + qy * qy
    t_r = (-b + np.sqrt(b * b - 4 * a * c_)) / (2 * a)
    assert t_r < 0
    np.testing.assert_allclose(float(got[0]), float(c0x) + vx * t_r, atol=5e-5)
    np.testing.assert_allclose(float(got[1]), float(c0y) + vy * t_r, atol=5e-5)


def test_retarded_com_clamps_to_a_short_history():
    """A camera far beyond the stored track: the oldest usable tick, as JAX."""
    (jp, _, jbuf), (p, _, buf) = _state(t_cap=16)
    got = gravity.retarded_com(buf, p.object_index, p.rest_mass, p.active, 0,
                               torch.tensor(50.0), torch.tensor(0.0), H)
    ref = jgravity.retarded_com(jbuf, jp.object_index, jp.rest_mass, jp.active, 0,
                                jnp.float32(50.0), jnp.float32(0.0), H)
    assert all(bool(torch.isfinite(x)) for x in got)
    for a, b in zip(got, ref):
        _close(a, b)
    track = gravity.com_history(buf, p.object_index, p.rest_mass, p.active, 0)
    assert float(got[0]) == float(track[0][0])  # the oldest row


@pytest.mark.parametrize("retarded", [False, True])
def test_source_defects_match_jax(retarded):
    """Derived deficits (8 pi G energy) and fixed ones, quasi-static and
    retarded centres."""
    (jp, _, jbuf), (p, _, buf) = _state()
    jcam = JCamera.create(pos=(0.5, 0.3), zoom=0.7)
    cam = convert.camera_from_numpy(_fields(jcam))
    specs = ((0, None), (1, 0.7))
    g = 1.0 / (8.0 * np.pi * 40.0)
    ours = gravity.source_defects(specs, p, buf, cam, H, g, retarded)
    ref = jgravity.source_defects(specs, jp, jbuf, jcam, H, g, retarded)
    assert len(ours) == len(ref) == 2
    for d, jd in zip(ours, ref):
        _close(d.center, jd.center)
        _close(d.deficit, jd.deficit)
    _, _, en = gravity.object_energy_com(p, 0)
    np.testing.assert_allclose(float(ours[0].deficit), 8 * np.pi * g * float(en), rtol=1e-6)
    assert float(ours[1].deficit) == np.float32(0.7)


def test_sourced_defect_renders_as_the_manual_one():
    """A sourced defect renders identically to a manual defect at the same
    centre, and as the JAX renderer does (pixel gate)."""
    (jp, jo, jbuf), (p, o, buf) = _state(v0=(0.0, 0.0), v1=(0.0, 0.0))
    jcam = JCamera.create(pos=(0.5, 0.3), zoom=0.7)
    cam = convert.camera_from_numpy(_fields(jcam))
    jparams = jrt.RenderParams(num_rays=128, dt=H, backend="xla",
                               cell_px=jrt.auto_cell_px(jrt.RenderParams(dt=H), 64, 64, 0.6))
    params = rt.RenderParams(**{f.name: getattr(jparams, f.name)
                                for f in dataclasses.fields(rt.RenderParams)})
    g = 1.0 / (8.0 * np.pi * 40.0)
    sourced = gravity.source_defects(((0, None),), p, buf, cam, H, g, retarded=False)
    manual = (curved.ConicalDefect(center=sourced[0].center.clone(),
                                   deficit=sourced[0].deficit.clone()),)
    img_s = curved.render_retarded_conical(buf, p.object_index, o, cam, sourced, 64, 64, params)
    img_m = curved.render_retarded_conical(buf, p.object_index, o, cam, manual, 64, 64, params)
    assert (img_s < 0.999).any() and torch.equal(img_s, img_m)
    jsourced = jgravity.source_defects(((0, None),), jp, jbuf, jcam, H, g, retarded=False)
    jimg = np.asarray(jcurved.render_retarded_conical(jbuf, jp.object_index, jo, jcam, jsourced,
                                                      64, 64, jparams))
    assert np.mean(np.abs(img_s.numpy() - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------


def _small(mod, **over):
    """tests/test_gravity.py's small self-gravity config."""
    base = dict(
        scene=mod.SceneSpec(bodies=(
            ("disc", 40, (0.35, 0.5), (0.15, 0.0), (0.0, 0.0, 1.0)),
            ("disc", 40, (0.65, 0.5), (-0.15, 0.0), (1.0, 0.0, 0.0)),
        )),
        width=64, height=64, history=64, cam_pos=(0.5, 0.3), cam_zoom=0.7,
        render_mode="conical", defect_source=((0, None), (1, None)),
        defect_G=1.0 / (8.0 * np.pi * 40.0), defect_retarded=True,
        render=mod.RenderParams(num_rays=128))
    base.update(over)
    return mod.EngineConfig(**base)


FRAMES = 3


def test_engine_selfgravity_fused_frames_match_jax():
    """The fused selfgravity frames (sourced defects at the retarded
    centroids, recomputed from the ring in the render stage) against the
    JAX Engine's fused frames, before the discs meet: the pixel gate, the
    diag counters, and the two defects the last frame used."""
    je = JEngine(_small(jconfig))
    jimgs = [np.asarray(je.run_frame()) for _ in range(FRAMES)]
    eng = Engine(_small(config), device="cpu")
    assert eng._can_fuse()
    imgs = [eng.run_frame().numpy().copy() for _ in range(FRAMES)]
    assert np.isfinite(imgs[-1]).all() and (imgs[-1] < 0.999).any()
    for img, jimg in zip(imgs, jimgs):
        assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    for name in ("pairs_used", "band_truncated", "bin_dropped", "cell_too_small"):
        assert int(getattr(eng.last_diag, name)) == int(getattr(je.last_diag, name)), name
    ours, ref = eng._defects(), je._defects()
    assert len(ours) == len(ref) == 2
    for d, jd in zip(ours, ref):
        _close(d.center, jd.center)
        _close(d.deficit, jd.deficit)
    assert 0.2 < float(ours[0].center[0]) < 0.55 < float(ours[1].center[0]) < 0.8


def test_selfgravity_config_runs_sourced_defects():
    """The named config's two derived deficits come out near 1 rad each."""
    cfg = config.get_config("selfgravity")
    assert cfg.defect_source == ((0, None), (1, None)) and cfg.defect_retarded
    eng = Engine(dataclasses.replace(cfg, width=32, height=32, history=32), device="cpu")
    defects = eng._defects()
    assert len(defects) == 2
    for d in defects:
        assert 0.9 < float(d.deficit) < 1.1


def test_engine_conical_requires_defect_or_source():
    eng = Engine(_small(config, defect_source=None), device="cpu")
    with pytest.raises(ValueError, match="defect"):
        eng.run_frame()
    with pytest.raises(ValueError, match="defect"):
        eng.render()


# selfgravity's head-on 0.5c impact at 634 active particles: contact begins
# at step 36; from there a one-ulp change of the start grows ~10x a step.
# CHAOS maps a step to the largest ratio of the port's distance from JAX to
# JAX's distance from its own run started one ulp away: the first contact
# steps at 2 (a 1% change of the repulsion reads 13x at step 36), later
# steps, where the disorder saturates, at 4
IMPACT_STEPS, CONTACT_STEP = 140, 36
CHAOS = {36: 2.0, 37: 2.0, 38: 2.0, 40: 4.0, 45: 4.0}


def test_selfgravity_impact_heats_toward_c_in_jax_and_the_port():
    """The `selfgravity` scene shrunk to two 300-count discs (its physics,
    speeds and colours; 634 active) through its 0.5c head-on impact, the
    port against the JAX package's Pallas collision path (interpret mode:
    its XLA path misses in-step contacts).  Before contact the states agree
    to 1e-6.  From it on the impact is chaotic: the port's distance from
    JAX stays within 2x (the first contact steps) and 4x (later) of the
    distance between JAX's own run and JAX's run from positions one ulp
    away.  JAX's run
    heats the discs toward c (max |v| past 0.999 c, the energy over twice
    its start by step 140), and the port's passes 0.8 c: the drops that
    `selfgravity` shows on the card come from the reference's physics."""
    cfg = jconfig.get_config("selfgravity")
    (b0, b1) = cfg.scene.bodies
    spec = dataclasses.replace(cfg.scene, bodies=(
        ("disc", 300, (0.42, 0.5), b0[3], b0[4]), ("disc", 300, (0.58, 0.5), b1[3], b1[4])))
    jp, _ = jbuild_scene(spec)
    act = np.asarray(jp.active)
    jm = JSoftbodyModel(
        capacity=jp.capacity, params=cfg.physics, use_pallas=True, pallas_interpret=True,
        spring_offsets=jforces.derive_spring_offsets(np.asarray(jp.neighbors)),
        wmax=jforces_pallas.suggest_wmax(jp.pos, jp.active, jbin_resolution(cfg.physics),
                                         tile=JSoftbodyModel.__dataclass_fields__["tile"].default))
    jstep = jax.jit(jm.step)
    p = convert.particles_from_numpy(_fields(jp))
    model = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.numpy()),
                          config.get_config("selfgravity").physics, device="cpu")
    pos = np.asarray(jp.pos).copy()
    pos[act] = np.nextafter(pos[act], np.float32(1.0))
    jq = dataclasses.replace(jp, pos=jnp.asarray(pos))  # one ulp away
    e0 = float(jdiagnostics.totals(jp).energy)
    jv_max = v_max = 0.0
    for i in range(1, IMPACT_STEPS + 1):
        jp, jaux = jstep(jp)
        p, _ = model.step(p)
        assert int(jaux.window_truncated) == 0
        ours, ref = p.pos.numpy()[act], np.asarray(jp.pos)[act]
        if i < CONTACT_STEP:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
        if i <= max(CHAOS):
            jq, _ = jstep(jq)
        if i in CHAOS:
            chaos = np.abs(np.asarray(jq.pos)[act] - ref).max()
            assert np.abs(ours - ref).max() <= CHAOS[i] * chaos, i
        jv_max = max(jv_max, float(np.linalg.norm(np.asarray(jp.vel)[act], axis=-1).max()))
        v_max = max(v_max, float(torch.linalg.vector_norm(p.vel[p.active], dim=-1).max()))
    assert jv_max > 0.999 and float(jdiagnostics.totals(jp).energy) > 2.0 * e0
    assert v_max > 0.8
