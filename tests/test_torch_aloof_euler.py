"""Aloof bodies (models/aloofbody.py and their injection into the Engine)
and the Euler integrator of the port against the JAX package on the CPU.

The templates, `state_at` and the two trajectories are held to the JAX
functions at F32; an aloof Engine to the JAX Engine (instant and retarded,
4 frames: images under the pixel gate, positions at 1e-6, as
tests/test_aloofbody.py holds its fused and unfused frames); the fused
frame to the eager one; a trajectory that cannot be captured runs eagerly
and says so.  The Euler step is held to the JAX SoftbodyModel's.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.engine import Engine as JEngine
from spacetime_tpu.models import aloofbody as jab
from spacetime_tpu.models.softbody import SoftbodyModel as JModel
from spacetime_tpu.ops import forces as jforces
from spacetime_tpu.ops import raytrace as jrt
from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import convert
from spacetime_tpu_torch.engine import Engine
from spacetime_tpu_torch.models import aloofbody as ab
from spacetime_tpu_torch.models.softbody import SoftbodyModel
from spacetime_tpu_torch.ops import raytrace as rt
from spacetime_tpu_torch.utils import config
from spacetime_tpu_torch.utils import logging as logmod

# the port's tolerances (tests/test_torch_render.py, tests/test_aloofbody.py)
F32 = dict(rtol=1e-5, atol=1e-5)
PIXEL_TOL, PIXEL_SHARE = 1e-3, 1e-3
POS_ATOL = 1e-6
FRAMES = 4


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


# --------------------------------------------------------------------------
# templates, state_at, trajectories
# --------------------------------------------------------------------------


def test_templates_match_jax():
    np.testing.assert_array_equal(ab.disc_template(3), jab.disc_template(3))
    np.testing.assert_array_equal(ab.box_template(5, 3), jab.box_template(5, 3))


@pytest.mark.parametrize("vel", [(0.8, 0.0), (0.3, -0.5), (0.0, 0.0)])
def test_linear_state_at_matches_jax(vel):
    """Lorentz contraction along the motion, at several times."""
    tpl = ab.box_template(11, 7)
    ours = ab.AloofBody(tpl, ab.linear_trajectory((0.1, 0.2), vel))
    ref = jab.AloofBody(tpl, jab.linear_trajectory((0.1, 0.2), vel))
    for t in (0.0, 0.37, 2.5):
        pos, v = ours.state_at(torch.tensor(t, dtype=torch.float32))
        jpos, jv = ref.state_at(jnp.float32(t))
        assert pos.shape == v.shape == (tpl.shape[0], 2)
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **F32)
        np.testing.assert_allclose(v.numpy(), np.broadcast_to(np.asarray(jv), v.shape), **F32)
    if vel == (0.8, 0.0):  # x contracted by 1/gamma = 0.6, y unchanged
        pos, _ = ours.state_at(0.0)
        ext = lambda a, i: a[:, i].max() - a[:, i].min()
        np.testing.assert_allclose(ext(pos.numpy(), 0), 0.6 * ext(tpl, 0), rtol=1e-5)
        np.testing.assert_allclose(ext(pos.numpy(), 1), ext(tpl, 1), rtol=1e-5)


def test_circular_state_at_matches_jax():
    ours = ab.AloofBody(ab.disc_template(2), ab.circular_trajectory((0.5, 0.5), 0.2, 0.4))
    ref = jab.AloofBody(jab.disc_template(2), jab.circular_trajectory((0.5, 0.5), 0.2, 0.4))
    for t in (0.0, 0.3, 0.7, 5.0):
        pos, v = ours.state_at(torch.tensor(t))
        jpos, jv = ref.state_at(jnp.float32(t))
        np.testing.assert_allclose(pos.numpy(), np.asarray(jpos), **F32)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), **F32)
        np.testing.assert_allclose(np.linalg.norm(v.numpy()[0]), 0.4, rtol=1e-5)


def test_state_at_rejects_speed_of_light():
    body = ab.AloofBody(ab.disc_template(1), ab.linear_trajectory((0, 0), (1.0, 0.0)))
    with pytest.raises(ValueError, match=">= c"):
        body.state_at(0.0)


def test_capturable_tells_torch_from_host_trajectories():
    host = lambda t: (np.array([0.5 + 0.01 * float(np.cos(t)), 0.5], np.float32),
                      np.zeros(2, np.float32))
    constant = lambda t: (np.array([0.5, 0.5], np.float32), np.zeros(2, np.float32))
    tpl = ab.disc_template(1)
    assert ab.capturable([ab.AloofBody(tpl, ab.circular_trajectory((0.5, 0.5), 0.1, 0.2)),
                          ab.AloofBody(tpl, ab.linear_trajectory((0, 0), (0.1, 0)))])
    assert not ab.capturable([ab.AloofBody(tpl, host)])
    # numpy out: its host-to-device copy cannot be captured
    assert not ab.capturable([ab.AloofBody(tpl, constant)])


def test_text_template():
    pytest.importorskip("PIL")
    pts = ab.text_template("HI")
    assert pts.shape[0] > 10
    np.testing.assert_allclose(pts.mean(0), 0.0, atol=1e-6)
    np.testing.assert_array_equal(pts, jab.text_template("HI"))


def test_text_template_names_pillow_without_it(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="pillow"):
        ab.text_template("HI")


# --------------------------------------------------------------------------
# the Engine
# --------------------------------------------------------------------------


def _cfg(mod, lattice_pad=False, **kw):
    """tests/test_aloofbody.py's config.  Unpadded by default: the JAX
    Engine moves the active particles to the front without renumbering
    their bonds, which is exact only where no padding sat between them."""
    base = dict(
        scene=mod.SceneSpec(bodies=(("disc", 30, (0.42, 0.42), (0.0, 0.0), (0.2, 0.2, 1.0)),),
                            capacity=256, lattice_pad=lattice_pad),
        render=(jrt if mod is jconfig else rt).RenderParams(num_rays=256),
        width=48, height=48, history=32, cam_zoom=0.3)
    base.update(kw)
    return mod.EngineConfig(**base)


def _bodies(mod, traj="circular"):
    make = (mod.circular_trajectory((0.55, 0.5), 0.02, 0.3) if traj == "circular"
            else mod.linear_trajectory((0.55, 0.5), (0.0, 0.1)))
    return [mod.AloofBody(mod.disc_template(2), make, object_index=5)]


@pytest.mark.parametrize("traj", ["circular", "linear"])
@pytest.mark.parametrize("mode", ["instant", "retarded"])
def test_aloof_engine_matches_jax(mode, traj):
    """FRAMES frames of an aloof scene on both Engines (fused on both): the
    images under the pixel gate, the positions (aloof slots included) at
    1e-6; the aloof slots stay out of the physics."""
    je = JEngine(_cfg(jconfig, render_mode=mode), aloof_bodies=_bodies(jab, traj))
    pe = Engine(_cfg(config, render_mode=mode), device="cpu", aloof_bodies=_bodies(ab, traj))
    assert pe._can_fuse() and je._can_fuse()
    assert pe._aloof_slice == je._aloof_slice and pe.particles.capacity == je.particles.capacity
    np.testing.assert_array_equal(pe.present.numpy(), np.asarray(je.present))
    for _ in range(FRAMES):
        jimg = np.asarray(je.run_frame())
        img = pe.run_frame().numpy()
        assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    np.testing.assert_allclose(pe.particles.pos.numpy(), np.asarray(je.particles.pos),
                               rtol=0, atol=POS_ATOL)
    lo, hi = pe._aloof_slice
    assert not pe.particles.active[lo:hi].any()
    # the aloof disc shows right of centre in the object's default red
    right = img[:, 27:]
    assert ((right[..., 0] > 0.5) & (right[..., 2] < 0.5)).any()
    assert (img[:, :24].min(-1) < 0.9).any()  # and the softbody left of it


def test_aloof_slots_hold_state_at_the_clock():
    """After each fused frame the aloof slots hold state_at(time) and the
    ring's newest row holds them too."""
    pe = Engine(_cfg(config), device="cpu", aloof_bodies=_bodies(ab))
    lo, hi = pe._aloof_slice
    for _ in range(3):
        pe.run_frame()
        t = pe.worldline.times[pe.worldline.cursor]
        pos, vel = pe.aloof_bodies[0].state_at(t)
        assert torch.equal(pe.particles.pos[lo:hi], pos)
        assert torch.equal(pe.particles.vel[lo:hi], vel)
        assert torch.equal(pe.worldline.pos_x[pe.worldline.cursor][lo:hi], pos[:, 0])
    assert float(t) == pytest.approx(pe.time, abs=1e-6)


def test_aloof_fused_matches_eager():
    """tests/test_aloofbody.py's fused-vs-unfused check on the port: the
    fused frame (device clock) against eager frames (host clock)."""
    fused = Engine(_cfg(config), device="cpu", aloof_bodies=_bodies(ab))
    eager = Engine(_cfg(config), device="cpu", aloof_bodies=_bodies(ab))
    eager._aloof.capturable = False  # force the eager path, host clock
    assert fused._can_fuse() and not eager._can_fuse()
    for _ in range(FRAMES):
        img_f = fused.run_frame().numpy()
        img_e = eager.run_frame().numpy()
    np.testing.assert_allclose(img_f, img_e, atol=1e-5)
    np.testing.assert_allclose(fused.particles.pos.numpy(), eager.particles.pos.numpy(),
                               atol=POS_ATOL)
    assert eager.graph_stats["eager"] == FRAMES and fused.graph_stats["eager"] == 0


def test_uncapturable_trajectory_runs_eagerly_and_says_so(caplog):
    """A host-only trajectory (numpy of a float time) cannot be captured:
    the Engine logs it once, runs every frame eagerly (graph_stats counts
    them) and matches the JAX Engine's unfused frames."""
    def host_traj(t):
        a = float(np.cos(float(t)))
        return np.array([0.55 + 0.01 * a, 0.5], np.float32), np.zeros(2, np.float32)

    tpl = jab.disc_template(1)
    logger = logmod.get()
    logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING, logger=logmod.NAME):
            pe = Engine(_cfg(config, history=16, width=32, height=32), device="cpu",
                        aloof_bodies=[ab.AloofBody(tpl, host_traj)])
    finally:
        logger.removeHandler(caplog.handler)
    assert sum("cannot be captured" in r.getMessage() for r in caplog.records) == 1
    je = JEngine(_cfg(jconfig, history=16, width=32, height=32),
                 aloof_bodies=[jab.AloofBody(tpl, host_traj)])
    assert not pe._can_fuse() and not je._can_fuse()
    for _ in range(2):
        img = pe.run_frame().numpy()
        jimg = np.asarray(je.run_frame())
    assert img.shape == (32, 32, 3)
    assert np.mean(np.abs(img - jimg).max(axis=-1) > PIXEL_TOL) <= PIXEL_SHARE
    np.testing.assert_allclose(pe.particles.pos.numpy(), np.asarray(je.particles.pos),
                               rtol=0, atol=POS_ATOL)
    assert pe.graph_stats["eager"] == 2 and pe.graph_stats["captures"] == 0


def test_aloof_slots_keep_the_bonds_of_a_padded_scene():
    """A lattice-padded scene has padding between its particles: the
    repack renumbers the bonds, so each particle keeps its partners, and
    the softbody moves as it does with no aloof body at all."""
    plain = Engine(_cfg(config, lattice_pad=True), device="cpu")
    aloof = Engine(_cfg(config, lattice_pad=True), device="cpu", aloof_bodies=_bodies(ab))
    p, q = plain.particles, aloof.particles
    act = p.active
    n = int(act.sum())
    assert not torch.equal(act[:n], torch.ones(n, dtype=torch.bool))  # padding between
    partners = lambda parts, rows: {tuple(sorted(map(tuple, parts.pos[[j for j in r if j >= 0]]
                                                     .tolist()))) for r in rows}
    assert partners(p, p.neighbors[act].tolist()) == partners(q, q.neighbors[:n].tolist())
    for _ in range(FRAMES):
        plain.run_frame()
        aloof.run_frame()
    np.testing.assert_allclose(aloof.particles.pos[:n].numpy(), plain.particles.pos[act].numpy(),
                               rtol=0, atol=1e-5)


def test_aloof_capacity_grows_for_the_slots():
    """More aloof points than free slots: the capacity grows to the next
    multiple of 256, as in the JAX Engine."""
    big = [ab.AloofBody(ab.box_template(16, 16), ab.linear_trajectory((0.6, 0.5), (0, 0)))]
    jbig = [jab.AloofBody(jab.box_template(16, 16), jab.linear_trajectory((0.6, 0.5), (0, 0)))]
    pe = Engine(_cfg(config), device="cpu", aloof_bodies=big)
    je = JEngine(_cfg(jconfig), aloof_bodies=jbig)
    assert pe.particles.capacity == je.particles.capacity == 512
    assert pe._aloof_slice == je._aloof_slice
    np.testing.assert_array_equal(pe.particles.object_index.numpy(),
                                  np.asarray(je.particles.object_index))


def test_checkpoint_fingerprint_counts_the_aloof_slots():
    """The checkpoint fingerprint hashes the capacity with its aloof slots,
    as JAX's does (`int(self.particles.capacity)`): Engines that differ only
    in their aloof slots do not share one."""
    big = [ab.AloofBody(ab.box_template(16, 16), ab.linear_trajectory((0.6, 0.5), (0, 0)))]
    grown = Engine(_cfg(config), device="cpu", aloof_bodies=big)
    bare = Engine(_cfg(config), device="cpu")
    assert grown._n_full == grown.particles.capacity == 512 != bare.particles.capacity
    assert grown._config_fingerprint() != bare._config_fingerprint()


# --------------------------------------------------------------------------
# Euler
# --------------------------------------------------------------------------


def _two_discs(gap_x):
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True))
    sb.add(jscene.disc_softbody(4, 1, (0.35 + gap_x, 0.405), (-0.25, -0.05), lattice_pad=True))
    return sb.build()


@pytest.mark.parametrize("gap", [0.05, 0.0295])
def test_euler_step_matches_jax(gap):
    """Four Euler steps against the JAX SoftbodyModel(integrator="euler")
    on the CPU (its XLA path: with one force evaluation at the start
    positions it misses no in-step contact), before contact and through
    the impact: positions and velocities at F32 (velocities at the
    collision tolerance through the impact); bonds_broken 0."""
    jp, _ = _two_discs(gap)
    offs = jforces.derive_spring_offsets(np.asarray(jp.neighbors))
    jm = JModel(capacity=jp.capacity, spring_offsets=offs, integrator="euler")
    model = SoftbodyModel(jp.capacity, offs, device="cpu", integrator="euler")
    tp = convert.particles_from_numpy(_fields(jp))
    act = np.asarray(jp.active)
    v0 = np.asarray(jp.vel)[act].copy()
    for _ in range(4):
        pos0, vel0 = tp.pos.clone(), tp.vel.clone()
        jp, jaux = jm.step(jp)
        tp, aux = model.step(tp)
        assert int(aux.bonds_broken) == int(jaux.bonds_broken) == 0
        assert int(jaux.grid_overflow) == 0
        # the position advances with the OLD velocity
        torch.testing.assert_close(tp.pos, torch.where(tp.active[:, None],
                                                       pos0 + vel0 * model.params.h, pos0))
    np.testing.assert_allclose(tp.pos.numpy()[act], np.asarray(jp.pos)[act], **F32)
    vel_tol = dict(rtol=1e-4, atol=1e-3) if gap < 0.04 else F32
    np.testing.assert_allclose(tp.vel.numpy()[act], np.asarray(jp.vel)[act], **vel_tol)
    np.testing.assert_array_equal(tp.neighbors.numpy(), np.asarray(jp.neighbors))
    if gap < 0.04:  # the impact happened
        assert np.abs(np.asarray(jp.vel)[act] - v0).max() > 0.05


def test_unknown_integrator_raises():
    jp, _ = _two_discs(0.05)
    model = SoftbodyModel(jp.capacity, None, device="cpu", integrator="verlet")
    with pytest.raises(ValueError, match="unknown integrator"):
        model.step(convert.particles_from_numpy(_fields(jp)))
