"""The port's Engine surface on the CPU, mirroring tests/test_engine.py:
pause, camera keys, the accelerated camera, stats, checkpoints, StepAux
summing, the refusals of what is not ported, the default device, the named
configs (held to the JAX ones field for field) and the CLI."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from spacetime_tpu.utils import config as jconfig
from spacetime_tpu_torch import cli, headline, scene, state
from spacetime_tpu_torch.camera import Camera
from spacetime_tpu_torch.engine import Engine, build_scene
from spacetime_tpu_torch.models.softbody import SoftbodyModel
from spacetime_tpu_torch.ops import btz, curved
from spacetime_tpu_torch.ops import worldline as wl
from spacetime_tpu_torch.ops.raytrace import RenderParams
from spacetime_tpu_torch.utils import config
from spacetime_tpu_torch.utils.config import EngineConfig, SceneSpec, get_config

PORTED = ("single_blob", "two_body_collision", "flagship_1080p", "accelerated_camera",
          "rindler_horizon", "boosted_observer", "plastic_collision", "conical_defect",
          "selfgravity", "worldline3d", "btz_hole", "btz_reflected", "btz_spinning",
          "btz_extremal", "btz_photon_ring", "png_demo")


def _tiny(**kw):
    base = dict(
        scene=SceneSpec(bodies=(("disc", 50, (0.45, 0.45), (0.1, 0.0), (0.2, 0.2, 1.0)),),
                        capacity=256),
        render=RenderParams(num_rays=256), width=48, height=48, history=32)
    base.update(kw)
    return EngineConfig(**base)


def test_pause_freezes_physics():
    eng = Engine(_tiny(render_mode="points"), device="cpu")
    eng.run_frame(keys={"p": True})  # toggles pause before stepping
    pos0 = eng.particles.pos.clone()
    eng.run_frame()
    assert eng.paused and torch.equal(pos0, eng.particles.pos)
    eng.run_frame(keys={"p": True})  # unpause
    eng.run_frame()
    assert not torch.equal(pos0, eng.particles.pos)


def test_camera_keys_pan_and_zoom():
    eng = Engine(_tiny(render_mode="points"), device="cpu")
    x0 = float(eng.camera.pos[0])
    eng.run_frame(keys={"right": True})
    assert float(eng.camera.pos[0]) > x0
    z0 = float(eng.camera.zoom)
    eng.run_frame(keys={"z": True})
    assert float(eng.camera.zoom) < z0
    assert float(eng.camera.zoom) == pytest.approx(z0 - eng.config.physics.h, rel=1e-6)


def test_accelerated_camera_velocity_grows():
    eng = Engine(_tiny(render_mode="points", cam_accel=(0.5, 0.0)), device="cpu")
    eng.run(10)
    v = eng.camera.vel.numpy()
    assert v[0] > 0.0 and np.linalg.norm(v) < 1.0
    # a = 0.5 c/s for 10 frames of h from rest: v ~ a t (gamma ~ 1)
    assert v[0] == pytest.approx(0.5 * 10 * eng.config.physics.h, rel=1e-3)
    assert float(eng.camera.pos[0]) > eng.config.cam_pos[0]


def test_rindler_velocity_stays_below_c():
    eng = Engine(_tiny(render_mode="points", cam_accel=(400.0, 0.0)), device="cpu")
    eng.run(8)
    assert 0.99 < float(eng.camera.vel[0]) <= 0.999 + 1e-6


@pytest.mark.parametrize("mode", ["points", "retarded", "instant"])
def test_stats_report_stage_times(mode):
    """Stage times are measured with `stage_timing` (the fused frame reports
    zeros, as the JAX package's does)."""
    eng = Engine(_tiny(render_mode=mode, stage_timing=True), device="cpu")
    summary = eng.run(4)
    assert summary["fps_avg"] > 0 and summary["frame_avg_ms"] > 0
    for k in ("step_avg_ms", "worldline_avg_ms", "render_avg_ms"):
        assert summary[k] > 0, k
    assert eng.stats.frames == 4


def test_steps_per_frame_sums_step_aux():
    """With steps_per_frame > 1 a bond that breaks in tick 2 of 4 is still
    counted in last_aux (the sum over the frame's ticks)."""
    cfg = EngineConfig(
        scene=SceneSpec(bodies=(("box", (2, 1), (0.0, 0.0), (0.0, 0.0), (0.3, 0.4, 1.0)),),
                        capacity=256),
        render_mode="points", width=16, height=16, history=8, steps_per_frame=4,
        diag_every=1)
    particles, objects = build_scene(cfg.scene, device="cpu")
    vel = torch.zeros_like(particles.vel)
    vel[0, 0], vel[1, 0] = -0.95, 0.95  # apart at 0.95c each
    eng = Engine(cfg, dataclasses.replace(particles, vel=vel), objects, device="cpu")
    eng.run_frame()
    assert int(eng.last_aux.bonds_broken) >= 2
    assert eng.time == pytest.approx(4 * cfg.physics.h)
    assert eng.worldline.cursor == 3  # every tick pushed: slots 0..3 after the prefill
    eng.run_frame()
    assert int(eng.last_aux.bonds_broken) == 0


def test_checkpoint_roundtrip_with_every_adapt_field(tmp_path):
    """State, time, frame, pause and ALL adaptation fields, _seg_boost
    included, survive a round trip; the resumed engine steps identically."""
    eng = Engine(_tiny(render_mode="points"), device="cpu")
    eng.run(3)
    for i, name in enumerate(Engine._ADAPT_FIELDS):
        setattr(eng, name, i + 1)
    assert "_seg_boost" in Engine._ADAPT_FIELDS
    path = str(tmp_path / "ckpt.npz")
    eng.save_checkpoint(path)

    eng2 = Engine(_tiny(render_mode="points"), device="cpu")
    eng2.load_checkpoint(path)
    assert (eng2.time, eng2.frame) == (eng.time, eng.frame)
    for name in Engine._ADAPT_FIELDS:
        assert getattr(eng2, name) == getattr(eng, name), name
    assert not eng2.paused
    for part in ("particles", "worldline", "camera"):
        a, b = getattr(eng, part), getattr(eng2, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y), (part, f.name)
    eng.run(2)
    eng2.run(2)
    assert torch.equal(eng.particles.pos, eng2.particles.pos)


def test_checkpoint_rejects_foreign_config(tmp_path):
    eng = Engine(_tiny(render_mode="points"), device="cpu")
    eng.run(2)
    path = str(tmp_path / "ckpt.npz")
    eng.save_checkpoint(path)
    eng2 = Engine(_tiny(render_mode="points", cam_zoom=2.5), device="cpu")
    with pytest.raises(ValueError, match="fingerprint"):
        eng2.load_checkpoint(path)
    assert eng2.frame == 0  # nothing committed
    eng2.load_checkpoint(path, strict=False)
    assert eng2.frame == eng.frame
    # another capacity: refused on shape before any field changes
    eng3 = Engine(_tiny(render_mode="points", scene=dataclasses.replace(
        _tiny().scene, capacity=512)), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng3.load_checkpoint(path, strict=False)
    assert eng3.frame == 0 and eng3.particles.capacity == 512


def test_conserved_quantities():
    eng = Engine(_tiny(render_mode="points"), device="cpu")
    tot = eng.conserved_quantities()
    n = int(eng.particles.active.sum())
    v = np.float32(0.1)
    gamma = 1.0 / np.sqrt(1.0 - v * v)
    assert float(tot.rest_mass) == n
    assert float(tot.energy) == pytest.approx(n * gamma, rel=1e-5)
    assert float(tot.momentum[0]) == pytest.approx(n * gamma * v, rel=1e-5)
    assert float(tot.max_speed) == pytest.approx(v)
    assert int(tot.n_bonds) == int(((eng.particles.neighbors >= 0)
                                    & eng.particles.active[:, None]).sum()) > 0


@pytest.mark.parametrize("change,what", [
    (dict(render_mode="warp"), "render_mode"),
])
def test_unported_engine_features_raise(change, what):
    with pytest.raises(NotImplementedError, match=what):
        Engine(_tiny(**change), device="cpu")


@pytest.mark.parametrize("frame", ["render", "fused"])
def test_btz_mode_without_a_hole_raises(frame):
    """render_mode='btz' without config.btz raises ValueError in render()
    and in the fused frame, as the JAX Engine does."""
    eng = Engine(_tiny(render_mode="btz"), device="cpu")
    assert eng._can_fuse()
    with pytest.raises(ValueError, match="requires config.btz"):
        eng.render() if frame == "render" else eng.run_frame()


_ONE = np.zeros((1, 2), np.float32)
# the entry points and the public constructors a user builds state with:
# {name: fn(**device) -> a tensor of what it built}
ENTRY_POINTS = {
    "Engine": lambda **d: Engine(_tiny(), **d).particles.pos,
    "SoftbodyModel": lambda **d: SoftbodyModel(256, None, **d).rest_lengths,
    "build_scene": lambda **d: build_scene(_tiny().scene, **d)[0].pos,
    "SceneBuilder.build": lambda **d: scene.SceneBuilder().add(
        scene.disc_softbody(3, 0, (0.0, 0.0), (0.0, 0.0))).build(**d)[0].pos,
    "Camera.create": lambda **d: Camera.create(**d).pos,
    "make_objects": lambda **d: state.make_objects(4, **d).offset,
    "pack_particles": lambda **d: state.pack_particles(
        _ONE, _ONE, np.full((1, 8), -1, np.int32), np.zeros(1, np.int32), **d).pos,
    "worldline.create": lambda **d: wl.create(4, 8, **d).pos_x,
    "ConicalDefect.create": lambda **d: curved.ConicalDefect.create(**d).center,
    "BTZBlackHole.create": lambda **d: btz.BTZBlackHole.create(**d).center,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_raise_without_cuda(monkeypatch, name):
    """With no device named, the Engine, SoftbodyModel, build_scene and the
    public constructors of state (SceneBuilder.build, Camera.create,
    make_objects, pack_particles, worldline.create, ConicalDefect.create,
    BTZBlackHole.create) run on cuda:0; without CUDA they raise and never
    fall back to the CPU, and with device="cpu" they build there."""
    build = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    stepped = []
    monkeypatch.setattr(SoftbodyModel, "step", lambda self, *a, **k: stepped.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build()
    assert not stepped
    assert build(device="cpu").device.type == "cpu"


def test_mesh_and_aloof_raise():
    """Aloof bodies run on a mesh (tests/test_torch_parallel.py runs them):
    the aloof Engine on a (two-rank) mesh constructs, with the slots of the
    whole scene, the render-present mask of this rank's block and the
    injection writing the slots in it; an unknown render_mode still
    raises by name."""
    from spacetime_tpu_torch.models.aloofbody import AloofBody, circular_trajectory, disc_template
    from spacetime_tpu_torch.parallel.mesh import Mesh

    body = AloofBody(disc_template(3), circular_trajectory((0.6, 0.5), 0.02, 0.3),
                     object_index=1)
    for rank in range(2):
        mesh = Mesh(group=None, rank=rank, size=2, device=torch.device("cpu"))
        eng = Engine(_tiny(), mesh=mesh, aloof_bodies=[body])
        single = Engine(_tiny(), device="cpu", aloof_bodies=[body])
        lo, hi = eng._aloof_slice
        assert (lo, hi) == single._aloof_slice and hi - lo == body.num_points
        assert eng.particles.capacity == eng.present.shape[0] == 128
        assert torch.equal(eng.present, single.present[128 * rank:128 * (rank + 1)])
        # the slots written in this block: state_at(0) of the rows it holds
        pos = body.state_at(torch.zeros(()))[0]
        rows = range(max(lo, 128 * rank), min(hi, 128 * (rank + 1)))
        assert torch.equal(eng.particles.pos[[g - 128 * rank for g in rows]],
                           pos[[g - lo for g in rows]])
    with pytest.raises(NotImplementedError, match="render_mode 'ray_march'"):
        Engine(_tiny(render_mode="ray_march"), mesh=mesh, aloof_bodies=[body])


# --------------------------------------------------------------------------
# named configs
# --------------------------------------------------------------------------


def _real_paths(scene):
    """The SceneSpec as a dict, each "image" body's PNG path resolved (the
    two packages reach the fixtures from their own directories)."""
    d = dataclasses.asdict(scene)
    d["bodies"] = tuple((kind, os.path.realpath(arg) if kind == "image" else arg, *rest)
                        for kind, arg, *rest in d["bodies"])
    return d


@pytest.mark.parametrize("name", PORTED)
def test_ported_configs_match_jax(name):
    ours, ref = get_config(name), jconfig.get_config(name)
    assert ours.name == ref.name == name
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if f.name == "render":
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), (name, g.name)
        elif f.name == "scene":
            assert _real_paths(a) == _real_paths(b), name
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (name, f.name)
        else:
            assert a == b, (name, f.name)
    if name == "png_demo":
        assert all(os.path.isfile(body[1]) for body in ours.scene.bodies)


def test_registry_keeps_every_name_and_unknown_raises():
    assert set(config.CONFIGS) == set(jconfig.CONFIGS) == set(PORTED)
    with pytest.raises(KeyError):
        get_config("nope")


def test_refdemo_config_is_the_reference_demo_scene():
    cfg = headline.refdemo_config()
    assert scene.radius_for_count(57980) == 136
    assert (cfg.render_mode, cfg.width, cfg.height, cfg.history) == ("points", 1920, 1080, 1024)
    assert (cfg.cam_pos, cfg.cam_zoom) == ((0.6, 0.4), 2.0)
    (k0, n0, off0, v0, _), (k1, n1, off1, v1, _) = cfg.scene.bodies
    assert (k0, n0, off0, v0) == ("disc", 57980, (0.0, 0.0), (0.1, 0.1))
    assert (k1, n1, off1, v1) == ("disc", 57980, (1.2, 0.8), (-0.1, -0.1))
    # the scene's size without building the 149k-particle state
    side = 2 * 136 + 1  # lattice-padded bounding box of one disc
    assert 2 * int(scene.disc_mask(136).sum()) == 116178
    assert -(-2 * side * side // 256) * 256 == 149248


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def test_cli_runs_on_the_cpu_and_prints_the_summary(capsys, tmp_path):
    ckpt = str(tmp_path / "c.npz")
    assert cli.main(["--config", "single_blob", "--frames", "3", "--width", "32",
                     "--height", "32", "--stats", "--stage-timing", "--save", ckpt,
                     "--cpu"]) == 0
    out = capsys.readouterr().out
    summary = json.loads(out[out.index("{"):])
    for k in ("frame_avg_ms", "fps_avg", "step_avg_ms", "worldline_avg_ms", "render_avg_ms"):
        assert summary[k] > 0, k
    eng, img, _ = cli.run(["--config", "single_blob", "--frames", "1", "--width", "32",
                           "--height", "32", "--load", ckpt, "--cpu"])
    assert eng.frame == 4 and eng.device.type == "cpu" and img.shape == (32, 32, 3)


def test_cli_prints_the_summary_only_with_stats(capsys):
    assert cli.main(["--config", "single_blob", "--frames", "2", "--width", "16",
                     "--height", "16", "--mode", "points", "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "{" not in out and out.startswith("2 frames of points on cpu")


def test_cli_without_cuda_raises_and_never_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    monkeypatch.setattr("spacetime_tpu_torch.engine.Engine.__init__",
                        lambda self, *a, **k: built.append(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config", "single_blob", "--frames", "1"])
    assert not built
