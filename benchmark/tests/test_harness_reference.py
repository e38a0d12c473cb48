"""The reference: it imports nothing of the program or of JAX, and on a
tiny scene on the CPU it agrees with the port's CPU path, stage by stage
and through whole runs of the harness."""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness
from benchmark.reference import physics, points, retarded, scene
from benchmark.tests.conftest import ROOT, quiet

TOPS = "sorted({m.split('.')[0] for m in sys.modules})"


def _modules(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", f"import sys\n{code}\nprint({TOPS})"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return eval(out.stdout.strip().splitlines()[-1])


def test_the_reference_imports_neither_the_program_nor_jax():
    tops = _modules("import benchmark.check, benchmark.reference.retarded, "
                    "benchmark.reference.conical, benchmark.reference.physics, "
                    "benchmark.reference.points, benchmark.reference.scene")
    for name in ("spacetime_tpu_torch", "spacetime_tpu", "jax", "jaxlib", "flax"):
        assert name not in tops


def test_a_run_imports_no_jax_and_not_the_jax_package(tmp_path):
    """A whole run of a tiny cell on the CPU, then the loaded modules by
    their whole top-level names (spacetime_tpu_torch is not spacetime_tpu)."""
    code = f"""
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(2)
from benchmark.tests.conftest import HERE
import shutil, json, pathlib
here = pathlib.Path({str(tmp_path)!r}) / "bench"
shutil.copytree(HERE / "tiny", here)
shutil.copytree(HERE.parent / "metrics", here / "metrics")
shutil.copytree(HERE.parent / "reference", here / "reference")
(here / "limits").mkdir()
shutil.copy(HERE.parent / "limits" / "refdemo_116k.retarded.json", here / "limits" / "tiny.retarded.json")
from benchmark import harness, spec
bench = {{"workloads": [{{"name": "tiny.retarded", "config": "tiny", "traffic": "retarded", "chips": 1}}],
         "per_layer": [{{"name": m, "unit": "u"}} for m in ("step_device_ms", "window_captures")], "end_to_end": [{{"name": "fps", "unit": "frames/s"}}]}}
harness.run_cell(bench, "tiny.retarded", 5, 0.5, True, "cpu", here=here, log=lambda *a, **k: None)
assert harness.forbidden_modules() == [], harness.forbidden_modules()
"""
    tops = _modules(code)
    assert "spacetime_tpu_torch" in tops
    for name in harness.FORBIDDEN:
        assert name not in tops


@pytest.mark.parametrize("mode", ["retarded", "points"])
def test_the_reference_agrees_with_the_port_through_a_run(tiny, mode):
    bench, here = tiny
    torch.set_num_threads(2)
    result = harness.run_cell(bench, f"tiny.{mode}", 2 ** 33 + 17, 0.5, False, "cpu",
                              here=here, log=quiet)
    assert result["correct"], result["checked"]
    got = {k: v["value"] for k, v in result["checked"].items()}
    assert got["ring_mismatch"] == 0 and got["bond_mismatch"] == 0
    assert got["image_px_share"] == 0.0  # the CPU path is the plain path


def _port_scene(bodies):
    from spacetime_tpu_torch.engine import build_scene
    from spacetime_tpu_torch.utils.config import SceneSpec

    spec = SceneSpec(bodies=tuple((b["kind"], b["size"] if b["kind"] == "disc" else
                                   tuple(b["size"]), tuple(b["offset"]), tuple(b["vel"]),
                                   tuple(b["rgb"])) for b in bodies))
    return build_scene(spec, "cpu")


BODIES = [{"kind": "disc", "size": 150, "offset": [0.0, 0.0], "vel": [0.2, 0.05],
           "rgb": [0.25, 0.35, 1.0]},
          {"kind": "box", "size": [9, 5], "offset": [0.055, 0.0], "vel": [-0.2, 0.0],
           "rgb": [1.0, 0.3, 0.25]}]


def test_the_scene_and_a_tick_agree_with_the_port():
    from spacetime_tpu_torch.ops import forces
    from spacetime_tpu_torch.models.softbody import SoftbodyModel

    particles, _ = _port_scene(BODIES)
    initial = {k: getattr(particles, k) for k in check.PARTICLE_FIELDS}
    assert check.scene_gap(BODIES, initial, False) < 1e-7
    model = SoftbodyModel(particles.capacity,
                          forces.derive_spring_offsets(particles.neighbors.numpy()), device="cpu")
    p = particles
    for _ in range(40):  # into contact: the box reaches the disc
        before = p
        p, aux = model.step(p)
    t = physics.tick(before.pos, before.vel, before.neighbors, before.rest_mass, before.active)
    act = before.active
    assert t.contacts > 0
    assert float((t.pos - p.pos)[act].abs().max()) < 1e-6
    assert float((t.vel - p.vel)[act].abs().max()) < 1e-4
    assert torch.equal(t.neighbors, p.neighbors) and t.bonds_broken == int(aux.bonds_broken)


def test_the_renders_agree_with_the_port():
    from spacetime_tpu_torch.camera import Camera
    from spacetime_tpu_torch.ops import points_cuda, raytrace
    from spacetime_tpu_torch.ops import worldline as wl

    particles, objects = _port_scene(BODIES)
    buf = wl.create(48, particles.capacity, device="cpu")
    buf = wl.prefill_inertial(buf, particles.pos, particles.vel, particles.active, 0.0, 0.005)
    cam = Camera.create(pos=(0.03, 0.01), zoom=0.25, device="cpu")
    params = raytrace.RenderParams(dt=0.005, num_rays=256, pair_budget=4096, bin_capacity=64,
                                   band=4, segments=3, splat_cells=4, retina_budget=512)
    img, diag = raytrace.render_retarded_with_diag(
        buf, particles.object_index, objects, cam, 80, 48, params, planar=True,
        boundary=wl.boundary_mask(particles))
    ring = retarded.Ring(*(getattr(buf, f) for f in check.RING_FIELDS))
    colors = torch.tensor([b["rgb"] for b in BODIES], dtype=torch.float32)
    boundary = particles.active & (particles.neighbors < 0).any(1)
    mine, my_diag = retarded.render(ring, particles.object_index, boundary, colors,
                                    retarded.Camera(cam.pos, cam.zoom, cam.vel), 80, 48,
                                    retarded.RenderParams.from_fields(dataclasses.asdict(params)))
    assert torch.equal(img, mine) and (img != 1.0).any()
    for k, v in my_diag._asdict().items():
        if v is not None:
            assert int(getattr(diag, k)) == int(v), k
    pimg = points_cuda.render_points_plain(particles, objects, cam, 80, 48)
    assert torch.equal(pimg, points.render(particles.pos, particles.active,
                                           particles.object_index, colors, cam.pos, cam.zoom,
                                           80, 48))


def test_disc_radius_matches_the_published_count():
    assert scene.disc_radius(57980) == 136
    built = scene.build([BODIES[0]])
    assert np.isclose(np.abs(built.pos[1:] - built.pos[:-1]).min(), 0.0)
