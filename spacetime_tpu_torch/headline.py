"""The headline frame of the reference's `bench.py` (lines 41-86), built
with the port: two lattice-padded discs of 5,025 particles each, 10,050
active at capacity 13,312, approaching at 0.25c each; a T=1024 mirrored
worldline ring prefilled inertially; and the RenderParams of a 1920x1080
opaque retarded render with Doppler and beaming.

A frame is `model.step -> worldline.push_frame -> raytrace.render_retarded`
(planar, with `boundary=worldline.boundary_mask(particles)`), as
`bench.py:88-95` runs it; the discs meet at about frame 170.
"""

from __future__ import annotations

from . import scene
from .camera import Camera
from .models.softbody import SoftbodyModel
from .ops import forces, raytrace
from .ops import worldline as wl

WIDTH, HEIGHT, HISTORY = 1920, 1080, 1024


def build(device):
    """(model, particles, objects, buf, cam, params) on `device`."""
    sb = scene.SceneBuilder()
    r = scene.radius_for_count(5000)
    sb.add(scene.disc_softbody(r, 0, (0.35, 0.40), (0.25, 0.05), lattice_pad=True),
           base_color=(0.25, 0.35, 1.0))
    sb.add(scene.disc_softbody(r, 1, (1.05, 0.55), (-0.25, -0.05), lattice_pad=True),
           base_color=(1.0, 0.3, 0.25))
    particles, objects = sb.build(device=device)
    offsets = forces.derive_spring_offsets(particles.neighbors.cpu().numpy())
    model = SoftbodyModel(particles.capacity, offsets, device=device)
    buf = wl.create(HISTORY, particles.capacity, device=device)
    buf = wl.prefill_inertial(buf, particles.pos, particles.vel, particles.active,
                              0.0, model.params.h)
    cam = Camera.create(pos=(0.7, 0.5), zoom=1.2, device=device)
    params = raytrace.RenderParams(
        dt=model.params.h, num_rays=4096, pair_budget=32768, bin_capacity=64,
        cell_px=16, occlusion_downsample=2, ray_chunk=8192, retina_budget=8192,
        max_age=160, entry_budget=131072,
    )
    return model, particles, objects, buf, cam, params

