"""The headline frame of the reference's `bench.py` (lines 41-86), built
with the port: two lattice-padded discs of 5,025 particles each, 10,050
active at capacity 13,312, approaching at 0.25c each; a T=1024 mirrored
worldline ring prefilled inertially; and the RenderParams of a 1920x1080
opaque retarded render with Doppler and beaming.

A frame is `model.step -> worldline.push_frame -> raytrace.render_retarded`
(planar, with `boundary=worldline.boundary_mask(particles)`), as
`bench.py:88-95` runs it; the discs meet at about frame 170.

`refdemo_config()` is the Engine config of the reference's demo scene in
points mode: the procedural fallback of `tools/refdemo.py` (two
lattice-padded discs of 57,980 particles each, 116,178 active at capacity
149,248) seen at 1920x1080 through the camera of its benches.
`build_refdemo()` is the same scene's retarded frame, the one
`tools/refdemo.py` builds for the JAX benches: a T=1024 ring (4.9 GB) and
its render params, with rank compaction (`segments`) and `splat_cells=4`.

`build_capacity()` is `tools/bench_1m.py`'s capacity scene: two 1024 x 512
lattice-padded box bodies closing at 0.05c each, exactly 2^20 particles
(the reference's MAX_PARTICLES), a grid of 768 cells, a T=128 ring (4.3
GB) and a 960x540 retarded render watching the contact interface.
"""

from __future__ import annotations

from . import scene
from .engine import build_scene
from .camera import Camera
from .models.softbody import SoftbodyModel
from .ops import forces, raytrace
from .ops import worldline as wl
from .utils.config import BLUE, RED, EngineConfig, SceneSpec

WIDTH, HEIGHT, HISTORY = 1920, 1080, 1024
# tools/bench_1m.py: the capacity frame's view and ring, and its grid (the
# scene spans 1024 * 0.0035 = 3.58 ls; 768 cells of 0.005 ls cover 3.84)
CAPACITY_WIDTH, CAPACITY_HEIGHT, CAPACITY_HISTORY = 960, 540, 128
CAPACITY_BOX = (1024, 512)
CAPACITY_GRID_DIM = 768


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


def refdemo_config() -> EngineConfig:
    """The reference demo scene (`tools/refdemo.py:43-55`, the procedural
    fallback for testimg4/5: discs of radius_for_count(57980) = 136 px at
    (0, 0) and (1.2, 0.8), closing at 0.1c per axis each) in points mode,
    camera (0.6, 0.4) at zoom 2.0 (`tools/refdemo.py:92`), history 1024."""
    return EngineConfig(
        scene=SceneSpec(bodies=(
            ("disc", 57980, (0.0, 0.0), (0.1, 0.1), BLUE),
            ("disc", 57980, (1.2, 0.8), (-0.1, -0.1), RED),
        )),
        width=WIDTH,
        height=HEIGHT,
        history=HISTORY,
        cam_pos=(0.6, 0.4),
        cam_zoom=2.0,
        render_mode="points",
    )


def refdemo_params(h: float) -> raytrace.RenderParams:
    """`tools/refdemo.py:70-76`'s render params with two changes, each
    because the reference's value drops work every frame and
    chip_smoke.py's refdemo gate fails on any drop:

      * bin_capacity 128, not 96: at 96 full view bins drop candidates
        (VERDICT.md:16-19; 21 on an NVIDIA H100 after 70 frames,
        chip_smoke.py's segments check);
      * segments 3, not 2: a particle in view crosses the past light cone
        in 2 or 3 ring segments ((2 rho + dt) / dt = 2.04 ticks, more while
        approaching), and 2 slots drop the youngest crossing of every
        particle with 3 (11,002 a frame there, in the JAX package as in
        the port).  At 3 nothing drops, the valid pairs (127,811) stay
        within pair_budget and the splat entries within entry_budget."""
    return raytrace.RenderParams(
        dt=h, num_rays=4096, pair_budget=131072, entry_budget=262144,
        bin_capacity=128, cell_px=16, occlusion_downsample=2, ray_chunk=8192,
        band=4, splat_cells=4, retina_budget=8192, max_age=256, segments=3,
    )


def build_refdemo(device, history: int = HISTORY):
    """(model, particles, objects, buf, cam, params) of the reference demo's
    retarded frame on `device`: refdemo_config's scene, a `history`-tick
    ring prefilled inertially, the camera at (0.6, 0.4), zoom 2.0, and
    refdemo_params."""
    cfg = refdemo_config()
    particles, objects = build_scene(cfg.scene, device)
    offsets = forces.derive_spring_offsets(particles.neighbors.cpu().numpy())
    model = SoftbodyModel(particles.capacity, offsets, device=device)
    buf = wl.create(history, particles.capacity, device=device)
    buf = wl.prefill_inertial(buf, particles.pos, particles.vel, particles.active,
                              0.0, model.params.h)
    cam = Camera.create(pos=cfg.cam_pos, zoom=cfg.cam_zoom, device=device)
    return model, particles, objects, buf, cam, refdemo_params(model.params.h)


def build_capacity(device, history: int = CAPACITY_HISTORY):
    """(model, particles, objects, buf, cam, params) of the capacity scene
    on `device` (`tools/bench_1m.py:33-104`): two CAPACITY_BOX box bodies,
    the blue at (0, 0) moving +y at 0.05c, the red at (0, 1.85) moving -y,
    capacity 2^20 exactly (box bodies have no lattice padding); the model
    with grid_dim CAPACITY_GRID_DIM; a `history`-tick ring prefilled
    inertially; the camera at (1.79, 1.82), zoom 0.9; and bench_1m's render
    params (4096 rays, pair budget 131072, bin capacity 128, 16 px cells,
    band 4, the 2x2 splat, retina budget 16384, the whole ring swept).  The
    JAX bench's `wmax` and `split_windows` are TPU knobs with no
    counterpart here."""
    sb = scene.SceneBuilder()
    sb.add(scene.mask_to_softbody(scene.box_mask(*CAPACITY_BOX), 0, (0.0, 0.0), (0.0, 0.05),
                                  lattice_pad=True), base_color=(0.25, 0.35, 1.0))
    sb.add(scene.mask_to_softbody(scene.box_mask(*CAPACITY_BOX), 1, (0.0, 1.85), (0.0, -0.05),
                                  lattice_pad=True), base_color=(1.0, 0.3, 0.25))
    particles, objects = sb.build(device=device)
    offsets = forces.derive_spring_offsets(particles.neighbors.cpu().numpy())
    model = SoftbodyModel(particles.capacity, offsets, device=device)
    model.grid_dim = CAPACITY_GRID_DIM
    buf = wl.create(history, particles.capacity, device=device)
    buf = wl.prefill_inertial(buf, particles.pos, particles.vel, particles.active,
                              0.0, model.params.h)
    cam = Camera.create(pos=(1.79, 1.82), zoom=0.9, device=device)
    params = raytrace.RenderParams(
        dt=model.params.h, num_rays=4096, pair_budget=131072, bin_capacity=128, cell_px=16,
        occlusion_downsample=2, ray_chunk=8192, band=4, splat_cells=4, retina_budget=16384,
        max_age=0,
    )
    return model, particles, objects, buf, cam, params
