"""Engine + scene configuration (counterpart of
`spacetime_tpu/utils/config.py`).

`SceneSpec` and `EngineConfig` keep the JAX field names and defaults;
`render` holds the port's RenderParams and `wl3d` the port's
Worldline3DParams.

The registry keeps every name of the JAX package, and every named config is
built field for field as the JAX function builds it (`png_demo`'s image
paths are resolved from this package, so they equal JAX's after
`os.path.realpath`); an unknown name raises KeyError.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from ..constants import DEFAULT_PARAMS, PhysicsParams
from ..ops.raytrace import RenderParams
from ..ops.worldline3d import Worldline3DParams


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Scene description: bodies = (kind, arg, offset, vel, rgb) with kind in
    {"disc" (arg = particle count), "box" (arg = (w_px, h_px)),
     "image" (arg = PNG path, read by utils/png.py)}."""

    bodies: Tuple[tuple, ...]
    capacity: Optional[int] = None
    # pad bodies to their bounding boxes (regular bond offsets -> shifted-
    # slice spring physics); False keeps the masks' own rows, whose
    # irregular bond offsets take the row-gather physics
    lattice_pad: bool = True
    # per-body material id into EngineConfig.materials (None = all 0)
    material_indices: Optional[Tuple[int, ...]] = None


@dataclasses.dataclass(frozen=True, kw_only=True)
class EngineConfig:
    # registry key when built via get_config; "" for ad-hoc configs
    name: str = ""
    scene: SceneSpec = None
    physics: PhysicsParams = DEFAULT_PARAMS
    render: RenderParams = RenderParams()
    width: int = 256
    height: int = 256
    history: int = 512  # worldline ring capacity (ticks)
    cam_pos: Tuple[float, float] = (0.5, 0.5)
    cam_zoom: float = 1.0
    cam_vel: Tuple[float, float] = (0.0, 0.0)
    cam_accel: Tuple[float, float] = (0.0, 0.0)  # Rindler-style proper acceleration
    max_fps: float = 72.0  # frame pacing target (Engine.hotswap, run(realtime=True))
    # retarded | instant | points | retina | conical | btz | worldline3d
    render_mode: str = "retarded"
    steps_per_frame: int = 1
    # conical-defect mass(es) for the conical mode: a single
    # ((cx, cy), deficit_rad) or a tuple of them (single-scattering
    # superposition, ops/curved.py)
    defect: Optional[Tuple] = None
    # quasi-static defect motion: one (vx, vy) per defect
    defect_vel: Optional[Tuple[Tuple[float, float], ...]] = None
    # place moving defects (and matter-sourced ones) at their retarded
    # position on the camera's past light cone instead of at t_now
    defect_retarded: bool = False
    # matter-sourced defects (ops/gravity.py): (object_index, deficit)
    # pairs, each defect at that object's centre of energy; deficit None
    # derives 8 pi defect_G energy.  Appended after the `defect` entries
    defect_source: Optional[Tuple] = None
    defect_G: float = 0.0  # 2+1D gravitational coupling for derived deficits
    # the btz mode's hole (ops/btz.py): ((cx, cy), mass, ads_l[, spin])
    btz: Optional[Tuple] = None
    # view parameters of the worldline3d mode
    wl3d: Worldline3DParams = Worldline3DParams()
    # per-stage timing: run the frame eagerly with CUDA-event stage times
    # instead of replaying the fused frame's CUDA graphs
    stage_timing: bool = False
    # read StepAux/RenderDiag every N frames: warn + adapt budgets
    diag_every: int = 30
    # per-material rows (ops/materials.py): (k_scale, damping, break_scale
    # [, creep_rate, yield_strain]) per material id; None = all default
    materials: Optional[Tuple[Tuple[float, ...], ...]] = None


def _blob(count, offset, vel, rgb):
    return ("disc", count, tuple(offset), tuple(vel), tuple(rgb))


BLUE = (0.25, 0.35, 1.0)
RED = (1.0, 0.3, 0.25)


def config_single_blob() -> EngineConfig:
    """One softbody blob (3,965 particles), static camera, 256x256."""
    return EngineConfig(
        scene=SceneSpec(bodies=(_blob(3965, (0.2, 0.3), (0.1, 0.1), BLUE),)),
        width=256,
        height=256,
        history=384,
        cam_pos=(0.65, 0.5),
        render=RenderParams(bin_capacity=256),
    )


def config_two_body_collision() -> EngineConfig:
    """Two softbodies colliding at a relativistic closing speed, 512x512."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(4000, (0.30, 0.30), (0.25, 0.25), BLUE),
                _blob(4000, (0.95, 0.85), (-0.25, -0.25), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.65, 0.6),
        render=RenderParams(bin_capacity=128),
    )


def config_flagship_1080p() -> EngineConfig:
    """Two 5,000-particle discs closing at 0.9c, 1920x1080, full Doppler +
    beaming, history 1024."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(5000, (0.35, 0.40), (0.45, 0.1), BLUE),
                _blob(5000, (1.05, 0.55), (-0.45, -0.1), RED),
            )
        ),
        render=RenderParams(num_rays=4096, pair_budget=32768, bin_capacity=64,
                            entry_budget=131072),
        width=1920,
        height=1080,
        history=1024,
        cam_pos=(0.7, 0.5),
        cam_zoom=1.2,
    )


def config_accelerated_camera() -> EngineConfig:
    """An accelerated (Rindler) camera sweeping over three blobs."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(2000, (0.30, 0.35), (0.0, 0.15), BLUE),
                _blob(2000, (0.75, 0.55), (0.0, -0.15), RED),
                _blob(2000, (0.50, 0.80), (0.15, 0.0), (0.3, 0.9, 0.4)),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.2, 0.5),
        cam_vel=(0.0, 0.0),
        cam_accel=(0.5, 0.0),
        render=RenderParams(bin_capacity=128),
    )


def config_boosted_observer() -> EngineConfig:
    """Camera-frame (boosted) map view: a camera at 0.5c flies between two
    blobs, and the view plots every past-cone event in the camera's
    instantaneous rest frame (ops/boost.py)."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.55, 0.30), (0.0, 0.0), BLUE),
                _blob(3000, (0.05, 0.55), (0.0, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.25, 0.5),
        cam_vel=(0.5, 0.0),
        # bin_capacity pre-sized 256: the warped splat's stretched reach
        # densifies bins
        render=RenderParams(bin_capacity=256, camera_frame=True),
    )


def config_plastic_collision() -> EngineConfig:
    """Plastic vs damped elastic collision: the blue blob creeps (it stays
    dented after the impact), the red one does not."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.30, 0.50), (0.12, 0.0), BLUE),
                _blob(3000, (0.70, 0.50), (-0.12, 0.0), RED),
            ),
            material_indices=(0, 1),
        ),
        width=512,
        height=512,
        history=384,
        cam_pos=(0.5, 0.5),
        render=RenderParams(bin_capacity=128),
        # blue: creeping solder-like material; red: damped elastic
        materials=((1.0, 25.0, 1.0, 25.0, 0.10), (1.0, 10.0, 1.0)),
    )


def config_rindler_horizon() -> EngineConfig:
    """A camera under proper acceleration 2 c/s: its horizon 0.5 ls behind
    it freezes the trailing blob's image while the leading blob stays
    live."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(1500, (-0.45, 0.42), (0.0, 0.0), RED),
                _blob(1500, (0.85, 0.42), (0.0, 0.0), BLUE),
            )
        ),
        width=512,
        height=256,
        history=768,
        cam_pos=(0.45, 0.5),
        cam_zoom=2.4,
        cam_accel=(2.0, 0.0),
        render=RenderParams(bin_capacity=384),
    )


def config_conical_defect() -> EngineConfig:
    """Curved 2+1 spacetime: geodesic rays around a conical-defect mass
    (ops/curved.py), two 3,000-particle discs, 512x512."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.25, 0.50), (0.0, 0.3), BLUE),
                _blob(3000, (0.75, 0.50), (0.0, -0.3), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.1),  # off the defect: geodesic routes degenerate at r=0
        render_mode="conical",
        defect=((0.5, 0.55), 1.2),
    )


def config_btz_hole() -> EngineConfig:
    """A BTZ black hole (ops/btz.py): closed-form null geodesics,
    gravitational time delay, double images and the black horizon disc;
    two 3,000-particle discs passing it, 512x512."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.25, 0.50), (0.0, 0.3), BLUE),
                _blob(3000, (0.75, 0.50), (0.0, -0.3), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.08),
        render_mode="btz",
        # ads_l of the scene's scale keeps the lapse f = r^2/l^2 - M of order
        # 1 where the bodies live; r_h = 0.45 sqrt(0.03) = 0.078
        btz=((0.5, 0.5), 0.03, 0.45),
    )


def config_btz_reflected() -> EngineConfig:
    """btz_hole with the routes reflected off the AdS boundary: echo images
    ~230-450 ticks late, so the history reaches 768."""
    base = config_btz_hole()
    return dataclasses.replace(
        base, render=dataclasses.replace(base.render, btz_reflections=True), history=768)


def config_btz_spinning() -> EngineConfig:
    """btz_hole rotating at J = 0.004 (~30% of the extremal M l): the
    slow-rotation drag splits the double images in time."""
    return dataclasses.replace(config_btz_hole(), btz=((0.5, 0.5), 0.03, 0.45, 0.004))


def config_btz_extremal() -> EngineConfig:
    """btz_hole near extremality (J = 0.012, 89% of M l) with the exact
    rotating-metric solve (ops/btz_exact.py)."""
    base = config_btz_hole()
    return dataclasses.replace(
        base, btz=((0.5, 0.5), 0.03, 0.45, 0.012),
        render=dataclasses.replace(base.render, btz_exact_spin=True))


def config_btz_photon_ring() -> EngineConfig:
    """btz_hole with winding-1 routes (images that circle the hole once,
    ~700-850 ticks late), so the history reaches 1024."""
    base = config_btz_hole()
    return dataclasses.replace(
        base, render=dataclasses.replace(base.render, btz_windings=1), history=1024)


def config_worldline3d() -> EngineConfig:
    """The worldline ring of a two-body collision drawn as an (x, y, t)
    block seen side-on (ops/worldline3d.py); shell_only draws the boundary
    tube."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(2000, (0.32, 0.50), (0.2, 0.0), BLUE),
                _blob(2000, (0.68, 0.50), (-0.2, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.5),
        cam_zoom=1.1,
        render_mode="worldline3d",
        wl3d=Worldline3DParams(time_scale=0.45, fade=0.75, max_age=384),
    )


def config_selfgravity() -> EngineConfig:
    """Matter-sourced gravity (ops/gravity.py): each blob sources its own
    conical defect at its centre of energy, the deficit derived from the
    energy via defect_G, placed on the camera's past light cone along the
    stored centroid track."""
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                _blob(3000, (0.30, 0.50), (0.25, 0.0), BLUE),
                _blob(3000, (0.70, 0.50), (-0.25, 0.0), RED),
            )
        ),
        width=512,
        height=512,
        history=512,
        cam_pos=(0.5, 0.32),  # off the collision axis: routes stay regular
        render_mode="conical",
        # derived deficits: 8 pi G E ~ 1.0 rad per blob at rest
        defect_source=((0, None), (1, None)),
        defect_G=1.0 / (8.0 * 3.14159265 * 3000.0),
        defect_retarded=True,
    )


def config_png_demo() -> EngineConfig:
    """The reference's demo path: two PNG blobs imported by
    image_to_softbody on a collision course (reference
    src/twoplusone/mod.rs:86-113 loads testimg4/testimg5 the same way; the
    fixtures are small procedural stand-in blobs), 384x384."""
    fx = os.path.join(os.path.dirname(__file__), "..", "..", "assets", "fixtures")
    return EngineConfig(
        scene=SceneSpec(
            bodies=(
                ("image", os.path.join(fx, "blob_a.png"), (0.25, 0.30), (0.12, 0.12), BLUE),
                ("image", os.path.join(fx, "blob_b.png"), (0.62, 0.58), (-0.12, -0.12), RED),
            )
        ),
        width=384,
        height=384,
        history=384,
        cam_pos=(0.55, 0.55),
        cam_zoom=0.9,
        # pre-sized bins (mid-size views run dense)
        render=RenderParams(bin_capacity=128),
    )


CONFIGS = {
    "single_blob": config_single_blob,
    "worldline3d": config_worldline3d,
    "btz_hole": config_btz_hole,
    "btz_reflected": config_btz_reflected,
    "btz_spinning": config_btz_spinning,
    "btz_extremal": config_btz_extremal,
    "btz_photon_ring": config_btz_photon_ring,
    "png_demo": config_png_demo,
    "two_body_collision": config_two_body_collision,
    "flagship_1080p": config_flagship_1080p,
    "accelerated_camera": config_accelerated_camera,
    "boosted_observer": config_boosted_observer,
    "conical_defect": config_conical_defect,
    "selfgravity": config_selfgravity,
    "plastic_collision": config_plastic_collision,
    "rindler_horizon": config_rindler_horizon,
}


def get_config(name: str) -> EngineConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return dataclasses.replace(CONFIGS[name](), name=name)
