"""Engine + scene configuration (counterpart of
`spacetime_tpu/utils/config.py`).

`SceneSpec` and `EngineConfig` keep the JAX field names and defaults;
`render` holds the port's RenderParams.  One JAX field is left out: the
`wl3d` view parameters, which wait for the worldline3d mode.  Fields whose
feature is not ported yet (defects, BTZ) are kept so configs read the
same; the Engine refuses them.

The registry keeps every name of the JAX package.  Seven named configs are
built field for field as the JAX functions build them; every other name
raises NotImplementedError naming what it waits for; an unknown name
raises KeyError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..constants import DEFAULT_PARAMS, PhysicsParams
from ..ops.raytrace import RenderParams


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Scene description: bodies = (kind, arg, offset, vel, rgb) with kind in
    {"disc" (arg = particle count), "box" (arg = (w_px, h_px)),
     "image" (arg = PNG path; needs pillow)}."""

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
    max_fps: float = 72.0  # frame pacing target (realtime pacing is not ported yet)
    render_mode: str = "retarded"  # retarded | instant | points | retina (others not ported)
    steps_per_frame: int = 1
    # per-stage timing: run the frame eagerly with CUDA-event stage times
    # instead of replaying the fused frame's CUDA graphs
    stage_timing: bool = False
    # not ported yet (the Engine raises when set): conical defects, BTZ
    defect: Optional[Tuple] = None
    defect_vel: Optional[Tuple[Tuple[float, float], ...]] = None
    defect_retarded: bool = False
    defect_source: Optional[Tuple] = None
    defect_G: float = 0.0
    btz: Optional[Tuple] = None
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


def _waits_for(name: str, what: str):
    def config() -> EngineConfig:
        raise NotImplementedError(
            f"config {name!r} waits for {what}, not ported to spacetime_tpu_torch yet")
    return config


_BTZ = "the btz render mode (ops/btz.py)"
CONFIGS = {
    "single_blob": config_single_blob,
    "worldline3d": _waits_for("worldline3d", "the worldline3d render mode (ops/worldline3d.py)"),
    "btz_hole": _waits_for("btz_hole", _BTZ),
    "btz_reflected": _waits_for("btz_reflected", _BTZ),
    "btz_spinning": _waits_for("btz_spinning", _BTZ),
    "btz_extremal": _waits_for("btz_extremal", _BTZ + " with the exact solver (ops/btz_exact.py)"),
    "btz_photon_ring": _waits_for("btz_photon_ring", _BTZ),
    "png_demo": _waits_for("png_demo",
                           "PNG import that needs no pillow (the port does not depend on it)"),
    "two_body_collision": config_two_body_collision,
    "flagship_1080p": config_flagship_1080p,
    "accelerated_camera": config_accelerated_camera,
    "boosted_observer": config_boosted_observer,
    "conical_defect": _waits_for("conical_defect", "the conical render mode (ops/curved.py)"),
    "selfgravity": _waits_for(
        "selfgravity", "the conical render mode and gravity (ops/curved.py, ops/gravity.py)"),
    "plastic_collision": config_plastic_collision,
    "rindler_horizon": config_rindler_horizon,
}


def get_config(name: str) -> EngineConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown config {name!r}; choose from {sorted(CONFIGS)}")
    return dataclasses.replace(CONFIGS[name](), name=name)
