"""The comparison that decides `correct`.

What is compared (every number against its limit, `limits/<cell>.json`):

  * `scene_gap_ls`: the program's initial particles against the scene the
    reference builds from the same body specs (reference/scene.py): the
    largest gap of a position or a velocity, or infinity if the count,
    the order, a body, a rest mass or a bond differs;
  * `advance_gap_ls`: the program's particles at the episode's first frame
    against the reference's ticks from its own scene over the same
    frames (the set-up's advance, which the window never runs);
  * for each window frame that the seed samples, from the state the
    program held just before it:
      - `step_pos_p999_ls`, `step_vel_p999`: the 99.9th percentile over
        the active particles of the gap of a position and of a velocity
        after the frame's tick (reference/physics.py), which holds the
        bulk of the particles to rounding;
      - `step_pos_max_ls`, `step_vel_max`: the largest of those gaps,
        which holds every particle, under a limit that leaves room for
        the repulsion's cutoff: its magnitude is constant, so a pair whose
        distance lies within rounding of the cutoff (or of 0, where its
        direction is undefined) takes its force on one side and not the
        other, up to repulsion * h / 3 of velocity (0.17 c at the
        defaults) and h times that of position in one particle;
      - `bond_mismatch`: bond slots that differ, plus the gap in
        `bonds_broken`, plus the other StepAux counters (0 in the
        reference);
      - `ring_mismatch`: entries of the pushed ring row (positions,
        velocities, the tick's time, the cursor and the in-use count) that
        differ from the push of the program's own particles after the tick;
      - `image_px_share`: the share of pixels whose colour differs by more
        than 1e-3 in a channel from the image that the render mode's
        reference makes of the frame from the program's particles after
        the tick and its ring after the frame;
      - `render_counter_gap`: the render's counters (pairs, truncations,
        drops) against those of the mode's reference, the largest gap
        relative to max(1, the reference's count); 0 where the reference
        gives none.

The reference's physics is the configuration's `physics` block (the
program's PhysicsParams names, mapped by PHYSICS); its render is the
traffic's mode's, reference/<mode>.py (spec.mode_reference says what that
module declares and gives).  The mode's `image` and `control` get the
configuration's values of the keys it declares in its CONFIG_KEYS, and of
no other key (`mode_config`): the conical mode's `defect`, say.  A
configuration that sets a field the check does not model (CONFIG_KEYS,
PHYSICS, the mode's own keys and render values), or a traffic mode with
no reference, is refused before a run starts (`require_modeled`).

The reference imports nothing of the program.  With `control`, the
reference itself takes the program's place, computed on bfloat16 state:
every position and velocity it is given or gives back rounded to
bfloat16 (the step a later change could take to halve the state's and
the ring's bytes), and the frame's render as the mode's `control` makes
it (the retarded view of the ring's planes in bfloat16, the point view's
pixel arithmetic in bfloat16).
The ring comparison and the bond comparison are exact (limit 0); the
control's push of its own state is exact by construction, so its ring
reading is 0, and a push that is wrong is what the faults' tests plant.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from . import spec
from .reference import physics as ref_physics
from .reference import scene as ref_scene

PIXEL_TOL = 1e-3  # a channel gap above this counts a pixel as differing
NUMBERS = ("scene_gap_ls", "advance_gap_ls", "step_pos_p999_ls", "step_vel_p999",
           "step_pos_max_ls", "step_vel_max", "bond_mismatch", "ring_mismatch",
           "image_px_share", "render_counter_gap")
# the keys of a configuration file the check models in every mode: its own
# description, the scene and episode, the grid (which changes no result),
# the physics and render blocks, and EngineConfig fields that do not change
# what a frame computes from its state (the view's size, the ring's length,
# the camera's start, pacing, diagnostics, the eager path)
CONFIG_KEYS = {"name", "source", "reduced", "assumed", "bodies", "episode", "grid_dim",
               "physics", "render", "width", "height", "history", "cam_pos", "cam_zoom",
               "max_fps", "diag_every", "stage_timing"}
# PhysicsParams field -> reference Params field (None: the program's hash
# grid, which the reference does not share)
PHYSICS = {"h": "h", "k": "k", "immediate_neighbor_dist": "immediate",
           "diagonal_neighbor_dist": "diagonal", "collision_distance": "collision_distance",
           "collision_repulsion_coefficient": "repulsion",
           "bond_break_threshold": "break_threshold", "max_speed": "max_speed",
           "grid_resolution": None}
PARTICLE_FIELDS = ("pos", "vel", "neighbors", "rest_mass", "active", "object_index")
PLANES = ("pos_x", "pos_y", "vel_x", "vel_y")
RING_FIELDS = PLANES + ("times", "cursor", "frames_in_use")


class Sample(NamedTuple):
    """What the window keeps of one frame for the check."""

    before: Dict[str, torch.Tensor]  # PARTICLE_FIELDS before the frame
    ring_before: Dict[str, torch.Tensor]  # cursor and frames_in_use before
    t_before: float  # the Engine's clock before the frame
    after: Dict[str, torch.Tensor]  # PARTICLE_FIELDS after the frame
    ring: dict  # after the frame: see harness._ring
    image: torch.Tensor  # (3, H, W)
    counters: Dict[str, torch.Tensor]  # StepAux and the render's counters
    cam: tuple  # (pos, zoom, vel) tensors the frame used
    params: dict  # the frame's render parameters


def lowp(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def require_modeled(cfg: dict, mix: dict, here=spec.HERE) -> None:
    """Raise ValueError naming what of a cell's configuration and traffic
    the check does not model."""
    try:
        ref = spec.mode_reference(mix["mode"], here)
    except LookupError:
        ref = None
    bad = sorted(set(cfg) - CONFIG_KEYS - (ref.CONFIG_KEYS if ref else set()))
    bad += [f"physics.{k}" for k in sorted(set(cfg.get("physics", {})) - set(PHYSICS))]
    if ref is None:
        bad.append(f"mode {mix['mode']!r}")
    else:
        bad += [f"render.{k} {v!r}" for k, v in sorted(cfg.get("render", {}).items())
                if k in ref.RENDER and v not in ref.RENDER[k]]
    if bad:
        raise ValueError(f"configuration {cfg.get('name')!r}: the check does not model "
                         f"{', '.join(bad)}")


def mode_config(cfg: dict, ref) -> dict:
    """The configuration's values of the keys that the mode's reference
    `ref` declares (its CONFIG_KEYS), and no others: what its `image` and
    `control` are given."""
    return {k: cfg[k] for k in ref.CONFIG_KEYS if k in cfg}


def physics_params(cfg: dict) -> ref_physics.Params:
    """The reference's physics of a configuration: its `physics` block,
    the defaults elsewhere."""
    return ref_physics.Params(**{PHYSICS[k]: float(v) for k, v in cfg.get("physics", {}).items()
                                 if PHYSICS[k] is not None})


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def _p999(a: torch.Tensor, b: torch.Tensor) -> float:
    """The 99.9th percentile over rows of the largest gap of a row."""
    if not a.numel():
        return 0.0
    gaps = (a.double() - b.double()).abs().reshape(a.shape[0], -1).amax(dim=1)
    return float(torch.quantile(gaps, 0.999))


def scene_gap(bodies, initial: Dict[str, torch.Tensor], control: bool) -> float:
    """`scene_gap_ls` of the program's initial particles."""
    ref = ref_scene.build(bodies)
    act = initial["active"].cpu().numpy()
    if int(act.sum()) != ref.pos.shape[0]:
        return math.inf
    rows = np.nonzero(act)[0]
    index = np.full(act.shape[0], -1, np.int64)
    index[rows] = np.arange(rows.shape[0])
    pos = initial["pos"].cpu().double().numpy()[rows]
    vel = initial["vel"].cpu().numpy()[rows]
    if control:
        pos = lowp(torch.from_numpy(ref.pos).float()).double().numpy()
        vel = lowp(torch.from_numpy(ref.vel).float()).numpy()
    nbr = initial["neighbors"].cpu().numpy()[rows]
    mine = np.where(nbr >= 0, index[np.clip(nbr, 0, None)], -1)
    same = ((initial["object_index"].cpu().numpy()[rows] == ref.body).all()
            and (initial["rest_mass"].cpu().numpy()[rows] == 1.0).all()
            and (np.sort(mine, axis=1) == np.sort(ref.neighbors, axis=1)).all())
    if not same:
        return math.inf
    return float(max(np.abs(pos - ref.pos).max(), np.abs(vel - ref.vel).max()))


def advance_gap(bodies, first: int, params: ref_physics.Params,
                start: Dict[str, torch.Tensor], device, control: bool) -> float:
    """`advance_gap_ls`: the reference's `first` ticks from its own scene
    against the program's particles at the episode start."""
    ref = ref_scene.build(bodies)
    act = start["active"]
    if int(act.sum()) != ref.pos.shape[0]:
        return math.inf
    f32 = lambda a: torch.from_numpy(np.asarray(a)).to(device=device, dtype=torch.float32)
    pos, vel = f32(ref.pos), f32(ref.vel)
    nbr = torch.from_numpy(ref.neighbors).to(device)
    mass = torch.ones(pos.shape[0], device=device)
    active = torch.ones(pos.shape[0], dtype=torch.bool, device=device)
    for _ in range(first):
        if control:
            pos, vel = lowp(pos), lowp(vel)
        try:
            t = ref_physics.tick(pos, vel, nbr, mass, active, params)
        except ref_physics.Collapsed:
            return math.inf
        pos, vel, nbr = t.pos, t.vel, t.neighbors
    if control:
        pos = lowp(pos)
    return _gap(start["pos"][act], pos)


def _program_or_control(s: Sample, params: ref_physics.Params, ref, colors, config: dict,
                        control: bool):
    """(after particles, pushed row, image, counters) of the frame: the
    program's, or with `control` the bfloat16 reference's."""
    if not control:
        return s.after, s.ring, s.image, s.counters
    b = s.before
    t = ref_physics.tick(lowp(b["pos"]), lowp(b["vel"]), b["neighbors"], b["rest_mass"],
                         b["active"], params)
    after = {**b, "pos": lowp(t.pos), "vel": lowp(t.vel), "neighbors": t.neighbors}
    ring = _push(s, after, params.h)
    counters = {"grid_overflow": 0, "bonds_broken": t.bonds_broken, "window_truncated": 0}
    image, diag = ref.control(s, after, colors, config)
    counters.update(diag)
    return after, ring, image, counters


def _push(s: Sample, after, h: float) -> Dict[str, torch.Tensor]:
    """The ring entries of a push of `after` at the tick's clock."""
    present = after["active"]
    t = np.float32(np.float32(s.t_before) + np.float32(h))
    cap = s.ring["times"].shape[0]
    cursor = (s.ring_before["cursor"].long() + 1) % cap
    return {"pos_x": torch.where(present, after["pos"][:, 0], 1e9),
            "pos_y": torch.where(present, after["pos"][:, 1], 1e9),
            "vel_x": after["vel"][:, 0], "vel_y": after["vel"][:, 1],
            "time": torch.tensor(float(t), device=present.device),
            "cursor": cursor.to(torch.int32),
            "frames_in_use": torch.clamp(s.ring_before["frames_in_use"] + 1, max=cap)}


def _pushed(ring: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The newest row of a ring after the frame (the row at `cursor` and
    its mirror, which must agree) and its time, cursor and in-use count."""
    out = {k: torch.where(lo == hi, lo, float("nan")) for k, (lo, hi) in ring["rows"].items()}
    out["time"] = ring["times"].index_select(0, ring["cursor"].long().reshape(1))[0]
    out["cursor"] = ring["cursor"]
    out["frames_in_use"] = ring["frames_in_use"]
    return out


def _mismatch(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]) -> int:
    return sum(int((a[k].reshape(-1) != b[k].reshape(-1)).sum()) for k in a)


def frame_numbers(s: Sample, params: ref_physics.Params, ref, colors, config: dict,
                  control: bool) -> Dict[str, float]:
    """The per-frame numbers of one sample: the program's outputs (or the
    control's) against the reference's from the same state, `ref` the
    render mode's reference (spec.mode_reference) and `config` its keys'
    values (mode_config).  A state that has collapsed reads infinity in
    every number."""
    try:
        after, ring, image, counters = _program_or_control(s, params, ref, colors, config,
                                                           control)
        b = s.before
        t = ref_physics.tick(b["pos"], b["vel"], b["neighbors"], b["rest_mass"], b["active"],
                             params)
    except ref_physics.Collapsed:
        return {k: math.inf for k in NUMBERS[2:]}
    act = b["active"]
    out = {"step_pos_p999_ls": _p999(after["pos"][act], t.pos[act]),
           "step_vel_p999": _p999(after["vel"][act], t.vel[act]),
           "step_pos_max_ls": _gap(after["pos"][act], t.pos[act]),
           "step_vel_max": _gap(after["vel"][act], t.vel[act])}
    bonds = int((after["neighbors"] != t.neighbors).sum())
    bonds += abs(int(counters["bonds_broken"]) - t.bonds_broken)
    bonds += abs(int(counters["grid_overflow"])) + abs(int(counters["window_truncated"]))
    out["bond_mismatch"] = bonds
    # the reference pushes the frame's own output particles
    pushed = _pushed(ring) if not control else ring
    want = _push(s, after, params.h)
    out["ring_mismatch"] = _mismatch({k: pushed[k] for k in want}, want)
    ref_img, ref_diag = ref.image(s, after, s.ring, colors, config)
    counter_gap = max((abs(float(counters[k]) - float(v)) / max(1.0, abs(float(v)))
                       for k, v in ref_diag.items()), default=0.0)
    differs = ((image - ref_img).abs() > PIXEL_TOL).any(dim=0)
    out["image_px_share"] = float(differs.double().mean())
    out["render_counter_gap"] = counter_gap
    return out


def numbers(cfg: dict, mode: str, first: int, initial, start, samples, device,
            control: bool = False, here=spec.HERE) -> Dict[str, float]:
    """Every number of the check (NUMBERS) of a cell whose configuration
    is `cfg` and whose traffic's mode is `mode`, the per-frame ones
    maximised over the samples."""
    ref = spec.mode_reference(mode, here)
    bodies, params = cfg["bodies"], physics_params(cfg)
    colors = torch.tensor([b["rgb"] for b in bodies], dtype=torch.float32, device=device)
    config = mode_config(cfg, ref)
    out = {"scene_gap_ls": scene_gap(bodies, initial, control),
           "advance_gap_ls": advance_gap(bodies, first, params, start, device, control)}
    for s in samples:
        for k, v in frame_numbers(s, params, ref, colors, config, control).items():
            prev = out.get(k)  # the worst over the samples; a NaN stays
            out[k] = v if prev is None or math.isnan(v) or v > prev else prev
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number of NUMBERS is there and at or under its
    limit (a NaN fails)."""
    return all(k in values and values[k] <= limits[k] for k in NUMBERS)
