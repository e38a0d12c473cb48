"""Matter-sourced geometry: conical defects that follow the simulated matter.

Counterpart of `spacetime_tpu/ops/gravity.py`.  A defect can be sourced by
a softbody object instead of prescribed by the config: it sits at the
object's relativistic centre of energy sum(m0 gamma x) / sum(m0 gamma),
and a derived deficit is 8 pi G sum(m0 gamma) (a moving mass lenses by its
total energy).

Quasi-static sourcing places the defect at the current centroid.  With
`retarded`, `retarded_com` places it on the camera's past light cone
instead: on the per-age centroid track com(a) read from the worldline
ring, the unique crossing of f(a) = |com(a) - cam| - a dt (monotone, as
the centroid of subluminal matter is subluminal), interpolated linearly
between the straddling ticks.

Every ring read goes through a device index (`index_select`), never a host
int of the cursor, and no function here reads a value back to the host:
the fused frame captures them into a CUDA graph and replays them at each
frame's cursor.

On a mesh (`mesh`, parallel/) the particles and ring columns are this
rank's share, and each centre-of-energy sum is one all-reduce of the
ranks' partial sums (JAX's psums, `spacetime_tpu/parallel/sharding.py:
168-178`): three scalars for a quasi-static centroid, three per-age rows
(3 x A) for a retarded one.  The sums then differ from one device's by
their order of addition, within f32 rounding.
"""

from __future__ import annotations

import math

import torch

from .. import relativity
from ..parallel import comm
from ..state import Particles
from ..utils.profiling import spanned
from .worldline import WorldlineBuffer

EIGHT_PI = 8.0 * math.pi


def _pick(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a () integer device tensor i, read on the device."""
    return x.index_select(0, i.reshape(1).long())[0]


def object_energy_com(particles: Particles, obj: int, mesh=None):
    """Energy-weighted centroid of one object's active particles: (cx, cy,
    energy), the centre of energy and the total energy sum(m0 gamma)
    (c = 1), the conical source strength.  () tensors."""
    mask = particles.active & (particles.object_index == obj)
    g = relativity.gamma_v(particles.vel)
    w = torch.where(mask, particles.rest_mass * g, 0.0)
    sums = (w.sum(), (w * particles.pos[:, 0]).sum(), (w * particles.pos[:, 1]).sum())
    if mesh is not None:
        sums = comm.all_reduce(torch.stack(sums), mesh).unbind()
    en, sx, sy = sums
    tot = torch.clamp(en, min=1e-20)
    return sx / tot, sy / tot, en


def com_history(buf: WorldlineBuffer, object_index, rest_mass, active, obj: int,
                max_age: int = 0, mesh=None):
    """Per-age energy centroid track of one object from the ring planes:
    (com_x, com_y, energy, age), each (A,), ages descending A-1 .. 0 (the
    cone sweep's row order).  The weights use each age's velocities (gamma
    at emission)."""
    t_cap = buf.capacity
    a_sw = t_cap if max_age <= 0 else min(max_age, t_cap)
    dev = buf.pos_x.device
    rows = buf.cursor + (1 + t_cap - a_sw) + torch.arange(a_sw, dtype=torch.int32, device=dev)
    sx, sy, svx, svy = (plane.index_select(0, rows)
                        for plane in (buf.pos_x, buf.pos_y, buf.vel_x, buf.vel_y))
    mask = active & (object_index == obj)
    v2 = torch.clamp(svx * svx + svy * svy, max=1.0 - 1e-7)
    g = 1.0 / torch.sqrt(1.0 - v2)
    w = torch.where(mask[None, :], rest_mass[None, :] * g, 0.0)  # (A, N)
    sums = (w.sum(dim=1), (w * sx).sum(dim=1), (w * sy).sum(dim=1))
    if mesh is not None:
        sums = comm.all_reduce(torch.stack(sums), mesh).unbind()
    tot, wx, wy = sums
    den = torch.clamp(tot, min=1e-20)
    com_x = wx / den
    com_y = wy / den
    age = torch.arange(a_sw - 1, -1, -1, dtype=torch.int32, device=dev)
    return com_x, com_y, tot, age


def retarded_com(buf: WorldlineBuffer, object_index, rest_mass, active, obj: int,
                 cam_x, cam_y, dt: float, max_age: int = 0, mesh=None):
    """The object's centroid on the camera's past light cone: (cx, cy,
    energy) at the retarded time, linearly interpolated between the two
    ticks straddling |com(a) - cam| = a dt.  When the history is shorter
    than the crossing age, the oldest usable tick is returned."""
    com_x, com_y, tot, age = com_history(buf, object_index, rest_mass, active, obj, max_age,
                                         mesh)
    a_sw = age.shape[0]
    hi0 = torch.clamp(buf.frames_in_use - 1, max=a_sw - 1)
    dx = com_x - cam_x
    dy = com_y - cam_y
    f = torch.sqrt(dx * dx + dy * dy) - age.to(torch.float32) * dt
    usable = age <= hi0
    # the youngest crossed age (rows are age-descending: a masked min)
    crossed = (f <= 0.0) & usable
    a_star = torch.where(crossed, age, hi0).amin()
    # row r1 holds age a_star, row r0 its younger neighbour (f > 0)
    r1 = (a_sw - 1) - a_star
    r0 = torch.clamp(r1 + 1, 0, a_sw - 1)
    f1, f0 = _pick(f, r1), _pick(f, r0)
    denom = f0 - f1
    frac = torch.where(torch.abs(denom) > 1e-12, f0 / denom, 0.0)
    frac = torch.clamp(frac, 0.0, 1.0)  # 0: the younger tick, 1: a_star
    no_cross = ~crossed.any()
    oldest = (a_sw - 1) - hi0

    def at_cone(x):
        x0 = _pick(x, r0)
        lerp = x0 + (_pick(x, r1) - x0) * frac
        return torch.where(no_cross, _pick(x, oldest), lerp)

    return at_cone(com_x), at_cone(com_y), at_cone(tot)


@spanned("sourced defects")
def source_defects(specs, particles: Particles, buf, cam, dt: float, g_coupling: float,
                   retarded: bool, max_age: int = 0, mesh=None):
    """The ConicalDefect tuple of matter-sourced specs (config.defect_source:
    (object_index, deficit) pairs; deficit None derives 8 pi G energy from
    `g_coupling`).  With `retarded` (and a ring) each defect sits at its
    retarded centroid.  With `mesh` the state is this rank's share and the
    sums are all-reduced (see the module docstring)."""
    from .curved import ConicalDefect

    out = []
    for obj, deficit in specs:
        if retarded and buf is not None:
            cx, cy, en = retarded_com(buf, particles.object_index, particles.rest_mass,
                                      particles.active, int(obj), cam.pos[0], cam.pos[1], dt,
                                      max_age, mesh)
        else:
            cx, cy, en = object_energy_com(particles, int(obj), mesh)
        d = EIGHT_PI * g_coupling * en if deficit is None else deficit
        out.append(ConicalDefect.create((cx, cy), d, device=cx.device))
    return tuple(out)
