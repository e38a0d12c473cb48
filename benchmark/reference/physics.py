"""One physics tick of the softbody scene, in plain torch.

The scheme is the one the reference engine runs (relativistic RK4 with its
own stage dataflow), written down from its rules:

  * force on a particle: Hooke springs along its bonds, F = -k (L - R) d/L,
    R the slot's rest length (immediate or diagonal), plus a repulsion of
    constant magnitude `repulsion` along d/L from every other active
    particle closer than the collision distance that it is not bonded to;
  * acceleration a = (F - (v.F) v) / (m0 gamma), always at the tick's
    ORIGINAL velocity v0;
  * stages: p1 = p0 + (v0 + a(F(p0)) h/2) h/2, p2 likewise from F(p1), p3 =
    p0 + (v0 + a(F(p2)) h) h; the forces combine as F0 + 2 F1 + 2 F2 + F3,
    v = v0 + a(sum) h/6, |v| >= 1 clamps to max_speed, p = p0 + v h;
  * bonds longer than the break threshold at the START positions break
    from both ends, and the count of broken slots is the tick's
    `bonds_broken`; inactive slots keep their state.

Contacts are found from scratch at every force evaluation by a hash of
cells one collision distance wide, so each evaluation is exact.  A cell
holding more than MAX_PER_CELL particles, or a particle 1,000 ls away or
not finite, means the state has collapsed (no sound state packs a
lattice that densely or flies that far): `Collapsed` is raised.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_PER_CELL = 64


class Collapsed(ValueError):
    """The state has collapsed (see the module docstring)."""


class Params(NamedTuple):
    h: float = 0.005
    k: float = 15000.0
    immediate: float = 0.0035
    diagonal: float = 0.0035 * 2.0 ** 0.5
    collision_distance: float = 0.002
    repulsion: float = 100.0
    break_threshold: float = 0.01
    max_speed: float = 0.9999


def rest_lengths(params: Params, device) -> torch.Tensor:
    """(8,) rest length by neighbour slot: four immediate, then four
    diagonal."""
    return torch.tensor([params.immediate] * 4 + [params.diagonal] * 4, dtype=torch.float32,
                        device=device)


def accel(force, vel, mass):
    vdotf = (vel * force).sum(-1, keepdim=True)
    gamma = 1.0 / torch.sqrt(1.0 - (vel * vel).sum(-1, keepdim=True))
    return (force - vdotf * vel) / (mass[:, None] * gamma)


def springs(pos, neighbors, rest, k):
    bonded = neighbors >= 0
    j = neighbors.clamp(min=0).long()
    d = pos[:, None, :] - pos[j]  # (N, 8, 2)
    length = torch.sqrt((d * d).sum(-1))
    mag = torch.where(bonded & (length > 0),
                      -k * (length - rest[None, :]) / length.clamp(min=1e-12), 0.0)
    return (mag[..., None] * d).sum(1)


def contact_pairs(pos, active, reach: float):
    """(i, j) of every ordered pair of distinct active particles closer than
    `reach`."""
    idx = active.nonzero().squeeze(1)
    p = pos[idx]
    if not bool(torch.isfinite(p).all()) or float(p.abs().max()) > 1e3:
        raise Collapsed("a particle left the scene")
    cell = torch.floor(p / reach).long()
    cell = cell - cell.min(0).values + 1
    ny = int(cell[:, 1].max()) + 2
    key = cell[:, 0] * ny + cell[:, 1]
    skey, order = torch.sort(key)
    found_i, found_j = [], []
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            q = key + ox * ny + oy
            lo = torch.searchsorted(skey, q)
            count = torch.searchsorted(skey, q, right=True) - lo
            most = int(count.max()) if count.numel() else 0
            if most > MAX_PER_CELL:
                raise Collapsed(f"{most} particles in one contact cell")
            for t in range(most):
                a = (count > t).nonzero().squeeze(1)
                b = order[lo[a] + t]
                dx = p[a, 0] - p[b, 0]
                dy = p[a, 1] - p[b, 1]
                d2 = dx * dx + dy * dy
                near = (d2 < reach * reach) & (d2 > 0.0)
                found_i.append(a[near])
                found_j.append(b[near])
    i = torch.cat(found_i) if found_i else idx[:0]
    j = torch.cat(found_j) if found_j else idx[:0]
    return idx[i], idx[j]


def contacts(pos, active, neighbors, reach: float, repulsion: float):
    i, j = contact_pairs(pos, active, reach)
    bonded = (neighbors[i].long() == j[:, None]).any(1)
    i, j = i[~bonded], j[~bonded]
    d = pos[i] - pos[j]
    f = repulsion * d / torch.sqrt((d * d).sum(-1, keepdim=True))
    return torch.zeros_like(pos).index_add_(0, i, f), int(i.numel())


class Tick(NamedTuple):
    pos: torch.Tensor
    vel: torch.Tensor
    neighbors: torch.Tensor
    bonds_broken: int
    contacts: int  # contact pairs of the first force evaluation


def tick(pos0, vel0, neighbors, mass, active, params: Params = Params()) -> Tick:
    """One tick from (pos0, vel0, neighbors); f32 in, f32 out."""
    h = params.h
    rest = rest_lengths(params, pos0.device)
    pos_c = torch.where(active[:, None], pos0, 0.0)  # parked slots never enter a sum
    count = []

    def force(p):
        f, n = contacts(p, active, neighbors, params.collision_distance, params.repulsion)
        count.append(n)
        return springs(p, neighbors, rest, params.k) + f

    def stage(f, hs):
        return pos_c + (vel0 + accel(f, vel0, mass) * hs) * hs

    f0 = force(pos_c)
    f1 = force(stage(f0, h / 2.0))
    f2 = force(stage(f1, h / 2.0))
    f3 = force(stage(f2, h))
    vel = vel0 + accel(f0 + 2.0 * f1 + 2.0 * f2 + f3, vel0, mass) * (h / 6.0)
    speed = torch.sqrt((vel * vel).sum(-1, keepdim=True))
    vel = torch.where(speed >= 1.0, vel / speed.clamp(min=1e-20) * params.max_speed, vel)
    pos = pos0 + vel * h
    bonded = neighbors >= 0
    j = neighbors.clamp(min=0).long()
    d = pos_c[:, None, :] - pos_c[j]
    broke = bonded & (torch.sqrt((d * d).sum(-1)) > params.break_threshold)
    act = active[:, None]
    return Tick(torch.where(act, pos, pos0), torch.where(act, vel, vel0),
                torch.where(broke, -1, neighbors), int(broke.sum()), count[0])
