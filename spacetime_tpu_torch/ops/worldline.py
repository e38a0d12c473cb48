"""Worldline history ring buffer.

Counterpart of `spacetime_tpu/ops/worldline.py`.  Each stored tick keeps
every particle's (pos, vel) in four TIME-major (2T, N) planes, one per
scalar component; the time axis is MIRRORED (slot s is also written at
s + T), so any backward window of up to T ticks is a contiguous row range.

Unlike the JAX package, pushes update the planes IN PLACE: two row writes
per plane per push.  `cursor` and `frames_in_use` are host ints, because
every push is driven from the host — that keeps a device sync out of every
frame.
"""

from __future__ import annotations

import dataclasses

import torch

from ..state import Particles


@dataclasses.dataclass
class WorldlineBuffer:
    pos_x: torch.Tensor  # (2T, N) f32, mirrored time axis (dim 0)
    pos_y: torch.Tensor  # (2T, N)
    vel_x: torch.Tensor  # (2T, N)
    vel_y: torch.Tensor  # (2T, N)
    times: torch.Tensor  # (T,) f32 — coordinate time per slot (-inf = unused)
    cursor: int  # slot holding the newest tick
    frames_in_use: int  # ramp-up counter, saturates at T

    @property
    def capacity(self) -> int:
        return self.times.shape[0]

    @property
    def num_particles(self) -> int:
        return self.pos_x.shape[1]

    def to(self, device) -> "WorldlineBuffer":
        return dataclasses.replace(
            self,
            pos_x=self.pos_x.to(device), pos_y=self.pos_y.to(device),
            vel_x=self.vel_x.to(device), vel_y=self.vel_y.to(device),
            times=self.times.to(device),
        )


def create(capacity: int, num_particles: int, device="cpu") -> WorldlineBuffer:
    """Empty history of `capacity` ticks: the oldest visible event is
    capacity * dt in the past."""
    plane = lambda fill: torch.full(
        (2 * capacity, num_particles), fill, dtype=torch.float32, device=device
    )
    return WorldlineBuffer(
        pos_x=plane(1e9),
        pos_y=plane(1e9),
        vel_x=plane(0.0),
        vel_y=plane(0.0),
        times=torch.full((capacity,), -float("inf"), dtype=torch.float32, device=device),
        cursor=capacity - 1,
        frames_in_use=0,
    )


def push_raw(buf: WorldlineBuffer, pos, vel, present, time) -> WorldlineBuffer:
    """Store one tick in place and return `buf`: the cursor advances with
    wraparound and the in-use count saturates at capacity.  Slots not
    `present` are parked at 1e9.  `time` is a float or a 0-d tensor."""
    t_cap = buf.capacity
    cursor = (buf.cursor + 1) % t_cap
    rows = (cursor, cursor + t_cap)  # the slot and its mirror
    for plane, values in (
        (buf.pos_x, torch.where(present, pos[:, 0], 1e9)),
        (buf.pos_y, torch.where(present, pos[:, 1], 1e9)),
        (buf.vel_x, vel[:, 0]),
        (buf.vel_y, vel[:, 1]),
    ):
        for row in rows:
            plane[row].copy_(values)
    buf.times[cursor] = time
    buf.cursor = cursor
    buf.frames_in_use = min(buf.frames_in_use + 1, t_cap)
    return buf


def push_frame(buf: WorldlineBuffer, particles: Particles, time, present=None
               ) -> WorldlineBuffer:
    """Store the current physics tick in place (see push_raw); `present`
    defaults to the active mask."""
    if present is None:
        present = particles.active
    return push_raw(buf, particles.pos, particles.vel, present, time)


def prefill_inertial(buf: WorldlineBuffer, pos, vel, present, t0, dt
                     ) -> WorldlineBuffer:
    """Warm start: fill the whole ring assuming bodies were inertial before
    t0 (pos(t) = pos0 + vel (t - t0)); returns a new full buffer."""
    t_cap = buf.capacity
    n = pos.shape[0]
    dev = pos.device
    rel_t = (torch.arange(t_cap, dtype=torch.float32, device=dev) - (t_cap - 1)) * dt
    rel2 = torch.cat([rel_t, rel_t])  # mirrored

    def fill(p, v):
        out = p[None, :] + v[None, :] * rel2[:, None]
        return torch.where(present[None, :], out, 1e9)

    return WorldlineBuffer(
        pos_x=fill(pos[:, 0], vel[:, 0]),
        pos_y=fill(pos[:, 1], vel[:, 1]),
        vel_x=vel[:, 0][None, :].expand(2 * t_cap, n).contiguous(),
        vel_y=vel[:, 1][None, :].expand(2 * t_cap, n).contiguous(),
        times=t0 + rel_t,
        cursor=t_cap - 1,
        frames_in_use=t_cap,
    )


def slot_of_age(buf: WorldlineBuffer, age: int) -> int:
    """Slot holding the tick `age` steps before the newest (age 0 = newest)."""
    return (buf.cursor - age) % buf.capacity


def pos_at_age(buf: WorldlineBuffer, age: int) -> torch.Tensor:
    """(N, 2) positions at a given age."""
    slot = slot_of_age(buf, age)
    return torch.stack([buf.pos_x[slot], buf.pos_y[slot]], dim=-1)


def boundary_mask(particles: Particles) -> torch.Tensor:
    """(N,) bool: particles on a softbody surface — active with any missing
    bond slot."""
    return particles.active & torch.any(particles.neighbors < 0, dim=-1)
