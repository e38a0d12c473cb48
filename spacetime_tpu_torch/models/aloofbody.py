"""Aloof bodies: rigid relativistic bodies on prescribed worldlines.

Counterpart of `spacetime_tpu/models/aloofbody.py`.  An aloof body is a
rigid point template (its shape in its own rest frame) that follows a
trajectory `t -> (centre (2,), velocity (2,))` in the ground frame.  Each
tick the Engine samples `state_at(t)` — the template Lorentz-contracted
along the instantaneous velocity — and writes it into slots reserved after
the softbody particles: render-present, physics-inactive, so the bodies go
through the worldline ring and the renderers (retardation, Doppler,
occlusion) but never collide or bond.

`state_at` is branch-free torch, so with a trajectory written in torch
(`linear_trajectory`, `circular_trajectory`) the injection is captured in
the fused frame's CUDA graphs, at the device clock.  `capturable` tells
whether a set of bodies can be: each trajectory must map a 0-d `meta`
tensor to tensors.  A trajectory that reads its time on the host (float(t),
numpy) cannot; the Engine then runs its frames eagerly and passes such a
trajectory the tick's time as a 0-d CPU tensor.

On a device mesh each rank holds a block of the particle rows
(parallel/sharding.py), and the slots may lie in any of the blocks.  Every
rank computes all the bodies' states (a few thousand replicated points)
and writes the rows of the slots that fall in its own block: `Injection`'s
`block`.  A rank that holds none of them writes nothing.  The bounds are
host ints fixed at construction, so the write is still captured, and no
collective is needed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import constants


def text_template(text: str, spacing: float = constants.IMMEDIATE_NEIGHBOR_DIST
                  ) -> np.ndarray:
    """Rasterize `text` into a centred (M, 2) point template (rest frame).
    Needs pillow, imported here and nowhere else."""
    try:
        from PIL import Image, ImageDraw
    except ImportError as e:
        raise ImportError("text_template needs pillow (PIL) to rasterize text; "
                          "disc_template and box_template need nothing") from e

    img = Image.new("L", (8 * len(text) + 8, 16), 0)
    ImageDraw.Draw(img).text((2, 2), text, fill=255)
    ys, xs = np.nonzero(np.asarray(img) > 127)
    pts = np.stack([xs, ys], -1).astype(np.float32) * spacing
    return pts - pts.mean(0, keepdims=True)


def disc_template(radius_px: int, spacing: float = constants.IMMEDIATE_NEIGHBOR_DIST
                  ) -> np.ndarray:
    """The lattice points of a disc of `radius_px`, centred, (M, 2) f32."""
    from ..scene import disc_mask

    ys, xs = np.nonzero(disc_mask(radius_px))
    pts = np.stack([xs, ys], -1).astype(np.float32) * spacing
    return pts - pts.mean(0, keepdims=True)


def box_template(w_px: int, h_px: int, spacing: float = constants.IMMEDIATE_NEIGHBOR_DIST
                 ) -> np.ndarray:
    """The lattice points of a `w_px` x `h_px` box, centred, (M, 2) f32."""
    ys, xs = np.mgrid[0:h_px, 0:w_px]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32) * spacing
    return pts - pts.mean(0, keepdims=True)


@dataclasses.dataclass(eq=False)
class AloofBody:
    """Rigid template + trajectory.  `trajectory(t)` returns (centre (2,),
    velocity (2,)) in the ground frame for a 0-d f32 tensor `t`; |velocity|
    must stay below c."""

    template: np.ndarray  # (M, 2) rest-frame points, centred
    trajectory: Callable
    object_index: int = 0
    # the template as an f32 tensor per device, made outside any capture
    _templates: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_points(self) -> int:
        return self.template.shape[0]

    def _template_on(self, device) -> torch.Tensor:
        key = torch.device(device)
        if key not in self._templates:
            self._templates[key] = torch.as_tensor(np.asarray(self.template, np.float32),
                                                   device=key)
        return self._templates[key]

    def state_at(self, t) -> Tuple[torch.Tensor, torch.Tensor]:
        """Ground-frame (pos (M, 2), vel (M, 2)) at coordinate time `t` (a
        0-d tensor, or a number for a CPU one), the template contracted by
        1/gamma along the velocity.  Branch-free: the only host read is the
        speed check, made for CPU tensors alone (the JAX function makes it
        when not traced)."""
        t = torch.as_tensor(t, dtype=torch.float32)
        center, vel = self.trajectory(t)
        center = torch.as_tensor(center, dtype=torch.float32, device=t.device)
        vel = torch.as_tensor(vel, dtype=torch.float32, device=t.device)
        vx, vy = vel[0], vel[1]
        v2 = vx * vx + vy * vy
        if vel.device.type == "cpu" and float(v2) >= 1.0:
            raise ValueError(f"aloofbody speed {float(v2) ** 0.5:.4f} >= c")
        inv_gamma = torch.sqrt(torch.clamp(1.0 - v2, 1e-12, 1.0))
        speed = torch.sqrt(torch.clamp(v2, min=1e-24))
        moving = v2 > 1e-12
        hx = torch.where(moving, vx / speed, 0.0)
        hy = torch.where(moving, vy / speed, 0.0)
        tmpl = self._template_on(t.device)
        along = tmpl[:, 0] * hx + tmpl[:, 1] * hy
        par = torch.stack([along * hx, along * hy], dim=-1)
        pts = (tmpl - par) + par * inv_gamma  # == tmpl when v ~ 0
        pos = pts + center[None, :]
        return pos, vel[None, :].expand(pos.shape)


def capturable(bodies: Sequence[AloofBody]) -> bool:
    """Can every body's state be computed from a device clock inside a CUDA
    graph?  The counterpart of the JAX Engine's `_aloof_traceable`, which
    traces `state_at` with an abstract scalar: here each trajectory runs on
    a 0-d `meta` tensor and must return tensors, and `state_at` must run on
    it too."""
    t = torch.zeros((), dtype=torch.float32, device="meta")
    try:
        for body in bodies:
            out = body.trajectory(t)
            if not all(isinstance(x, torch.Tensor) and x.device.type == "meta" for x in out):
                return False
            body.state_at(t)
    except Exception:
        return False
    return True


class Injection:
    """Writes the states of `bodies` into the particle slots lo:hi (global
    rows), in place (the JAX Engine's `_inject_aloof_pure`).  `block`,
    (b_lo, b_hi), is the global rows that the particles passed in hold
    (this rank's block on a mesh; default: all of them): the rows
    [max(lo, b_lo), min(hi, b_hi)) are written, shifted by -b_lo.  With
    capturable trajectories the states come from the device clock `t`;
    otherwise from the tick's host time `host_time`, as a 0-d CPU tensor,
    copied to the device."""

    def __init__(self, bodies: Sequence[AloofBody], lo: int, hi: int,
                 block: Optional[Tuple[int, int]] = None):
        self.bodies, self.lo, self.hi = tuple(bodies), lo, hi
        b_lo, b_hi = (0, hi) if block is None else block
        first, last = max(lo, b_lo), min(hi, b_hi)  # the global rows written
        # rows of the concatenated states, and of the block (None: no slot here)
        here = first < last
        self._src = slice(first - lo, last - lo) if here else None
        self._dst = slice(first - b_lo, last - b_lo) if here else None
        self.capturable = capturable(self.bodies)

    def states(self, t: torch.Tensor, host_time=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pos, vel) of every slot, (hi - lo, 2) each, at `t` (or at
        `host_time` when the trajectories cannot be captured)."""
        if not self.capturable:
            if host_time is None:
                raise ValueError("a trajectory that cannot be captured needs the host time")
            t = torch.tensor(np.float32(host_time))
        states = [b.state_at(t) for b in self.bodies]
        return torch.cat([s[0] for s in states]), torch.cat([s[1] for s in states])

    def __call__(self, particles, t: torch.Tensor, host_time=None) -> None:
        if self._src is None:
            return  # none of the slots in this block
        pos, vel = self.states(t, host_time)
        particles.pos[self._dst].copy_(pos[self._src])
        particles.vel[self._dst].copy_(vel[self._src])

    def check_speed(self, t: torch.Tensor, host_time=None) -> None:
        """Raise if any slot's velocity at `t` reaches c (one host read).
        It reads every slot, not this block's, so every rank of a mesh
        reaches the same verdict."""
        vel = self.states(t, host_time)[1]
        top = float((vel * vel).sum(dim=-1).max())
        if top >= 1.0:
            raise ValueError(f"aloofbody speed {top ** 0.5:.4f} >= c")


def linear_trajectory(p0: Sequence[float], vel: Sequence[float]):
    """Constant-velocity worldline, p0 + vel t (f32, as the JAX one)."""
    (px, py), (vx, vy) = (np.asarray(p0, np.float32).tolist(),
                          np.asarray(vel, np.float32).tolist())

    def traj(t):
        return (torch.stack([px + vx * t, py + vy * t]),
                torch.stack([torch.full_like(t, vx), torch.full_like(t, vy)]))

    return traj


def circular_trajectory(center: Sequence[float], radius: float, speed: float):
    """Uniform circular motion about `center` (|v| = speed < c)."""
    cx, cy = np.asarray(center, np.float32).tolist()
    omega = speed / radius

    def traj(t):
        a = omega * t
        pos = torch.stack([cx + radius * torch.cos(a), cy + radius * torch.sin(a)])
        vel = speed * torch.stack([-torch.sin(a), torch.cos(a)])
        return pos, vel

    return traj
