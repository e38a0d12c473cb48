"""State carried across from the JAX package.

Each function takes a mapping of dataclass field name -> numpy array (for
the JAX pytrees: `np.asarray(getattr(x, f))` per field) and a device, and
returns the port's state, so both packages compute from the same inputs.
Conical defects, BTZ holes and the worldline3d view parameters convert
from the JAX objects themselves.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from .camera import Camera
from .ops.materials import ParticleMaterials
from .ops.worldline import WorldlineBuffer
from .state import Objects, Particles


def _t(a, device, dtype=None) -> torch.Tensor:
    # np.array (not ascontiguousarray) keeps 0-d fields such as Camera.zoom 0-d
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def particles_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> Particles:
    rest_len = fields.get("rest_len")
    return Particles(
        pos=_t(fields["pos"], device, np.float32),
        vel=_t(fields["vel"], device, np.float32),
        rest_mass=_t(fields["rest_mass"], device, np.float32),
        neighbors=_t(fields["neighbors"], device, np.int32),
        object_index=_t(fields["object_index"], device, np.int32),
        particle_id=_t(fields["particle_id"], device, np.int32),
        active=_t(fields["active"], device, bool),
        rest_len=None if rest_len is None else _t(rest_len, device, np.float32),
    )


def objects_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> Objects:
    return Objects(
        offset=_t(fields["offset"], device, np.int32),
        material_index=_t(fields["material_index"], device, np.int32),
        base_color=_t(fields["base_color"], device, np.float32),
    )


def worldline_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> WorldlineBuffer:
    return WorldlineBuffer(
        pos_x=_t(fields["pos_x"], device, np.float32),
        pos_y=_t(fields["pos_y"], device, np.float32),
        vel_x=_t(fields["vel_x"], device, np.float32),
        vel_y=_t(fields["vel_y"], device, np.float32),
        times=_t(fields["times"], device, np.float32),
        cursor=_t(fields["cursor"], device, np.int32),
        frames_in_use=_t(fields["frames_in_use"], device, np.int32),
    )


def camera_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> Camera:
    return Camera(
        pos=_t(fields["pos"], device, np.float32),
        zoom=_t(fields["zoom"], device, np.float32),
        vel=_t(fields["vel"], device, np.float32),
    )


def materials_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> ParticleMaterials:
    """ParticleMaterials from its fields; a field missing or None stays None."""
    return ParticleMaterials(**{
        name: None if fields.get(name) is None else _t(fields[name], device, np.float32)
        for name in ParticleMaterials._fields
    })


def defects_from_numpy(defect, device="cpu"):
    """A ConicalDefect from one of the JAX package's (anything with `center`
    and `deficit` arrays), or a tuple of them from a tuple."""
    from .ops.curved import ConicalDefect

    if isinstance(defect, (tuple, list)):
        return tuple(defects_from_numpy(d, device) for d in defect)
    return ConicalDefect(center=_t(defect.center, device, np.float32),
                         deficit=_t(defect.deficit, device, np.float32))


def btz_hole_from_numpy(hole, device="cpu"):
    """The port's BTZBlackHole from the JAX package's (anything with
    `center`, `mass`, `ads_l` and `spin` arrays)."""
    from .ops.btz import BTZBlackHole

    return BTZBlackHole(**{f: _t(getattr(hole, f), device, np.float32)
                           for f in ("center", "mass", "ads_l", "spin")})


def worldline3d_params_from(params):
    """The port's Worldline3DParams with the field values of `params` (the
    JAX package's Worldline3DParams or any object with those fields)."""
    from .ops.worldline3d import Worldline3DParams

    return Worldline3DParams(**{f.name: getattr(params, f.name)
                                for f in dataclasses.fields(Worldline3DParams)})
