"""State carried across from the JAX package.

Each function takes a mapping of dataclass field name -> numpy array (for
the JAX pytrees: `np.asarray(getattr(x, f))` per field) and a device, and
returns the port's state, so both packages compute from the same inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .camera import Camera
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
        cursor=int(fields["cursor"]),
        frames_in_use=int(fields["frames_in_use"]),
    )


def camera_from_numpy(fields: Mapping[str, np.ndarray], device="cpu") -> Camera:
    return Camera(
        pos=_t(fields["pos"], device, np.float32),
        zoom=_t(fields["zoom"], device, np.float32),
        vel=_t(fields["vel"], device, np.float32),
    )
