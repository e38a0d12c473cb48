"""Per-object material properties for the softbody solver.

Counterpart of `spacetime_tpu/ops/materials.py`.  A small host-side table of
per-material coefficients is expanded once per scene into per-particle (N,)
tensors on the particles' device, which the force functions read beside the
positions:

  * k_scale      spring stiffness multiplier (pairwise mean);
  * damping      spring-damper coefficient c: F = -c ((v_i - v_j) . d^) d^,
                 against the step's ORIGINAL velocities;
  * break_scale  bond break threshold multiplier (pairwise min);
  * creep_rate   plastic creep rate (1/time) of the per-bond rest lengths
                 (`Particles.rest_len`; pairwise min);
  * yield_strain relative elastic limit before creep starts (pairwise max).

Material rows are 3-tuples (k, damping, break) or 5-tuples adding
(creep_rate, yield_strain); 3-tuples imply no creep.  The JAX rules hold:
an all-default table gives None, and an all-default column gives None so
the force functions skip its arithmetic.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class ParticleMaterials(NamedTuple):
    """Per-particle planes expanded from the material table."""

    k_scale: Optional[torch.Tensor]  # (N,) or None
    damping: Optional[torch.Tensor]  # (N,) or None
    break_scale: Optional[torch.Tensor]  # (N,) or None
    creep_rate: Optional[torch.Tensor] = None  # (N,) or None (no creep anywhere)
    yield_strain: Optional[torch.Tensor] = None  # (N,) or None (creep from zero strain)


# (k_scale, damping, break_scale[, creep_rate, yield_strain]) per material id
MaterialSpec = Tuple[float, ...]
DEFAULT_MATERIAL: MaterialSpec = (1.0, 0.0, 1.0, 0.0, 0.0)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def particle_materials(table: Sequence[MaterialSpec], material_index,
                       object_index: torch.Tensor) -> Optional[ParticleMaterials]:
    """Expand the per-material table to per-particle planes (once per scene).

    `material_index` maps object -> material id (a tensor or an array),
    `object_index` particle -> object; the planes land on `object_index`'s
    device.  Returns None when every particle has the default material."""
    device = object_index.device
    rows = [tuple(r) + (0.0, 0.0)[: 5 - len(r)] for r in table]
    tab = np.asarray(rows, np.float32).reshape(-1, 5)
    mat_of_obj = _host(material_index)
    obj_of_p = _host(object_index)
    mat_of_p = mat_of_obj[np.clip(obj_of_p, 0, len(mat_of_obj) - 1)]
    mat_of_p = np.clip(mat_of_p, 0, len(tab) - 1)
    per_p = tab[mat_of_p]  # (N, 5)
    default = [np.all(per_p[:, c] == v) for c, v in enumerate(DEFAULT_MATERIAL)]
    if all(default[:4]):
        return None
    plane = lambda c: torch.from_numpy(np.ascontiguousarray(per_p[:, c])).to(device)
    has_creep = not default[3]
    return ParticleMaterials(
        k_scale=None if default[0] else plane(0),
        damping=None if default[1] else plane(1),
        break_scale=None if default[2] else plane(2),
        creep_rate=plane(3) if has_creep else None,
        yield_strain=plane(4) if has_creep and not default[4] else None,
    )
