"""Spring and collision forces (plain torch).

Counterpart of the shifted-spring half of `spacetime_tpu/ops/forces.py`:

  * Hooke springs to up to 8 bonded neighbors,
        F += -k (|d| - rest) * d/|d|,  d = p_self - p_neighbor;
  * the repulsion of BONDED pairs, subtracted from the collision kernel's
    all-pairs sum (ops/forces_cuda.py) to exclude bonded neighbors;
  * the O(n^2) collision oracle the tests hold the kernel against.

"Shifted" keeps the JAX package's rule for which bonds count: slot s of
particle i bonds to i + d for one of the slot's offsets d
(`derive_spring_offsets`).  JAX reads those partners with static rolls;
here they are read with one gather `px[col]`, which returns the same value
on every lane the rule selects (col = i + d lies in [0, N), so the roll
never wraps there).  Per-slot contributions are summed slot by slot in slot
order, as JAX's loop does.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-20
# pads each slot's offset row; never equals a neighbor-index difference
_NO_OFFSET = np.iinfo(np.int32).max


def derive_spring_offsets(neighbors, max_offsets: int = 8):
    """Distinct index offsets (nbr[i, s] - i) per bond slot, from the initial
    neighbor table (numpy).  Returns a tuple of 8 offset tuples, or None
    when a slot has more than `max_offsets` distinct values (an irregular
    graph).  Bond breaking only writes -1, so offsets stay valid."""
    nbr = np.asarray(neighbors)
    n = nbr.shape[0]
    idx = np.arange(n, dtype=np.int64)
    out = []
    for s in range(nbr.shape[1]):
        col = nbr[:, s].astype(np.int64)
        valid = col >= 0
        d = np.unique(col[valid] - idx[valid])
        if d.size > max_offsets:
            return None
        out.append(tuple(int(x) for x in d))
    return tuple(out)


def spring_offsets_tensor(offsets, device="cpu") -> torch.Tensor:
    """(8, D) i32 table of `derive_spring_offsets` output, padded per slot
    with a value no index difference takes."""
    width = max(1, max(len(ds) for ds in offsets))
    table = np.full((len(offsets), width), _NO_OFFSET, np.int32)
    for s, ds in enumerate(offsets):
        table[s, : len(ds)] = ds
    return torch.from_numpy(table).to(device)


def _bonded_deltas(px, py, neighbors, offsets):
    """(sel, dx, dy), each (N, 8): `sel` marks slots whose bond is one of the
    slot's offsets (the -1 sentinel never selects), dx/dy = p_i - p_bond."""
    n = px.shape[0]
    iota = torch.arange(n, dtype=neighbors.dtype, device=neighbors.device)
    col = neighbors
    diff = col - iota[:, None]  # (N, 8)
    sel = (col >= 0) & (diff[:, :, None] == offsets[None, :, :]).any(dim=2)
    j = col.clamp(min=0).long()
    dx = px[:, None] - px[j]
    dy = py[:, None] - py[j]
    return sel, dx, dy


def _sum_slots(c: torch.Tensor) -> torch.Tensor:
    """Sum an (N, 8) contribution table slot by slot, in slot order."""
    acc = c[:, 0]
    for s in range(1, c.shape[1]):
        acc = acc + c[:, s]
    return acc


def spring_forces_shifted(px, py, neighbors, offsets, rest_lengths, k):
    """Hooke spring force sum over bonded slots; returns (fx, fy).
    `rest_lengths` is (8,) per slot or (N, 8) per bond."""
    sel, dx, dy = _bonded_deltas(px, py, neighbors, offsets)
    dist = torch.sqrt(dx * dx + dy * dy)
    inv = torch.where(dist > 0, 1.0 / torch.clamp(dist, min=_EPS), 0.0)
    rl = rest_lengths if rest_lengths.dim() == 2 else rest_lengths[None, :]
    mag = torch.where(sel, -k * (dist - rl) * inv, 0.0)
    return _sum_slots(mag * dx), _sum_slots(mag * dy)


def bonded_repulsion_shifted(px, py, neighbors, offsets, collision_distance,
                             repulsion):
    """Repulsion contributed by BONDED neighbors — the collision kernel's own
    per-pair formula (rsqrt of dist2, constant magnitude) — for subtraction
    from the kernel's all-pairs sum."""
    sel, dx, dy = _bonded_deltas(px, py, neighbors, offsets)
    cd2 = collision_distance * collision_distance
    dist2 = dx * dx + dy * dy
    hit = sel & (dist2 < cd2) & (dist2 > 0.0)
    inv = torch.rsqrt(torch.clamp(dist2, min=1e-20))
    mag = torch.where(hit, repulsion * inv, 0.0)
    return _sum_slots(mag * dx), _sum_slots(mag * dy)


def collision_forces(pos, cand_idx, cand_valid, neighbors, collision_distance,
                     repulsion):
    """Constant-magnitude repulsion from candidates, excluding self and
    bonded neighbors — with all-pairs candidates, the O(n^2) oracle."""
    n = pos.shape[0]
    px, py = pos[:, 0], pos[:, 1]
    dx = px[:, None] - px[cand_idx.long()]
    dy = py[:, None] - py[cand_idx.long()]
    dist = torch.sqrt(dx * dx + dy * dy)
    is_self = cand_idx == torch.arange(n, dtype=cand_idx.dtype, device=pos.device)[:, None]
    is_bond = torch.zeros_like(cand_valid)
    for s in range(neighbors.shape[1]):
        is_bond = is_bond | (cand_idx == neighbors[:, s][:, None])
    hit = cand_valid & ~is_self & ~is_bond & (dist < collision_distance) & (dist > 0)
    mag = torch.where(hit, repulsion / torch.clamp(dist, min=_EPS), 0.0)
    return torch.stack([torch.sum(mag * dx, dim=1), torch.sum(mag * dy, dim=1)], dim=-1)
