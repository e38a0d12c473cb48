"""Spring and collision forces (plain torch).

Counterpart of `spacetime_tpu/ops/forces.py`:

  * Hooke springs to up to 8 bonded neighbors,
        F += -k (|d| - rest) * d/|d|,  d = p_self - p_neighbor,
    with an optional per-particle stiffness scale (pairwise mean) and a
    spring-damper term (ops/materials.py);
  * plastic creep of the per-bond rest lengths;
  * the repulsion of BONDED pairs, subtracted from the collision kernel's
    all-pairs sum (ops/forces_cuda.py) to exclude bonded neighbors;
  * the O(n^2) collision oracle the tests hold the kernel against.

Two ways to read a particle's bonded partners, as in the JAX package:

  * "shifted" (lattice-padded scenes): slot s of particle i bonds to i + d
    for one of the slot's offsets d (`derive_spring_offsets`).  JAX reads
    those partners with static rolls; here they are read with one gather
    `px[col]`, which returns the same value on every lane the rule selects
    (col = i + d lies in [0, N), so the roll never wraps there).
  * "rows" (any bond graph, `derive_spring_offsets` returned None): every
    valid slot is a bond, read by the same gather.  JAX packs each
    particle's fields into an (N, 8) row for one row gather, a TPU layout
    trick; a plain gather per field replaces it.

Per-slot contributions are summed slot by slot in slot order, as JAX's
loop does.

On a mesh (parallel/) each rank computes the rows of its own particles:
`row0` is the global index of its first row, the neighbour table and the
per-bond rest lengths are its block's rows, and every per-particle plane
the bonds read (positions, velocities, material scales) is global, so a
bond to another rank's particle reads its partner directly.  Each row's
value is the single-device row's, bit for bit.
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


def _bonded_slots(neighbors, offsets, row0: int = 0):
    """(sel, j), each (B, 8) for the B rows of `neighbors` (global rows
    row0..): `sel` marks slots whose bond is one of the slot's offsets
    (the -1 sentinel never selects), `j` the bonded index (clamped to 0
    where the slot is empty)."""
    n = neighbors.shape[0]
    iota = torch.arange(row0, row0 + n, dtype=neighbors.dtype, device=neighbors.device)
    diff = neighbors - iota[:, None]  # (N, 8)
    sel = (neighbors >= 0) & (diff[:, :, None] == offsets[None, :, :]).any(dim=2)
    return sel, neighbors.clamp(min=0).long()


def _sum_slots(c: torch.Tensor) -> torch.Tensor:
    """Sum an (N, 8) contribution table slot by slot, in slot order."""
    acc = c[:, 0]
    for s in range(1, c.shape[1]):
        acc = acc + c[:, s]
    return acc


def _row_slots(neighbors):
    """(valid, j) for any bond graph: every valid slot is a bond."""
    return neighbors >= 0, neighbors.clamp(min=0).long()


def _own(x, row0: int, rows: int):
    """The rows of global plane `x` that a block of `rows` rows from row0
    owns (all of it on one device), as a column for broadcasting."""
    return x[row0:row0 + rows, None]


def _springs(bonded, j, px, py, rest_lengths, k, k_pp, row0=0):
    b = bonded.shape[0]
    dx = _own(px, row0, b) - px[j]
    dy = _own(py, row0, b) - py[j]
    dist = torch.sqrt(dx * dx + dy * dy)
    inv = torch.where(dist > 0, 1.0 / torch.clamp(dist, min=_EPS), 0.0)
    kk = k if k_pp is None else k * 0.5 * (_own(k_pp, row0, b) + k_pp[j])
    rl = rest_lengths if rest_lengths.dim() == 2 else rest_lengths[None, :]
    mag = torch.where(bonded, -kk * (dist - rl) * inv, 0.0)
    return _sum_slots(mag * dx), _sum_slots(mag * dy)


def _damping(bonded, j, px, py, vx, vy, c_pp, row0=0):
    b = bonded.shape[0]
    dx = _own(px, row0, b) - px[j]
    dy = _own(py, row0, b) - py[j]
    dvx = _own(vx, row0, b) - vx[j]
    dvy = _own(vy, row0, b) - vy[j]
    inv2 = 1.0 / torch.clamp(dx * dx + dy * dy, min=_EPS)
    cc = 0.5 * (_own(c_pp, row0, b) + c_pp[j])
    mag = torch.where(bonded, -cc * (dvx * dx + dvy * dy) * inv2, 0.0)
    return _sum_slots(mag * dx), _sum_slots(mag * dy)


def _creep(bonded, j, px, py, rest_len, creep_rate, yield_strain, h, row0=0):
    b = bonded.shape[0]
    dx = _own(px, row0, b) - px[j]
    dy = _own(py, row0, b) - py[j]
    dist = torch.sqrt(dx * dx + dy * dy)
    c_pair = torch.minimum(_own(creep_rate, row0, b), creep_rate[j])
    if yield_strain is None:
        y_pair = 0.0
    else:
        y_pair = torch.maximum(_own(yield_strain, row0, b), yield_strain[j])
    excess = torch.clamp(dist - rest_len * (1.0 + y_pair), min=0.0)
    return torch.where(bonded, rest_len + c_pair * h * excess, rest_len)


def spring_forces_shifted(px, py, neighbors, offsets, rest_lengths, k, k_pp=None, row0=0):
    """Hooke spring force sum over bonded slots; returns (fx, fy).
    `rest_lengths` is (8,) per slot or (N, 8) per bond; `k_pp` (N,)
    optionally scales the stiffness per particle, the pair taking the
    endpoint mean so forces stay equal and opposite.  `row0`: see the
    module docstring (a mesh rank's rows)."""
    return _springs(*_bonded_slots(neighbors, offsets, row0), px, py, rest_lengths, k, k_pp,
                    row0)


def bond_damping_shifted(px, py, vx, vy, neighbors, offsets, c_pp, row0=0):
    """Spring-damper force along bonds, F_i = -c_ij ((v_i - v_j) . d^) d^
    with c_ij the endpoint mean of `c_pp` (symmetric, so momentum is
    conserved).  The velocities are the step's ORIGINAL ones (ops/rk4.py
    evaluates every stage against them)."""
    return _damping(*_bonded_slots(neighbors, offsets, row0), px, py, vx, vy, c_pp, row0)


def creep_rest_lengths_shifted(px, py, neighbors, offsets, rest_len, creep_rate,
                               yield_strain, h, row0=0):
    """Plastic creep: per-bond rest lengths grow toward the current length
    when stretched past the yield strain,

        R' = R + c_pair * h * max(0, L - R * (1 + y_pair)),

    with c_pair = min(c_i, c_j) and y_pair = max(y_i, y_j) (0 when
    `yield_strain` is None), so both reciprocal slots of a bond update to
    the same value.  Returns the new (N, 8) rest lengths."""
    return _creep(*_bonded_slots(neighbors, offsets, row0), px, py, rest_len, creep_rate,
                  yield_strain, h, row0)


def bonded_repulsion_shifted(px, py, neighbors, offsets, collision_distance,
                             repulsion, row0=0):
    """Repulsion contributed by BONDED neighbors — the collision kernel's own
    per-pair formula (rsqrt of dist2, constant magnitude) — for subtraction
    from the kernel's all-pairs sum."""
    sel, j = _bonded_slots(neighbors, offsets, row0)
    b = sel.shape[0]
    dx = _own(px, row0, b) - px[j]
    dy = _own(py, row0, b) - py[j]
    cd2 = collision_distance * collision_distance
    dist2 = dx * dx + dy * dy
    hit = sel & (dist2 < cd2) & (dist2 > 0.0)
    inv = torch.rsqrt(torch.clamp(dist2, min=1e-20))
    mag = torch.where(hit, repulsion * inv, 0.0)
    return _sum_slots(mag * dx), _sum_slots(mag * dy)


def spring_forces_rows(px, py, neighbors, rest_lengths, k, k_pp=None, c_pp=None,
                       vx=None, vy=None, row0=0):
    """Hooke springs over every valid bond slot (any bond graph); returns
    (fx, fy).  With materials it adds the pairwise-mean stiffness scale
    `k_pp` and the spring-damper force of `c_pp` against the velocities
    (vx, vy), as spring_forces_shifted and bond_damping_shifted do."""
    slots = _row_slots(neighbors)
    fx, fy = _springs(*slots, px, py, rest_lengths, k, k_pp, row0)
    if c_pp is not None:
        dfx, dfy = _damping(*slots, px, py, vx, vy, c_pp, row0)
        fx, fy = fx + dfx, fy + dfy
    return fx, fy


def creep_rest_lengths_rows(pos, neighbors, rest_len, creep_rate, yield_strain, h, row0=0):
    """creep_rest_lengths_shifted over every valid bond slot (any bond
    graph)."""
    return _creep(*_row_slots(neighbors), pos[:, 0], pos[:, 1], rest_len, creep_rate,
                  yield_strain, h, row0)


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
