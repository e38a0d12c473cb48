"""The configuration's bodies as particle arrays, built from the body
specs alone: a body is the filled disc or box of its spec on a square
lattice, each particle bonded to the (up to) eight lattice neighbours that
the body holds, at rest mass 1, moving with the body's velocity.

Bodies are listed in the configuration's order, each body's particles
row by row (y, then x) from its lower corner, which is where the lattice
starts: `pos = offset + (x, y) * spacing`.  A particle's bonds are an
(n, 8) table of indices into that list (-1: none), the four immediate
neighbours first, then the four diagonal ones, as the physics reads them
(physics.rest_lengths).  Nothing here reads the program.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np

SPACING = 0.0035  # lattice spacing, lightseconds
# (dx, dy) of the neighbour slots: immediate, then diagonal
SLOTS = ((-1, 0), (0, -1), (1, 0), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1))


class Scene(NamedTuple):
    pos: np.ndarray  # (n, 2) f64
    vel: np.ndarray  # (n, 2) f64
    body: np.ndarray  # (n,) i32 body index
    neighbors: np.ndarray  # (n, 8) i32, -1 = no bond
    colors: np.ndarray  # (bodies, 3) f64


def disc_radius(count: int) -> int:
    """The radius (lattice steps) whose filled disc holds the count nearest
    to `count`; of equal counts the first found from round(sqrt(count /
    pi)) - 2 up."""
    def filled(r):
        k = np.arange(-r, r + 1)
        return int(((k[:, None] ** 2 + k[None, :] ** 2) <= r * r).sum())

    r0 = max(1, int(round(math.sqrt(count / math.pi))))
    best = r0
    for r in range(max(1, r0 - 2), r0 + 3):
        if abs(filled(r) - count) < abs(filled(best) - count):
            best = r
    return best


def _cells(kind: str, size) -> np.ndarray:
    """(y, x) lattice cells of one body, row by row, from its lower corner."""
    if kind == "disc":
        r = disc_radius(int(size))
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        keep = xx * xx + yy * yy <= r * r
        cells = np.stack([yy[keep], xx[keep]], axis=1)
    elif kind == "box":
        w, h = size
        yy, xx = np.mgrid[0:h, 0:w]
        cells = np.stack([yy.reshape(-1), xx.reshape(-1)], axis=1)
    else:
        raise ValueError(f"unknown body kind {kind!r}")
    cells = cells - cells.min(axis=0)
    order = np.lexsort((cells[:, 1], cells[:, 0]))
    return cells[order]


def build(bodies: List[dict]) -> Scene:
    """The scene of body specs {kind, size, offset, vel, rgb}."""
    pos, vel, body, nbr = [], [], [], []
    base = 0
    for b, spec in enumerate(bodies):
        cells = _cells(spec["kind"], spec["size"])
        n = cells.shape[0]
        h, w = cells.max(axis=0) + 1
        grid = np.full((h + 2, w + 2), -1, np.int64)  # a halo of -1 round the body
        grid[cells[:, 0] + 1, cells[:, 1] + 1] = np.arange(base, base + n)
        nbr.append(np.stack([grid[cells[:, 0] + 1 + dy, cells[:, 1] + 1 + dx]
                             for dx, dy in SLOTS], axis=1).astype(np.int32))
        pos.append(np.asarray(spec["offset"], np.float64)[None, :]
                   + cells[:, ::-1].astype(np.float64) * SPACING)
        vel.append(np.tile(np.asarray(spec["vel"], np.float64), (n, 1)))
        body.append(np.full(n, b, np.int32))
        base += n
    return Scene(np.concatenate(pos), np.concatenate(vel), np.concatenate(body),
                 np.concatenate(nbr), np.asarray([spec["rgb"] for spec in bodies], np.float64))


def bond_pairs(neighbors: np.ndarray, index: np.ndarray) -> np.ndarray:
    """The (b, 2) sorted i < j bond list of an (n, 8) neighbour table whose
    entries are row numbers, renumbered by `index` (row -> position in the
    list, -1 for rows outside it); each bond must appear from both ends."""
    rows = np.repeat(np.arange(neighbors.shape[0]), neighbors.shape[1])
    cols = neighbors.reshape(-1)
    ok = cols >= 0
    a, b = index[rows[ok]], index[cols[ok]]
    if (a < 0).any() or (b < 0).any():
        raise ValueError("a bond reaches a particle outside the scene")
    directed = set(zip(a.tolist(), b.tolist()))
    if any((j, i) not in directed for i, j in directed):
        raise ValueError("a bond is held from one end only")
    pairs = sorted((i, j) for i, j in directed if i < j)
    return np.asarray(pairs, np.int64).reshape(-1, 2)
