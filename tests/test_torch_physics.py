"""Parity of the PyTorch port's physics (spacetime_tpu_torch) with the JAX
reference (spacetime_tpu), on the CPU at small sizes.

Inputs come from numpy seeds and go through both packages; the JAX side
runs as its own tests run it on the CPU (SoftbodyModel's XLA path, the
Pallas collision kernel in interpret mode).  Tolerances and their reasons
are stated at each assertion.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import constants as jconst
from spacetime_tpu import relativity as jrel
from spacetime_tpu import scene as jscene
from spacetime_tpu.models.softbody import SoftbodyModel as JModel
from spacetime_tpu.ops import forces as jforces
from spacetime_tpu.ops import forces_pallas as jfp
from spacetime_tpu.ops import grid as jgrid
from spacetime_tpu.ops import rk4 as jrk4
from spacetime_tpu_torch import constants, convert, relativity, scene
from spacetime_tpu_torch.models.softbody import SoftbodyModel, default_bin_resolution
from spacetime_tpu_torch.ops import forces, forces_cuda, grid, rk4

P = constants.DEFAULT_PARAMS
CD, REP = P.collision_distance, P.collision_repulsion_coefficient
# f32 rounding of the same formula evaluated in another order or with
# another sqrt/rsqrt: a few ulps of the O(100-1000) per-bond terms, which
# may cancel in the sum — hence the absolute slack
F32 = dict(rtol=1e-5, atol=1e-4)
# the collision tolerance of tests/test_forces_pallas.py: sums of up to
# ~40 terms of magnitude 100 in another order
COLL = dict(rtol=1e-4, atol=1e-3)


def _fields(x):
    return {f.name: np.asarray(getattr(x, f.name))
            for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _two_discs(mod, radius, gap_x, vel=0.25, lattice_pad=True, capacity=None):
    sb = mod.SceneBuilder()
    sb.add(mod.disc_softbody(radius, 0, (0.35, 0.40), (vel, 0.05), lattice_pad=lattice_pad),
           base_color=(0.25, 0.35, 1.0))
    sb.add(mod.disc_softbody(radius, 1, (0.35 + gap_x, 0.405), (-vel, -0.05),
                             lattice_pad=lattice_pad), base_color=(1.0, 0.3, 0.25))
    return sb.build(capacity)


def _overlapping(rng, lattice_pad=False):
    """tests/test_forces_pallas.py's overlapping two-disc scene, jittered."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.0, 0.0), (0.0, 0.0), lattice_pad=lattice_pad))
    sb.add(jscene.disc_softbody(4, 1, (0.012, 0.007), (0.0, 0.0), lattice_pad=lattice_pad))
    jp, _ = sb.build(capacity=256)
    jitter = rng.uniform(-2e-4, 2e-4, jp.pos.shape).astype(np.float32)
    pos = np.asarray(jp.pos) + jitter * np.asarray(jp.active)[:, None]
    return jp, pos


# --------------------------------------------------------------------------
# constants, relativity, scene, grid
# --------------------------------------------------------------------------


def test_constants_match_jax():
    for f in dataclasses.fields(jconst.PhysicsParams):
        assert getattr(P, f.name) == getattr(jconst.DEFAULT_PARAMS, f.name), f.name
    for name in ("C", "C2", "H", "K", "IMMEDIATE_NEIGHBOR_DIST", "DIAGONAL_NEIGHBOR_DIST",
                 "GRID_RESOLUTION", "COLLISION_DISTANCE", "COLLISION_REPULSION_COEFFICIENT",
                 "BOND_BREAK_THRESHOLD", "MAX_PARTICLES", "MAX_OBJECTS", "MAX_SPEED",
                 "NUM_NEIGHBORS"):
        assert getattr(constants, name) == getattr(jconst, name), name
    np.testing.assert_array_equal(P.rest_lengths(), jconst.DEFAULT_PARAMS.rest_lengths())


def test_relativity_matches_jax(rng):
    vel = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    force = rng.uniform(-50, 50, (64, 2)).astype(np.float32)
    mass = rng.uniform(0.5, 2.0, (64,)).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, 64)
    n_hat = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    t = torch.from_numpy
    pairs = [
        (relativity.gamma_v(t(vel)), jrel.gamma_v(jnp.asarray(vel))),
        (relativity.r_acc(t(force), t(vel), t(mass)),
         jrel.r_acc(jnp.asarray(force), jnp.asarray(vel), jnp.asarray(mass))),
        (relativity.doppler_factor(t(vel), t(n_hat)),
         jrel.doppler_factor(jnp.asarray(vel), jnp.asarray(n_hat))),
        (relativity.camera_doppler_factor(t(vel), t(n_hat)),
         jrel.camera_doppler_factor(jnp.asarray(vel), jnp.asarray(n_hat))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("lattice_pad", [True, False])
def test_scene_arrays_exact(lattice_pad):
    jp, jo = _two_discs(jscene, 5, 0.05, lattice_pad=lattice_pad)
    tp, to = _two_discs(scene, 5, 0.05, lattice_pad=lattice_pad)
    for name, ref in _fields(jp).items():
        np.testing.assert_array_equal(getattr(tp, name).numpy(), ref, err_msg=name)
    for name, ref in _fields(jo).items():
        np.testing.assert_array_equal(getattr(to, name).numpy(), ref, err_msg=name)
    for count in (50, 300, 5000):
        assert scene.radius_for_count(count) == jscene.radius_for_count(count)


def test_cell_ids_exact(rng):
    pos = rng.uniform(0.1, 0.6, (512, 2)).astype(np.float32)
    active = rng.uniform(size=512) < 0.8
    pos[~active] = 1e9
    for res, dim in ((0.002, 1280), (0.005, 64)):
        jc, jo = jgrid.cell_ids(jnp.asarray(pos), jnp.asarray(active), res, dim)
        tc, to = grid.cell_ids(torch.from_numpy(pos), torch.from_numpy(active), res, dim)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_spring_offsets_and_shifted_forces_match_jax(rng):
    jp, _ = _two_discs(jscene, 5, 0.05)
    nbr = np.array(jp.neighbors)
    offs = forces.derive_spring_offsets(nbr)
    assert offs == jforces.derive_spring_offsets(nbr)
    irregular = np.asarray(_two_discs(jscene, 5, 0.05, lattice_pad=False)[0].neighbors)
    assert forces.derive_spring_offsets(irregular, max_offsets=2) is None
    assert forces.derive_spring_offsets(irregular) == jforces.derive_spring_offsets(irregular)
    act = np.array(jp.active)
    # compress the lattice below the collision distance (spacing 0.0035 ->
    # ~0.0019) and jitter it, so springs and bonded repulsion both fire
    jitter = rng.uniform(-3e-4, 3e-4, (nbr.shape[0], 2)).astype(np.float32)
    pos = np.asarray(jp.pos) * np.float32(0.55) + jitter * act[:, None]
    pos[~act] = 1e9
    rest = P.rest_lengths()
    ot = forces.spring_offsets_tensor(offs)
    tx, ty = torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1])
    jx, jy = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    ours = forces.spring_forces_shifted(tx, ty, torch.from_numpy(nbr), ot, torch.from_numpy(rest), P.k)
    ref = jforces.spring_forces_shifted(jx, jy, jnp.asarray(nbr), offs, jnp.asarray(rest), P.k)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy()[act], np.asarray(r)[act], **F32)
    ours = forces.bonded_repulsion_shifted(tx, ty, torch.from_numpy(nbr), ot, CD, REP)
    ref = jforces.bonded_repulsion_shifted(jx, jy, jnp.asarray(nbr), offs, CD, REP)
    assert np.abs(np.asarray(ref[0])).max() > 1.0  # bonded pairs inside cd exist
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy()[act], np.asarray(r)[act], **F32)


# --------------------------------------------------------------------------
# collision forces
# --------------------------------------------------------------------------


def test_collision_plain_matches_oracle(rng):
    """The production dataflow — all pairs in the plain sum, bonded pairs
    subtracted by bonded_repulsion_shifted — vs the O(n^2) oracle that
    excludes self and bonds, in both packages."""
    jp, pos = _overlapping(rng, lattice_pad=True)
    pos = pos * np.float32(0.55)  # bonds compressed inside the collision distance
    n = pos.shape[0]
    nbr = np.array(jp.neighbors)
    tpos, tact, tnbr = torch.from_numpy(pos), torch.from_numpy(np.array(jp.active)), torch.from_numpy(nbr)
    idx = torch.arange(n, dtype=torch.int32)[None, :].expand(n, n)
    valid = tact[None, :].expand(n, n)
    oracle = forces.collision_forces(tpos, idx, valid, tnbr, CD, REP)
    j_oracle = jforces.collision_forces(jnp.asarray(pos), jnp.asarray(idx.numpy()),
                                        jnp.asarray(valid.numpy()), jp.neighbors, CD, REP)
    act = tact.numpy()
    np.testing.assert_allclose(oracle.numpy()[act], np.asarray(j_oracle)[act], **COLL)
    offs = forces.spring_offsets_tensor(forces.derive_spring_offsets(nbr))
    bx, by = forces.bonded_repulsion_shifted(tpos[:, 0], tpos[:, 1], tnbr, offs, CD, REP)
    assert bx.abs().max() > 1.0  # jittered bonds inside cd exist
    ours = forces_cuda.collision_forces_plain(tpos, tact, CD, REP) - torch.stack([bx, by], -1)
    np.testing.assert_allclose(ours.numpy()[act], oracle.numpy()[act], **COLL)
    assert np.abs(oracle.numpy()[act]).max() > 1.0  # the scene collides


@pytest.mark.parametrize("exclude_bonds", [True, False])
def test_collision_plain_matches_jax_kernel_interpret(rng, exclude_bonds):
    """vs forces_pallas.collision_forces_pallas in interpret mode, at the
    test_forces_pallas.py size.  exclude_bonds=False is the production
    variant (bonded pairs kept in the kernel sum)."""
    jp, pos = _overlapping(rng)
    dim = 64
    table = jgrid.build_cell_table(jnp.asarray(pos), jp.active, P.grid_resolution, dim, 12)
    order = jfp.build_sorted_order(table.cell, jp.active, (dim + 2) ** 2, dim + 2,
                                   tile=64, wmax=1024)
    ref = np.asarray(jfp.collision_forces_pallas(
        jnp.asarray(pos), jp.neighbors, order, tile=64, wmax=1024, collision_distance=CD,
        repulsion=REP, exclude_bonds=exclude_bonds, interpret=True))
    tpos, tact = torch.from_numpy(pos), torch.from_numpy(np.array(jp.active))
    ours = forces_cuda.collision_forces_plain(tpos, tact, CD, REP)
    if exclude_bonds:
        n = pos.shape[0]
        idx = torch.arange(n, dtype=torch.int32)[None, :].expand(n, n)
        ours = forces.collision_forces(tpos, idx, tact[None, :].expand(n, n),
                                       torch.from_numpy(np.array(jp.neighbors)), CD, REP)
    act = tact.numpy()
    np.testing.assert_allclose(ours.numpy()[act], ref[act], **COLL)


def _scan_cells(p, order, disp):
    """(x_lo, x_hi, y_lo, y_hi): the cells csrc/collision.cu scans for a
    particle at `p` given the per-axis displacement `disp`, in the kernel's
    f32 arithmetic (cell function of grid.cell_ids, bounds widened by
    kRel = 2^-20 of the magnitudes)."""
    f32 = np.float32
    grid_dim, bres, rel = order.side - 2, f32(order.bin_resolution), f32(2.0 ** -20)
    cell = lambda u: int(np.clip(np.floor(u), 0, grid_dim - 1)) + 1
    out = []
    for axis in (0, 1):
        x, r = f32(p[axis]), f32(CD) + f32(disp[axis])
        o = f32(order.origin[axis].item())
        e = r + (abs(x) + abs(o) + r) * rel
        out += [cell((x - e - o) / bres), cell((x + e - o) / bres)]
    return out


def _kernel_model(pos, active, order, disp):
    """The CUDA kernel's candidate ranges and per-pair sum, in numpy, for
    the CPU tests (the kernel itself runs only on the card)."""
    pos32 = pos.astype(np.float32)
    sidx, scell, start = (order.sorted_idx.numpy(), order.sorted_cell.numpy(),
                          order.cell_start.numpy())
    side = order.side
    out = np.zeros_like(pos32)
    for t in range(pos.shape[0]):
        i = sidx[t]
        if scell[t] >= order.n_cells:
            continue
        x_lo, x_hi, y_lo, y_hi = _scan_cells(pos32[i], order, disp)
        cand = np.concatenate([
            sidx[start[row * side + x_lo]:start[row * side + x_hi + 1]]
            for row in range(y_lo, y_hi + 1)])
        d = pos32[i] - pos32[cand]
        d2 = (d * d).sum(-1)
        hit = (d2 < np.float32(CD * CD)) & (d2 > 0)
        out[i] = ((REP / np.sqrt(d2[hit]))[:, None] * d[hit]).sum(0)
    return out


def _order(pos, act, dim=64):
    bres = default_bin_resolution(P)
    cell, origin = grid.cell_ids(torch.from_numpy(pos), torch.from_numpy(act), bres, dim)
    return forces_cuda.build_cell_order(cell, origin, (dim + 2) ** 2, dim + 2, bres)


def test_cell_order_ranges_cover_all_contacts(rng):
    """build_cell_order + the kernel's range arithmetic find every contact
    the all-pairs sum finds: at the positions the cells were built from
    (disp 0), and after every particle moved by up to disp per axis."""
    jp, pos = _overlapping(rng)
    act = np.array(jp.active)
    order = _order(pos, act)
    assert order.cell_start[-1].item() == act.sum()
    step = rng.uniform(-1.5e-3, 1.5e-3, pos.shape).astype(np.float32) * act[:, None]
    for moved, disp in ((pos, np.zeros(2)), (pos + step, np.abs(step).max(0))):
        plain = forces_cuda.collision_forces_plain(
            torch.from_numpy(moved), torch.from_numpy(act), CD, REP).numpy()
        model = _kernel_model(moved, act, order, disp)
        np.testing.assert_allclose(model[act], plain[act], **COLL)
        assert np.abs(plain[act]).max() > 1.0


@pytest.mark.parametrize("case", ["still", "x_only", "both_axes", "clamped", "parked"])
def test_narrow_scan_covers_every_contact(rng, case):
    """The kernel's per-axis scan (cells within cd + D of the current
    position, clamped as grid.cell_ids clamps) finds every contact: at
    stage 0, after a move along x only (D_y = 0), along both axes, with a
    displacement that clamps the scan to the whole grid, and with a pair
    of particles parked outside the grid's extent (border cells).  Summed
    over the particles it scans about the 3 x 3 cells of the reach-1
    square at stage 0 (a bound landing within the widening of a cell edge
    adds a row or column) and fewer cells than the square of reach
    R = ceil((cd + 2 max D) / bin) it replaced after a move."""
    jp, pos = _overlapping(rng)
    act = np.array(jp.active)
    pos = pos.astype(np.float32)
    ids = np.flatnonzero(act)
    if case == "parked":  # two particles in contact, 0.5 ls past the extent
        pos[ids[0]] = pos[ids[1]] + np.float32([0.5, 0.3])
        pos[ids[2]] = pos[ids[0]] + np.float32([1e-3, 5e-4])
    order = _order(pos, act)
    step = np.zeros_like(pos)
    if case == "x_only":
        step[:, 0] = rng.uniform(-2e-3, 2e-3, pos.shape[0])
    elif case == "both_axes":
        lim = np.array([2e-3, 5e-4])
        step = rng.uniform(-lim, lim, pos.shape).astype(np.float32)
    moved = pos + step * act[:, None]
    disp = np.abs(moved - pos)[act].max(0)
    if case == "clamped":
        disp = np.float32([0.5, 0.5])  # wider than the 64-cell grid
    plain = forces_cuda.collision_forces_plain(
        torch.from_numpy(moved), torch.from_numpy(act), CD, REP).numpy()
    model = _kernel_model(moved, act, order, disp)
    np.testing.assert_allclose(model[act], plain[act], **COLL)
    assert np.abs(plain[act]).max() > 1.0
    if case == "parked":
        assert np.abs(plain[ids[0]]).max() > 1.0  # the parked pair is in contact
    # cells scanned, against the square scan of reach R
    bres = np.float32(order.bin_resolution)
    reach = max(int(np.ceil((np.float32(CD) + 2 * np.float32(disp.max())) / bres)), 1)
    scans = [_scan_cells(moved[i], order, disp) for i in ids]
    cells = [(x_hi - x_lo + 1) * (y_hi - y_lo + 1) for x_lo, x_hi, y_lo, y_hi in scans]
    if case == "clamped":
        assert set(cells) == {(order.side - 2) ** 2}
    elif case == "still":
        assert sum(cells) <= len(ids) * 9.5
    else:
        assert sum(cells) < len(ids) * (2 * reach + 1) ** 2


# --------------------------------------------------------------------------
# RK4 step
# --------------------------------------------------------------------------


def _models(jp):
    offs = jforces.derive_spring_offsets(np.asarray(jp.neighbors))
    return offs, SoftbodyModel(jp.capacity, offs, device="cpu")


def test_physics_step_matches_jax_before_contact():
    """One step of the approaching discs vs the JAX SoftbodyModel on the CPU
    (its XLA cell-table path).  Springs and bonded repulsion only: F32."""
    jp, _ = _two_discs(jscene, 5, 0.05)
    offs, model = _models(jp)
    jm = JModel(capacity=jp.capacity, spring_offsets=offs)
    tp = convert.particles_from_numpy(_fields(jp))
    jp2, jaux = jm.step(jp)
    tp2, taux = model.step(tp)
    assert int(jaux.grid_overflow) == 0
    act = np.array(jp.active)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tp2, f).numpy()[act], np.asarray(getattr(jp2, f))[act],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tp2.neighbors.numpy(), np.asarray(jp2.neighbors))
    assert int(taux.window_truncated) == 0 and int(taux.grid_overflow) == 0
    assert int(taux.bonds_broken) == int(jaux.bonds_broken)


def test_physics_steps_through_impact_match_jax_kernel_path():
    """Six steps through the discs' impact vs the JAX production dataflow
    (SoftbodyModel with the Pallas collision kernel, interpret mode).
    Looser tolerance: collision sums run in another f32 order, and each
    contact term is a constant-magnitude 100 force, so rounding-level
    differences grow through the impact."""
    jp, _ = _two_discs(jscene, 4, 0.0295)
    offs, model = _models(jp)
    jm = JModel(capacity=jp.capacity, spring_offsets=offs, use_pallas=True,
                pallas_interpret=True, tile=128)
    tp = convert.particles_from_numpy(_fields(jp))
    act = np.array(jp.active)
    v0 = np.asarray(jp.vel)[act].copy()
    for _ in range(6):
        jp, jaux = jm.step(jp)
        tp, taux = model.step(tp)
        assert int(jaux.window_truncated) == 0 and int(taux.window_truncated) == 0
    np.testing.assert_allclose(tp.pos.numpy()[act], np.asarray(jp.pos)[act], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.vel.numpy()[act], np.asarray(jp.vel)[act], rtol=0, atol=1e-3)
    # the impact really happened: velocities changed by more than springs alone
    assert np.abs(np.asarray(jp.vel)[act] - v0).max() > 0.1


def test_break_bonds_shifted_on_stretched_bond():
    jp, _ = _two_discs(jscene, 3, 0.05)
    nbr = np.array(jp.neighbors)
    offs = jforces.derive_spring_offsets(nbr)
    pos = np.asarray(jp.pos).copy()
    i = int(np.flatnonzero(np.asarray(jp.active) & (nbr[:, 2] >= 0))[0])
    pos[i, 0] -= 0.02  # stretch bond slot 2 (right) and its reciprocal
    ours, n_ours = rk4.break_bonds_shifted(
        torch.from_numpy(pos), torch.from_numpy(nbr), forces.spring_offsets_tensor(offs),
        P.bond_break_threshold)
    ref, n_ref = jrk4.break_bonds_shifted(jnp.asarray(pos), jnp.asarray(nbr), offs,
                                          P.bond_break_threshold)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert int(n_ours) == int(n_ref) > 0
    assert ours[i, 2] == -1 and ours[nbr[i, 2], 0] == -1  # symmetric


def test_step_n_matches_repeated_step():
    tp, _ = _two_discs(scene, 3, 0.05)
    _, model = _models(tp)
    a, _ = model.step_n(tp, 3)
    b = tp
    for _ in range(3):
        b, _ = model.step(b)
    torch.testing.assert_close(a.pos, b.pos, rtol=0, atol=0)


def test_package_imports_without_jax():
    """The port must import and step with jax made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['spacetime_tpu'] = None\n"
        "from spacetime_tpu_torch import scene, convert, kernels\n"
        "from spacetime_tpu_torch.models.softbody import SoftbodyModel\n"
        "from spacetime_tpu_torch.ops import forces, raytrace, render_cuda, worldline\n"
        "from spacetime_tpu_torch.ops import band_cuda, points_cuda, rasterize\n"
        "from spacetime_tpu_torch.ops import boost, materials\n"
        "from spacetime_tpu_torch import cli, compare_kernels, device, engine, headline\n"
        "from spacetime_tpu_torch.utils import timing\n"
        "sb = scene.SceneBuilder(); sb.add(scene.disc_softbody(3, 0, (0, 0), (0.1, 0), True))\n"
        "p, o = sb.build()\n"
        "m = SoftbodyModel(p.capacity, forces.derive_spring_offsets(p.neighbors.numpy()),\n"
        "                  device='cpu')\n"
        "p, aux = m.step(p)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k])\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
