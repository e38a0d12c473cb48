"""Parity of the port's materials, plastic creep and row-gather physics
(spacetime_tpu_torch.ops.{materials,forces,rk4}, the collision kernel's
bond-excluding variant) with the JAX reference, on the CPU at small sizes.

Inputs come from numpy seeds and go through both packages; the JAX side
runs as its own tests run it on the CPU (its XLA path, and the Pallas
collision kernel in interpret mode).  Through an impact the port is held
to the Pallas path: the JAX XLA path misses contacts that form during a
step (ROADMAP.md queue 3).  Tolerances and their reasons are stated at
each assertion.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spacetime_tpu import scene as jscene
from spacetime_tpu.ops import forces as jforces
from spacetime_tpu.ops import forces_pallas as jfp
from spacetime_tpu.ops import grid as jgrid
from spacetime_tpu.ops import materials as jmat
from spacetime_tpu.ops import rk4 as jrk4
from spacetime_tpu.state import with_rest_len as jwith_rest_len
from spacetime_tpu_torch import constants, convert, scene
from spacetime_tpu_torch.models.softbody import SoftbodyModel, default_bin_resolution
from spacetime_tpu_torch.ops import forces, forces_cuda, grid, materials, rk4
from spacetime_tpu_torch.state import with_rest_len
from spacetime_tpu_torch.utils import config

P = constants.DEFAULT_PARAMS
CD, REP = P.collision_distance, P.collision_repulsion_coefficient
# the same f32 formula in the same order, summed slot by slot on both sides;
# atol only absorbs bonds whose terms cancel to ~0
EXACTISH = dict(rtol=1e-6, atol=1e-6)
# the collision tolerance of tests/test_forces_pallas.py: sums of up to ~40
# terms of magnitude 100 in another order
COLL = dict(rtol=1e-5, atol=1e-4)
# a step or a few through contact: positions to 1e-5 ls, velocities to
# 1e-4 c (contact terms of magnitude 100 summed in another f32 order)
STEP_POS, STEP_VEL = 1e-5, 1e-4
PLASTIC = config.config_plastic_collision().materials


def _fields(x):
    return {f: np.asarray(getattr(x, f)) for f in x._fields if getattr(x, f) is not None} \
        if hasattr(x, "_fields") else \
        {f.name: np.asarray(getattr(x, f.name))
         for f in dataclasses.fields(x) if getattr(x, f.name) is not None}


def _two_discs(radius, gap, vel, lattice_pad, capacity=512):
    """Two discs, materials 0 and 1, approaching along x (JAX package)."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(radius, 0, (0.35, 0.40), (vel, 0.01), lattice_pad=lattice_pad),
           material_index=0)
    sb.add(jscene.disc_softbody(radius, 1, (0.35 + gap, 0.403), (-vel, -0.01),
                                lattice_pad=lattice_pad), material_index=1)
    return sb.build(capacity=capacity)


def _both_materials(table, jp, jo):
    jm = jmat.particle_materials(table, jo.material_index, jp.object_index)
    tm = materials.particle_materials(table, torch.from_numpy(np.array(jo.material_index)),
                                      torch.from_numpy(np.array(jp.object_index)))
    return jm, tm


def _loaded(jp, rng, scale=1.02, jitter=3e-4):
    """Positions stretched and jittered so springs, damping and creep load."""
    act = np.asarray(jp.active)
    pos = np.asarray(jp.pos).copy()
    c = pos[act].mean(0)
    pos[act] = c + (pos[act] - c) * np.float32(scale)
    pos[act] += rng.uniform(-jitter, jitter, (act.sum(), 2)).astype(np.float32)
    vel = rng.uniform(-0.05, 0.05, pos.shape).astype(np.float32) * act[:, None]
    return pos, vel, act


# --------------------------------------------------------------------------
# ops/materials
# --------------------------------------------------------------------------


@pytest.mark.parametrize("table", [
    PLASTIC,
    ((0.5, 0.0, 1.0), (1.0, 0.0, 1.0)),  # stiffness only
    ((1.0, 0.0, 0.7), (1.0, 3.0, 1.0)),  # break scale and damping
    ((1.0, 0.0, 1.0, 5.0, 0.0), (1.0, 0.0, 1.0)),  # creep from zero strain
    ((1.0, 0.0, 1.0), (1.0, 0.0, 1.0, 0.0, 0.3)),  # all default: None
])
def test_particle_materials_match_jax(table):
    """Every plane equal to the JAX package's, and the same None rules (an
    all-default table, an all-default column)."""
    jp, jo = _two_discs(4, 0.05, 0.05, True)
    jm, tm = _both_materials(table, jp, jo)
    assert (jm is None) == (tm is None)
    if jm is None:
        return
    for name in jmat.ParticleMaterials._fields:
        a, b = getattr(tm, name), getattr(jm, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if table is PLASTIC:
        assert tm.k_scale is None and tm.break_scale is None
        assert tm.creep_rate is not None and tm.yield_strain is not None


def test_materials_convert_from_jax():
    jp, jo = _two_discs(4, 0.05, 0.05, True)
    jm, tm = _both_materials(PLASTIC, jp, jo)
    conv = convert.materials_from_numpy(_fields(jm))
    for name in materials.ParticleMaterials._fields:
        a, b = getattr(conv, name), getattr(tm, name)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), name


# --------------------------------------------------------------------------
# ops/forces with materials: shifted and rows
# --------------------------------------------------------------------------


@pytest.mark.parametrize("what", ["springs_k_pp", "damping", "creep"])
def test_shifted_material_forces_match_jax(rng, what):
    jp, jo = _two_discs(5, 0.05, 0.05, True)
    table = ((0.6, 25.0, 1.0, 25.0, 0.01), (1.3, 10.0, 1.0, 4.0, 0.0))
    jm, tm = _both_materials(table, jp, jo)
    nbr = np.array(jp.neighbors)
    offs = jforces.derive_spring_offsets(nbr)
    ot = forces.spring_offsets_tensor(offs)
    pos, vel, act = _loaded(jp, rng)
    tx, ty = torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1])
    jx, jy = jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])
    tn, jn = torch.from_numpy(nbr), jnp.asarray(nbr)
    rest = P.rest_lengths()
    if what == "springs_k_pp":
        ours = forces.spring_forces_shifted(tx, ty, tn, ot, torch.from_numpy(rest), P.k,
                                            k_pp=tm.k_scale)
        ref = jforces.spring_forces_shifted(jx, jy, jn, offs, jnp.asarray(rest), P.k,
                                            k_pp=jm.k_scale)
    elif what == "damping":
        ours = forces.bond_damping_shifted(tx, ty, torch.from_numpy(vel[:, 0]),
                                           torch.from_numpy(vel[:, 1]), tn, ot, tm.damping)
        ref = jforces.bond_damping_shifted(jx, jy, jnp.asarray(vel[:, 0]),
                                           jnp.asarray(vel[:, 1]), jn, offs, jm.damping)
    else:
        rl = np.tile(rest, (nbr.shape[0], 1)).astype(np.float32)
        ours = (forces.creep_rest_lengths_shifted(tx, ty, tn, ot, torch.from_numpy(rl),
                                                  tm.creep_rate, tm.yield_strain, P.h),)
        ref = (jforces.creep_rest_lengths_shifted(jx, jy, jn, offs, jnp.asarray(rl),
                                                  jm.creep_rate, jm.yield_strain, P.h),)
        assert (np.asarray(ref[0]) > rl + 1e-7).any()  # some bonds crept
    for o, r in zip(ours, ref):
        assert np.abs(np.asarray(r)[act]).max() > 0.0
        np.testing.assert_allclose(o.numpy()[act], np.asarray(r)[act], **EXACTISH)


@pytest.mark.parametrize("mats", ["none", "k_pp", "k_pp_c_pp"])
def test_spring_forces_rows_match_jax(rng, mats):
    """On an unpadded (irregular) scene, with per-bond rest lengths."""
    jp, jo = _two_discs(5, 0.05, 0.05, False)
    jm, tm = _both_materials(((0.6, 25.0, 1.0), (1.3, 10.0, 1.0)), jp, jo)
    nbr = np.array(jp.neighbors)
    pos, vel, act = _loaded(jp, rng)
    rl = (np.tile(P.rest_lengths(), (nbr.shape[0], 1))
          * rng.uniform(0.95, 1.05, nbr.shape)).astype(np.float32)
    kw_t, kw_j = {}, {}
    if mats != "none":
        kw_t["k_pp"], kw_j["k_pp"] = tm.k_scale, jm.k_scale
    if mats == "k_pp_c_pp":
        kw_t.update(c_pp=tm.damping, vx=torch.from_numpy(vel[:, 0]),
                    vy=torch.from_numpy(vel[:, 1]))
        kw_j.update(c_pp=jm.damping, vx=jnp.asarray(vel[:, 0]), vy=jnp.asarray(vel[:, 1]))
    ours = forces.spring_forces_rows(torch.from_numpy(pos[:, 0]), torch.from_numpy(pos[:, 1]),
                                     torch.from_numpy(nbr), torch.from_numpy(rl), P.k, **kw_t)
    ref = jforces.spring_forces_rows(jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
                                     jnp.asarray(nbr), jnp.asarray(rl), P.k, **kw_j)
    for o, r in zip(ours, ref):
        assert np.abs(np.asarray(r)[act]).max() > 1.0
        np.testing.assert_allclose(o.numpy()[act], np.asarray(r)[act], **EXACTISH)


@pytest.mark.parametrize("yield_strain", [True, False])
def test_creep_rest_lengths_rows_match_jax(rng, yield_strain):
    jp, jo = _two_discs(5, 0.05, 0.05, False)
    table = ((1.0, 0.0, 1.0, 25.0, 0.01 if yield_strain else 0.0), (1.0, 0.0, 1.0, 3.0, 0.0))
    jm, tm = _both_materials(table, jp, jo)
    assert (tm.yield_strain is not None) == yield_strain
    nbr = np.array(jp.neighbors)
    pos, _, act = _loaded(jp, rng)
    rl = np.tile(P.rest_lengths(), (nbr.shape[0], 1)).astype(np.float32)
    ours = forces.creep_rest_lengths_rows(torch.from_numpy(pos), torch.from_numpy(nbr),
                                          torch.from_numpy(rl), tm.creep_rate,
                                          tm.yield_strain, P.h)
    ref = np.asarray(jforces.creep_rest_lengths_rows(jnp.asarray(pos), jnp.asarray(nbr),
                                                     jnp.asarray(rl), jm.creep_rate,
                                                     jm.yield_strain, P.h))
    assert (ref[act] > rl[act] + 1e-7).any()
    np.testing.assert_allclose(ours.numpy()[act], ref[act], **EXACTISH)


def test_rows_equal_shifted_on_padded_disc(rng):
    """On a lattice-padded scene every valid slot is a shifted bond, so the
    row-gather forces, damping, creep and bond breaking equal the shifted
    ones exactly (both sum slot by slot); the JAX row path agrees at the
    tolerance of tests/test_spring_shifted.py (its sum runs in another
    order, and k = 15000 terms cancel)."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(5, 0, (0.0, 0.0), (0.05, 0.0), lattice_pad=True))
    sb.add(jscene.disc_softbody(4, 1, (0.06, 0.01), (-0.05, 0.0), lattice_pad=True),
           material_index=1)
    jp, jo = sb.build(capacity=512)
    jm, tm = _both_materials(((0.7, 5.0, 0.8, 9.0, 0.02), (1.2, 1.0, 1.0)), jp, jo)
    nbr = np.array(jp.neighbors)
    ot = forces.spring_offsets_tensor(forces.derive_spring_offsets(nbr))
    pos, vel, act = _loaded(jp, rng)
    tp = torch.from_numpy(pos)
    px, py, vx, vy = (torch.from_numpy(a) for a in (pos[:, 0], pos[:, 1], vel[:, 0], vel[:, 1]))
    tn = torch.from_numpy(nbr)
    rest = torch.from_numpy(P.rest_lengths())
    rows = forces.spring_forces_rows(px, py, tn, rest, P.k, k_pp=tm.k_scale, c_pp=tm.damping,
                                     vx=vx, vy=vy)
    sfx, sfy = forces.spring_forces_shifted(px, py, tn, ot, rest, P.k, k_pp=tm.k_scale)
    dfx, dfy = forces.bond_damping_shifted(px, py, vx, vy, tn, ot, tm.damping)
    assert rows[0].abs().max() > 1.0
    for a, b in zip(rows, (sfx + dfx, sfy + dfy)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-4)
    rl = rest[None, :].expand(nbr.shape[0], 8).contiguous()
    torch.testing.assert_close(
        forces.creep_rest_lengths_rows(tp, tn, rl, tm.creep_rate, tm.yield_strain, P.h),
        forces.creep_rest_lengths_shifted(px, py, tn, ot, rl, tm.creep_rate, tm.yield_strain,
                                          P.h), rtol=0, atol=0)
    stretched = pos.copy()
    i = int(np.flatnonzero(act & (nbr[:, 2] >= 0))[3])
    stretched[nbr[i, 2]] = stretched[i] + np.float32([0.02, 0.0])
    ts = torch.from_numpy(stretched)
    g = rk4.break_bonds(ts, tn, P.bond_break_threshold, tm.break_scale)
    s = rk4.break_bonds_shifted(ts, tn, ot, P.bond_break_threshold, tm.break_scale)
    assert int(g[1]) == int(s[1]) > 0 and torch.equal(g[0], s[0])
    jr = jforces.spring_forces_rows(jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1]),
                                    jnp.asarray(nbr), jnp.asarray(rest.numpy()), P.k)
    ours = forces.spring_forces_rows(px, py, tn, rest, P.k)
    for o, r in zip(ours, jr):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-2)


@pytest.mark.parametrize("rows", [True, False])
def test_break_bonds_with_break_scale_match_jax(rows):
    """A bond stretched to 93% of the threshold breaks where one endpoint's
    material scales the threshold below that: symmetric, pairwise min."""
    jp, jo = _two_discs(4, 0.05, 0.05, not rows)
    jm, tm = _both_materials(((1.0, 0.0, 1.0), (1.0, 0.0, 0.8)), jp, jo)
    nbr = np.array(jp.neighbors)
    pos = np.asarray(jp.pos).copy()
    obj = np.asarray(jp.object_index)
    act = np.asarray(jp.active)
    for o in (0, 1):  # one right-bond stretched in each body
        i = int(np.flatnonzero(act & (obj == o) & (nbr[:, 2] >= 0))[2])
        pos[nbr[i, 2]] = pos[i] + np.float32([0.93 * P.bond_break_threshold, 0.0])
    tpos, tnbr = torch.from_numpy(pos), torch.from_numpy(nbr)
    if rows:
        ours = rk4.break_bonds(tpos, tnbr, P.bond_break_threshold, tm.break_scale)
        ref = jrk4.break_bonds(jnp.asarray(pos), jnp.asarray(nbr), P.bond_break_threshold,
                               jm.break_scale)
    else:
        offs = jforces.derive_spring_offsets(nbr)
        ours = rk4.break_bonds_shifted(tpos, tnbr, forces.spring_offsets_tensor(offs),
                                       P.bond_break_threshold, tm.break_scale)
        ref = jrk4.break_bonds_shifted(jnp.asarray(pos), jnp.asarray(nbr), offs,
                                       P.bond_break_threshold, jm.break_scale)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    assert int(ours[1]) == int(ref[1]) > 0
    broken = (ours[0].numpy() == -1) & (nbr >= 0)
    assert set(obj[np.flatnonzero(broken.any(1))]) == {1}  # only the weak body's bond


# --------------------------------------------------------------------------
# the collision kernel's bond-excluding variant
# --------------------------------------------------------------------------


def _unpadded_contact(rng):
    """tests/test_forces_pallas.py's overlapping two-disc scene, unpadded,
    jittered."""
    sb = jscene.SceneBuilder()
    sb.add(jscene.disc_softbody(4, 0, (0.0, 0.0), (0.0, 0.0)))
    sb.add(jscene.disc_softbody(4, 1, (0.012, 0.007), (0.0, 0.0)))
    jp, _ = sb.build(capacity=256)
    jitter = rng.uniform(-2e-4, 2e-4, jp.pos.shape).astype(np.float32)
    pos = np.asarray(jp.pos) * np.float32(0.55) + jitter * np.asarray(jp.active)[:, None]
    return jp, pos


def test_collision_exclude_plain_matches_jax_kernel_interpret(rng):
    """The exclude variant's plain version vs collision_forces_pallas(...,
    exclude_bonds=True) in interpret mode, on a compressed unpadded scene in
    contact where bonded pairs lie inside the collision distance."""
    jp, pos = _unpadded_contact(rng)
    dim = 64
    table = jgrid.build_cell_table(jnp.asarray(pos), jp.active, P.grid_resolution, dim, 24)
    order = jfp.build_sorted_order(table.cell, jp.active, (dim + 2) ** 2, dim + 2,
                                   tile=64, wmax=2048)
    ref = np.asarray(jfp.collision_forces_pallas(
        jnp.asarray(pos), jp.neighbors, order, tile=64, wmax=2048, collision_distance=CD,
        repulsion=REP, exclude_bonds=True, interpret=True))
    tpos, tact = torch.from_numpy(pos), torch.from_numpy(np.array(jp.active))
    tnbr = torch.from_numpy(np.array(jp.neighbors))
    ours = forces_cuda.collision_forces_plain(tpos, tact, CD, REP, tnbr)
    act = tact.numpy()
    np.testing.assert_allclose(ours.numpy()[act], ref[act], **COLL)
    # bonded pairs inside cd exist, so excluding them matters
    incl = forces_cuda.collision_forces_plain(tpos, tact, CD, REP)
    assert (incl - ours)[tact].abs().max() > 1.0 and np.abs(ref[act]).max() > 1.0


def _exclude_kernel_model(pos, nbr, order, disp):
    """The exclude kernel's candidate ranges (cells within cd + D of the
    current position per axis, widened by kRel = 2^-20 of the magnitudes,
    clamped as grid.cell_ids clamps), distance test, then id tests, and
    per-pair sum in numpy (the kernel itself runs only on the card)."""
    f32 = np.float32
    sidx, scell, start = (order.sorted_idx.numpy(), order.sorted_cell.numpy(),
                          order.cell_start.numpy())
    side, bres, rel = order.side, f32(order.bin_resolution), f32(2.0 ** -20)
    cell = lambda u: int(np.clip(np.floor(u), 0, side - 3)) + 1
    out = np.zeros_like(pos)
    for t in range(pos.shape[0]):
        i = sidx[t]
        if scell[t] >= order.n_cells:
            continue
        lim = []
        for axis in (0, 1):
            x, r, o = pos[i, axis], f32(CD) + f32(disp[axis]), f32(order.origin[axis].item())
            e = r + (abs(x) + abs(o) + r) * rel
            lim += [cell((x - e - o) / bres), cell((x + e - o) / bres)]
        x_lo, x_hi, y_lo, y_hi = lim
        cand = np.concatenate([
            sidx[start[row * side + x_lo]:start[row * side + x_hi + 1]]
            for row in range(y_lo, y_hi + 1)])
        d = pos[i] - pos[cand]
        d2 = (d * d).sum(-1)
        hit = (d2 < np.float32(CD * CD)) & (d2 > 0)
        hit &= (cand != i) & ~np.isin(cand, nbr[i])
        out[i] = ((REP / np.sqrt(d2[hit]))[:, None] * d[hit]).sum(0)
    return out


def test_exclude_kernel_ranges_match_plain(rng):
    """build_cell_order + the exclude kernel's range and id arithmetic give
    the plain exclude sum, at the cells' own positions and after a move."""
    jp, pos = _unpadded_contact(rng)
    act = np.array(jp.active)
    nbr = np.array(jp.neighbors)
    bres = default_bin_resolution(P)
    cell, origin = grid.cell_ids(torch.from_numpy(pos), torch.from_numpy(act), bres, 64)
    order = forces_cuda.build_cell_order(cell, origin, 66 ** 2, 66, bres)
    step = rng.uniform(-1.5e-3, 1.5e-3, pos.shape).astype(np.float32) * act[:, None]
    for moved, disp in ((pos, np.zeros(2)), (pos + step, np.abs(step).max(0))):
        plain = forces_cuda.collision_forces_plain(
            torch.from_numpy(moved), torch.from_numpy(act), CD, REP,
            torch.from_numpy(nbr)).numpy()
        model = _exclude_kernel_model(moved, nbr, order, disp)
        np.testing.assert_allclose(model[act], plain[act], **COLL)
        assert np.abs(plain[act]).max() > 1.0


# --------------------------------------------------------------------------
# physics_step: the row branch, materials, creep
# --------------------------------------------------------------------------


def _jax_step(jp, offs, pallas, materials=None):
    return jrk4.physics_step(
        jp, P, jnp.asarray(P.rest_lengths()), 512, 8, "rk4", use_pallas=pallas,
        spring_offsets=offs, pallas_interpret=pallas, tile=128, materials=materials,
        bin_resolution=default_bin_resolution(P))


def test_physics_step_rows_matches_jax_before_contact():
    """One row-branch step of approaching discs vs the JAX XLA path (no
    contact: springs only)."""
    jp, _ = _two_discs(5, 0.05, 0.25, False)
    tp = convert.particles_from_numpy(_fields(jp))
    jp2, jaux = _jax_step(jp, None, pallas=False)
    tp2, taux = SoftbodyModel(jp.capacity, None, device="cpu").step(tp)
    assert int(jaux.grid_overflow) == 0
    act = np.asarray(jp.active)
    for f in ("pos", "vel"):
        np.testing.assert_allclose(getattr(tp2, f).numpy()[act], np.asarray(getattr(jp2, f))[act],
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tp2.neighbors.numpy(), np.asarray(jp2.neighbors))
    assert int(taux.bonds_broken) == int(jaux.bonds_broken)


def test_physics_step_rows_through_contact_matches_jax_kernel_path():
    """Five row-branch steps through the discs' impact vs the JAX step with
    the Pallas collision kernel's exclude variant (interpret mode)."""
    jp, _ = _two_discs(4, 0.0295, 0.25, False, capacity=256)
    tp = convert.particles_from_numpy(_fields(jp))
    model = SoftbodyModel(jp.capacity, None, device="cpu")
    act = np.asarray(jp.active)
    v0 = np.asarray(jp.vel)[act].copy()
    for _ in range(5):
        jp, jaux = _jax_step(jp, None, pallas=True)
        tp, taux = model.step(tp)
        assert int(jaux.window_truncated) == 0
        assert int(taux.bonds_broken) == int(jaux.bonds_broken)
    np.testing.assert_allclose(tp.pos.numpy()[act], np.asarray(jp.pos)[act], rtol=0,
                               atol=STEP_POS)
    np.testing.assert_allclose(tp.vel.numpy()[act], np.asarray(jp.vel)[act], rtol=0,
                               atol=STEP_VEL)
    np.testing.assert_array_equal(tp.neighbors.numpy(), np.asarray(jp.neighbors))
    assert np.abs(np.asarray(jp.vel)[act] - v0).max() > 0.1  # the impact happened


@pytest.mark.parametrize("lattice_pad", [True, False])
def test_plastic_materials_through_contact_match_jax(lattice_pad):
    """plastic_collision's material table on small discs at its closing
    speed (0.12c each), through their impact: positions, velocities and
    rest lengths as the JAX step with the Pallas kernel (interpret mode)
    gives them, the same bonds broken, and the creeping blue body's rest
    lengths grew while the red body's did not.  (At 0.25c each the strong
    damping amplifies f32 rounding ~10x a step through the contact, in
    either package.)"""
    jp, jo = _two_discs(4, 0.0295, 0.12, lattice_pad, capacity=256)
    jm, tm = _both_materials(PLASTIC, jp, jo)
    jp = jwith_rest_len(jp, P.rest_lengths())
    tp = convert.particles_from_numpy(_fields(jp))
    offs = forces.derive_spring_offsets(np.asarray(jp.neighbors)) if lattice_pad else None
    model = SoftbodyModel(jp.capacity, offs, device="cpu")
    act = np.asarray(jp.active)
    for _ in range(8):
        jp, jaux = _jax_step(jp, offs, pallas=True, materials=jm)
        tp, taux = model.step(tp, tm)
        assert int(taux.bonds_broken) == int(jaux.bonds_broken)
    np.testing.assert_allclose(tp.pos.numpy()[act], np.asarray(jp.pos)[act], rtol=0,
                               atol=STEP_POS)
    np.testing.assert_allclose(tp.vel.numpy()[act], np.asarray(jp.vel)[act], rtol=0,
                               atol=STEP_VEL)
    np.testing.assert_allclose(tp.rest_len.numpy()[act], np.asarray(jp.rest_len)[act],
                               rtol=1e-6, atol=1e-9)
    rest = P.rest_lengths()
    obj = np.asarray(jp.object_index)
    grown = tp.rest_len.numpy() - rest[None, :]
    assert grown[act & (obj == 0)].max() > 1e-7  # blue creeps
    np.testing.assert_array_equal(grown[act & (obj == 1)], 0.0)  # red does not


def test_creep_without_rest_len_warns_and_does_not_creep(caplog):
    jp, jo = _two_discs(4, 0.0295, 0.25, True, capacity=256)
    _, tm = _both_materials(PLASTIC, jp, jo)
    tp = convert.particles_from_numpy(_fields(jp))
    model = SoftbodyModel(jp.capacity, forces.derive_spring_offsets(np.asarray(jp.neighbors)),
                          device="cpu")
    logger = logging.getLogger("spacetime_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        tp2, _ = model.step(tp, tm)
    finally:
        logger.removeHandler(caplog.handler)
    assert tp2.rest_len is None
    assert any("plastic creep is DISABLED" in r.getMessage() for r in caplog.records)


def test_step_n_with_materials_matches_repeated_step():
    sb = scene.SceneBuilder()
    sb.add(scene.disc_softbody(4, 0, (0.35, 0.40), (0.25, 0.0)), material_index=0)
    sb.add(scene.disc_softbody(4, 1, (0.38, 0.40), (-0.25, 0.0)), material_index=1)
    tp, to = sb.build(device="cpu")
    tm = materials.particle_materials(PLASTIC, to.material_index, tp.object_index)
    tp = with_rest_len(tp, P.rest_lengths())
    model = SoftbodyModel(tp.capacity, None, device="cpu")
    a, _ = model.step_n(tp, 3, tm)
    b = tp
    for _ in range(3):
        b, _ = model.step(b, tm)
    assert torch.equal(a.pos, b.pos) and torch.equal(a.rest_len, b.rest_len)
