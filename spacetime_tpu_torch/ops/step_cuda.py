"""Launchers of the RK4 step's per-particle kernels (`csrc/step.cu`).

`ops/rk4.py`'s `bond_stage` and `step_finish` call these for CUDA tensors
(their plain versions, in rk4.py, run for CPU tensors).  Each checks what
the kernel reads, allocates what it writes and launches on the current
stream; a launch error raises.  The kernels replace no TPU kernel: the JAX
step is a plain jnp chain (see csrc/step.cu).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..constants import C2


def _ptr(t):
    return None if t is None else t.data_ptr()


def _need(t, name, shape, dtype, device, aligned=False):
    """Raise unless `t` is a contiguous tensor of `shape` and `dtype` on
    `device` (16-byte aligned where the kernel loads it by 16 bytes)."""
    if (not isinstance(t, torch.Tensor) or t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        got = (tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} {dtype} tensor on "
                         f"{device}, got {got}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _f32(x: float) -> float:
    """The float32 a Python scalar takes in a torch op on f32 tensors."""
    return float(np.float32(x))


def _planes_args(planes, n: int, b: int, dev) -> kernels.BondStageArgs:
    """BondStageArgs holding the step's fixed planes, checked."""
    _need(planes.gpos0, "gpos0", (n, 2), torch.float32, dev)
    _need(planes.vel0, "vel0", (b, 2), torch.float32, dev)
    _need(planes.rest_mass, "rest_mass", (b,), torch.float32, dev)
    _need(planes.active, "active", (b,), torch.bool, dev)
    _need(planes.neighbors, "neighbors", (b, 8), torch.int32, dev, aligned=True)
    if planes.offsets is not None:
        width = planes.offsets.shape[-1] if planes.offsets.dim() == 2 else 0
        if not 1 <= width <= 8:
            raise ValueError(f"offsets must be an (8, D) table with 1 <= D <= 8, got "
                             f"{tuple(planes.offsets.shape)}")
        _need(planes.offsets, "offsets", (8, width), torch.int32, dev)
    per_bond = planes.rest.dim() == 2
    _need(planes.rest, "rest", (b, 8) if per_bond else (8,), torch.float32, dev)
    for name in ("k_pp", "c_pp", "break_scale", "creep_rate", "yield_strain"):
        if getattr(planes, name) is not None:
            _need(getattr(planes, name), name, (n,), torch.float32, dev)
    if planes.c_pp is not None:
        _need(planes.gvel0, "gvel0", (n, 2), torch.float32, dev)
    if planes.creep_rate is not None and not per_bond:
        raise ValueError("creep needs per-bond (B, 8) rest lengths")
    if not 0 <= planes.row0 <= n - b:
        raise ValueError(f"rows [{planes.row0}, {planes.row0 + b}) outside [0, {n})")
    return kernels.BondStageArgs(
        pos0=planes.gpos0.data_ptr(), vel0=planes.vel0.data_ptr(),
        gvel0=_ptr(planes.gvel0 if planes.c_pp is not None else None),
        mass=planes.rest_mass.data_ptr(), active=planes.active.data_ptr(),
        nbr=planes.neighbors.data_ptr(), offsets=_ptr(planes.offsets),
        rest=planes.rest.data_ptr(), k_pp=_ptr(planes.k_pp), c_pp=_ptr(planes.c_pp),
        break_scale=_ptr(planes.break_scale), creep_rate=_ptr(planes.creep_rate),
        yield_strain=_ptr(planes.yield_strain),
        n=n, rows=b, row0=planes.row0,
        width=0 if planes.offsets is None else planes.offsets.shape[1],
        rest_stride=8 if per_bond else 0)


def bond_stage_launch(planes, params, gpos, coll, facc, weight, h_adv, disp, broken):
    """rk4.bond_stage on the card: one launch of bond_stage_kernel.
    Returns rk4.bond_stage's (facc, next_pos, neighbors, rest_len)."""
    dev = gpos.device
    n, b = gpos.shape[0], planes.neighbors.shape[0]
    args = _planes_args(planes, n, b, dev)
    _need(gpos, "gpos", (n, 2), torch.float32, dev)
    _need(coll, "coll", (b, 2), torch.float32, dev)
    if weight not in (0, 1, 2):
        raise ValueError(f"weight must be 0, 1 or 2, got {weight}")
    if weight:
        _need(facc, "facc", (b, 2), torch.float32, dev)
    if disp is not None:
        if h_adv is None:
            raise ValueError("disp needs next positions (h_adv)")
        _need(disp, "disp", (2,), torch.float32, dev)
    facc_out = torch.empty((b, 2), dtype=torch.float32, device=dev)
    nxt = None if h_adv is None else torch.empty((b, 2), dtype=torch.float32, device=dev)
    nbr_out = rest_out = None
    if broken is not None:
        _need(broken, "broken", (), torch.int32, dev)
        if gpos.data_ptr() != planes.gpos0.data_ptr():
            # the kernel breaks bonds at the distances it computes at gpos
            raise ValueError("bond breaking reads the start positions: gpos must be gpos0")
        nbr_out = torch.empty((b, 8), dtype=torch.int32, device=dev)
        if planes.creep_rate is not None:
            rest_out = torch.empty((b, 8), dtype=torch.float32, device=dev)
    args.pos, args.coll, args.facc_in = gpos.data_ptr(), coll.data_ptr(), _ptr(
        facc if weight else None)
    args.facc_out, args.next, args.disp = facc_out.data_ptr(), _ptr(nxt), _ptr(disp)
    args.nbr_out, args.broken, args.rest_out = _ptr(nbr_out), _ptr(broken), _ptr(rest_out)
    args.weight = weight
    args.k, args.k_half = _f32(params.k), _f32(params.k * 0.5)
    args.cd2 = _f32(params.collision_distance * params.collision_distance)
    args.repulsion = _f32(params.collision_repulsion_coefficient)
    args.h_adv = _f32(0.0 if h_adv is None else h_adv)
    args.c2, args.threshold, args.h = _f32(C2), _f32(params.bond_break_threshold), _f32(params.h)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(kernels.library().bond_stage_launch(ctypes.byref(args), stream), "bond_stage")
    kernels.launches["bond_stage"] += 1
    return facc_out, nxt, nbr_out, rest_out


def step_finish_launch(planes, params, facc, euler: bool):
    """rk4.step_finish on the card: one launch of step_finish_kernel.
    Returns the block's (pos, vel)."""
    dev = facc.device
    n, b = planes.gpos0.shape[0], planes.vel0.shape[0]
    _need(facc, "facc", (b, 2), torch.float32, dev)
    _need(planes.gpos0, "gpos0", (n, 2), torch.float32, dev)
    _need(planes.vel0, "vel0", (b, 2), torch.float32, dev)
    _need(planes.rest_mass, "rest_mass", (b,), torch.float32, dev)
    _need(planes.active, "active", (b,), torch.bool, dev)
    if not 0 <= planes.row0 <= n - b:
        raise ValueError(f"rows [{planes.row0}, {planes.row0 + b}) outside [0, {n})")
    pos = torch.empty((b, 2), dtype=torch.float32, device=dev)
    vel = torch.empty((b, 2), dtype=torch.float32, device=dev)
    args = kernels.StepFinishArgs(
        facc=facc.data_ptr(), pos0=planes.gpos0.data_ptr(), vel0=planes.vel0.data_ptr(),
        mass=planes.rest_mass.data_ptr(), active=planes.active.data_ptr(),
        pos=pos.data_ptr(), vel=vel.data_ptr(), n=n, rows=b, row0=planes.row0,
        euler=int(euler), h=_f32(params.h), h6=_f32(params.h / 6.0), c2=_f32(C2),
        max_speed=_f32(params.max_speed))
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(kernels.library().step_finish_launch(ctypes.byref(args), stream),
                  "step_finish")
    kernels.launches["step_finish"] += 1
    return pos, vel
