"""The occlusion retina's march: the CUDA kernel's wrapper (`csrc/retina.cu`)
and its plain-torch version.

For each of `num_rays` bearings from the camera, the arclength along the
past light cone of the first hit over the retina's pair rows (ops/
raytrace.py `_ray_hit_xy`), 3e38 where nothing hits.  It replaces no TPU
kernel: the JAX package's `_retina` (`spacetime_tpu/ops/raytrace.py:1373`)
is a plain jnp march.  The kernel's result is bit-equal to the plain
version's.

`retina_march` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  One kernel serves every caller
(the retarded frame's boundary retina, the conical mode's route-1 and
route-2 retinas, the mesh's replicated retina): the ray and pair counts are
read from the inputs.  `ray_chunk` is the plain version's alone.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def retina_march_plain(pairs, cam, t_now, params):
    """First-hit arclength per angle over all pairs: s_first (num_rays,),
    by a broadcast march over chunks of `ray_chunk` pair rows."""
    from .raytrace import _BIG, _F_AX, _F_AY, _F_BX, _F_BY, _F_TA, _ray_angles, _ray_hit_xy

    dt, rho = params.dt, params.rho
    dev = pairs.pdata.device
    theta = _ray_angles(params.num_rays, dev)
    dhx = torch.cos(theta)[:, None]
    dhy = torch.sin(theta)[:, None]
    pd = pairs.pdata
    s_first = torch.full((params.num_rays,), _BIG, dtype=torch.float32, device=dev)
    for a in range(0, pd.shape[0], params.ray_chunk):
        c = pd[a:a + params.ray_chunk]
        hit, s_hit = _ray_hit_xy(
            cam.pos[0], cam.pos[1], dhx, dhy,
            c[None, :, _F_AX], c[None, :, _F_AY], c[None, :, _F_BX],
            c[None, :, _F_BY], c[None, :, _F_TA], t_now, dt, rho,
        )
        ok = hit & pairs.pair_valid[None, a:a + params.ray_chunk]
        s_hit = torch.where(ok, s_hit, _BIG)
        s_first = torch.minimum(s_first, s_hit.amin(dim=1))
    return s_first


def _need(t, name, dtype, shape, dev):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != dev:
        raise ValueError(f"retina_march: {name} must be {dtype} {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def retina_march(pairs, cam, t_now, params):
    """The retina of `pairs` seen from `cam` at `t_now` (see
    retina_march_plain).  CPU tensors take the plain version; CUDA tensors
    launch `retina_march_launch`, which reads `t_now` (a () tensor) and
    cam.pos on the device: no host sync, and a captured graph replays it at
    the ring's current time."""
    from .raytrace import _BIG, _ray_angles

    dev = pairs.pdata.device
    if dev.type == "cpu":
        return retina_march_plain(pairs, cam, t_now, params)
    theta = _ray_angles(params.num_rays, dev)
    s_first = torch.full((params.num_rays,), _BIG, dtype=torch.float32, device=dev)
    launch(pairs, torch.cos(theta), torch.sin(theta), cam, t_now, params, s_first)
    return s_first


def launch(pairs, dhx, dhy, cam, t_now, params, s_first):
    """One launch of the kernel: lowers each entry of `s_first` (num_rays,)
    to its ray's first hit over `pairs` (directions dhx, dhy).  Checks its
    inputs and raises on what the kernel cannot take (any device but CUDA
    among them)."""
    pd = pairs.pdata
    dev = pd.device
    if dev.type != "cuda":
        raise ValueError(f"retina_march: unsupported device {dev}")
    if (pd.dtype != torch.float32 or pd.dim() != 2 or pd.shape[1] < 5
            or (pd.stride(1) != 1 and pd.numel() > 0)):
        raise ValueError("retina_march: pairs.pdata must be float32 (rows, 10) with unit "
                         f"column stride, got {pd.dtype} {tuple(pd.shape)} strides {pd.stride()}")
    rows, n_rays = pd.shape[0], params.num_rays
    if n_rays < 1:
        raise ValueError(f"retina_march: num_rays must be >= 1, got {n_rays}")
    _need(pairs.pair_valid, "pairs.pair_valid", torch.bool, (rows,), dev)
    for t, name in ((dhx, "dhx"), (dhy, "dhy"), (s_first, "s_first")):
        _need(t, name, torch.float32, (n_rays,), dev)
    _need(cam.pos, "cam.pos", torch.float32, (2,), dev)
    if not torch.is_tensor(t_now):
        raise ValueError("retina_march: t_now must be a () float32 tensor on the device")
    _need(t_now, "t_now", torch.float32, (), dev)
    if not all(t.is_contiguous() for t in (pairs.pair_valid, dhx, dhy, s_first, cam.pos)):
        raise ValueError("retina_march: pair_valid, dhx, dhy, s_first and cam.pos must be "
                         "contiguous")
    f32 = lambda x: float(np.float32(x))  # a Python scalar in a torch op on f32 rounds so
    status = kernels.library().retina_march_launch(
        pd.data_ptr(), pd.stride(0), pairs.pair_valid.data_ptr(), rows, dhx.data_ptr(),
        dhy.data_ptr(), n_rays, cam.pos.data_ptr(), t_now.data_ptr(), f32(params.dt),
        f32(params.rho * params.rho), f32(1e-20), s_first.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    kernels.check(status, "retina_march")
    kernels.launches["retina_march"] += 1
