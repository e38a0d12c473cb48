"""The renderer's per-pixel pass: the CUDA kernel's wrapper
(`csrc/pixel_pass.cu`) and its plain-torch version.

Replaces `spacetime_tpu/ops/render_pallas.py` (`_pixel_kernel`,
`_shade_group`, `pixel_pass_pallas`).  Both versions take the per-cell CSR
of splat entries built by ops/raytrace.py (`PixelInputs`):

  * entries (E, 10) f32 in `_F_*` field order, each cell's entries
    contiguous, nearest first;
  * cell_lo, cell_hi (hc_img * wc_img,) i32: cell c owns
    entries[cell_lo[c]:cell_hi[c]], at most bin_capacity of them;
  * sfq (hc_img * k / d, wc_img * k / d) f32: the occlusion retina's first
    hit per d x d pixel quad, or None for an x-ray render;
  * scal (8,) f32 on the device: t_now, camera x, y, vx, vy, the world
    position x0, y0 of pixel (0, 0) and the pixel size;

and return the planar (3, H, W) image.  With `rows` = (first, count,
out_h) both shade only the view-cell rows [first, first + count) into
(3, out_h, W) planes whose row 0 is pixel row first * cell_px (rows past
the image or the range are left unwritten): a mesh rank's band of the
image (the TPU kernel's cell-row split, `row_off` in its scal9,
render_pallas.py:375-414), each pixel the same as in the whole image.
With `params.camera_frame` each
pixel is first unwarped to its ground query point (`boost.unwarp_xy`, the
TPU kernel's `camera_frame` branch, render_pallas.py:110-118).  The wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from ..utils.profiling import spanned
from . import boost

_F_AX, _F_AY, _F_BX, _F_BY, _F_TA, _F_VX, _F_VY, _F_CR, _F_CG, _F_CB = range(10)
_LAMBDA_RGB = (610e-9, 550e-9, 465e-9)
_USE_RAYS, _RETARDED, _DOPPLER, _BEAMING, _SPECTRAL, _CAMERA_FRAME = 1, 2, 4, 8, 16, 32
PLAIN_CELL_CHUNK = 256  # view cells per block of the plain version
SMEM_OPT_IN = 232448  # shared memory an H100 block can opt into (csrc/pixel_pass.cu kSmemOptIn)


class PixelParams(ctypes.Structure):
    """Mirrors `PixelParams` in csrc/pixel_pass.cu field for field."""

    _fields_ = [
        (name, ctypes.c_int)
        for name in ("n_cells", "width", "height", "wc_img", "k", "ds", "wq", "cap", "flags",
                     "row0", "rows", "out_h")
    ] + [
        (name, ctypes.c_float)
        for name in ("rho2_edge", "inv_dt", "two_rho", "strength", "amb",
                     "one_m_amb", "absorbed_dim", "shadow")
    ] + [("planck_x", ctypes.c_float * 3), ("planck_num", ctypes.c_float * 3)]


def _f32(x) -> float:
    return float(np.float32(x))


def _edge_constants(params):
    """(rho2_edge, inv_dt): one f32 ULP past rho^2, so `dist2 < rho2_edge` is
    exactly `dist2 <= rho^2`, and 1/dt in f32."""
    rho2 = np.float32(params.rho * params.rho)
    return float(np.nextafter(rho2, np.float32(np.inf))), _f32(1.0 / params.dt)


def _band(rows, hc_img: int, height: int):
    """(first cell row, cell rows, pixel rows of the output planes) of a
    `rows` argument, the whole image for None; checked against the image."""
    row0, count, out_h = (0, hc_img, height) if rows is None else rows
    if not (0 <= row0 <= hc_img and 0 <= count <= hc_img - row0 and out_h >= 0):
        raise ValueError(f"pixel_pass: cell rows {rows} outside the image's {hc_img}")
    return row0, count, out_h


def pixel_pass_plain(inputs, params, *, width, height, rows=None):
    """The kernel's maths over chunks of cells: the CSR gathered into a
    padded (cells, bin_capacity, 10) table, the winner taken by argmin
    (the first minimum in entry order, the kernel's tie rule).  `rows`:
    see the module docstring."""
    from . import raytrace as rt  # raytrace imports this module

    entries, cell_lo, cell_hi, sfq, scal, wc_img, hc_img, ds = inputs
    k, cap = params.cell_px, params.bin_capacity
    dev = entries.device
    row0, count, out_h = _band(rows, hc_img, height)
    rho2_edge, inv_dt = _edge_constants(params)
    t_now, cxm, cym, cvx, cvy, x0, y0, ps = scal.unbind()
    wp = wc_img * k
    out = torch.zeros((3, max(count * k, out_h) * wp), dtype=torch.float32, device=dev)
    sub = torch.arange(k * k, device=dev)
    slots = torch.arange(cap, device=dev)
    last = max(entries.shape[0] - 1, 0)
    first_cell, end_cell = row0 * wc_img, (row0 + count) * wc_img
    for a in range(first_cell, end_cell, PLAIN_CELL_CHUNK):
        cells = torch.arange(a, min(a + PLAIN_CELL_CHUNK, end_cell), device=dev)
        lo = cell_lo[cells].long()
        idx = lo[:, None] + slots[None, :]  # (C, cap)
        ok = idx < cell_hi[cells, None]
        tab = entries[idx.clamp(max=last)]  # (C, cap, 10)
        gx = (cells % wc_img)[:, None] * k + sub % k  # (C, k2)
        gy = (cells // wc_img)[:, None] * k + sub // k
        pxw = x0 + gx.to(torch.float32) * ps
        pyw = y0 + gy.to(torch.float32) * ps
        if params.camera_frame:
            ox, oy = boost.unwarp_xy(pxw - cxm, pyw - cym, cvx, cvy)
            pxw, pyw = cxm + ox, cym + oy
        relx, rely = pxw - cxm, pyw - cym
        r = torch.sqrt(relx * relx + rely * rely)
        t_e = t_now - r if params.retarded else t_now.expand(r.shape)

        fld = lambda f: tab[:, None, :, f]  # (C, 1, cap)
        tau = (t_e[:, :, None] - fld(_F_TA)) * inv_dt
        in_time = torch.abs(tau - 0.5) <= 0.501
        tc = torch.clamp(tau, 0.0, 1.0)
        dx = pxw[:, :, None] - (fld(_F_AX) + tc * (fld(_F_BX) - fld(_F_AX)))
        dy = pyw[:, :, None] - (fld(_F_AY) + tc * (fld(_F_BY) - fld(_F_AY)))
        d2 = dx * dx + dy * dy
        cand = ok[:, None, :] & in_time & (d2 < rho2_edge)
        best = torch.argmin(torch.where(cand, d2, float("inf")), dim=2)  # (C, k2)
        occupied = torch.gather(cand, 2, best[:, :, None])[:, :, 0]
        win = lambda f: torch.gather(tab[:, :, f], 1, best)

        inv_r = 1.0 / torch.clamp(r, min=1e-12)
        nx, ny = (cxm - pxw) * inv_r, (cym - pyw) * inv_r
        d = rt.doppler_factor_xy(win(_F_VX), win(_F_VY), nx, ny) * \
            rt.camera_doppler_factor_xy(cvx, cvy, nx, ny)
        shaded = rt.shade_channels(win(_F_CR), win(_F_CG), win(_F_CB), d, params)
        if sfq is not None:
            blocked = sfq[gy // ds, gx // ds] < (r - 2.0 * params.rho)
            bg = torch.where(blocked, params.shadow, 1.0)
            shaded = [torch.where(blocked, s * params.absorbed_dim, s) for s in shaded]
        else:
            bg = torch.ones_like(r)
        flat = ((gy - row0 * k) * wp + gx).reshape(-1)
        for c, s in enumerate(shaded):
            out[c, flat] = torch.where(occupied, s, bg).reshape(-1)
    return out.reshape(3, -1, wp)[:, :out_h, :width].contiguous()


@spanned("pixel kernel")
def pixel_pass(inputs, params, *, width, height, rows=None):
    """(3, H, W) pixel pass of `inputs` (raytrace.PixelInputs), or with
    `rows` = (first, count, out_h) the band (3, out_h, W) of those cell
    rows (see the module docstring); CPU tensors take the plain version,
    CUDA tensors launch `pixel_pass_launch`."""
    entries, cell_lo, cell_hi, sfq, scal, wc_img, hc_img, ds = inputs
    if entries.device.type == "cpu":
        return pixel_pass_plain(inputs, params, width=width, height=height, rows=rows)
    if entries.device.type != "cuda":
        raise ValueError(f"pixel_pass: unsupported device {entries.device}")
    k, cap = params.cell_px, params.bin_capacity
    n_cells = wc_img * hc_img
    row0, count, out_h = _band(rows, hc_img, height)
    dev = entries.device

    def need(t, name, dtype, shape):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"pixel_pass: {name} must be contiguous {dtype} {shape} on {dev}")

    need(entries, "entries", torch.float32, (entries.shape[0], 10))
    need(cell_lo, "cell_lo", torch.int32, (n_cells,))
    need(cell_hi, "cell_hi", torch.int32, (n_cells,))
    need(scal, "scal", torch.float32, (8,))
    wq = wc_img * k // ds
    if sfq is not None:
        need(sfq, "sfq", torch.float32, (hc_img * k // ds, wq))
    # a warp stages (ax, ay, bx - ax, by - ay), a box, ta and an index per
    # entry and 257 words of age tables (csrc/pixel_pass.cu slice_bytes);
    # past 48 KB the kernel opts into up to an H100 block's 227 KB
    if -(-(cap * 40 + 4 * 257) // 16) * 16 > SMEM_OPT_IN:
        raise ValueError(f"pixel_pass: bin_capacity {cap} exceeds the 227 KB of shared memory "
                         "a block can use")

    rho2_edge, inv_dt = _edge_constants(params)
    flags = (
        (_USE_RAYS if sfq is not None else 0)
        | (_RETARDED if params.retarded else 0)
        | (_DOPPLER if params.doppler else 0)
        | (_BEAMING if params.beaming else 0)
        | (_SPECTRAL if params.spectral else 0)
        | (_CAMERA_FRAME if params.camera_frame else 0)
    )
    from .raytrace import planck_constants

    planck = [planck_constants(lam, params.spectral_temp) for lam in _LAMBDA_RGB]
    p = PixelParams(
        n_cells=n_cells, width=width, height=height, wc_img=wc_img, k=k, ds=ds,
        wq=wq, cap=cap, flags=flags, row0=row0, rows=count, out_h=out_h, rho2_edge=rho2_edge, inv_dt=inv_dt,
        two_rho=_f32(2.0 * params.rho), strength=_f32(params.doppler_strength),
        amb=_f32(params.ambient), one_m_amb=_f32(1.0 - params.ambient),
        absorbed_dim=_f32(params.absorbed_dim), shadow=_f32(params.shadow),
        planck_x=(ctypes.c_float * 3)(*(x for x, _ in planck)),
        planck_num=(ctypes.c_float * 3)(*(num for _, num in planck)),
    )
    lib = kernels.library()
    out = torch.empty((3, out_h, width), dtype=torch.float32, device=dev)
    status = lib.pixel_pass_launch(
        entries.data_ptr(), cell_lo.data_ptr(), cell_hi.data_ptr(),
        sfq.data_ptr() if sfq is not None else None, scal.data_ptr(),
        ctypes.byref(p), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    name = "pixel_pass_camera_frame" if params.camera_frame else "pixel_pass"
    kernels.check(status, name)
    kernels.launches[name] += 1
    return out
