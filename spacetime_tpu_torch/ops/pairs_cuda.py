"""The retarded frame's pair rows: the CUDA kernels' wrapper (`csrc/pairs.cu`).

From the band kernel's window (ops/band_cuda.py) `pair_rows` writes the
frame's pair rows in their final layout, as the plain chain of
ops/raytrace.py builds them: `_band_search`'s segment tests (the age range,
the cone test, the parked-row test, the view-hull cull) and rank
compaction, its 10-field rows, and `_compact_pairs_two_segment` /
`_compact_pairs_to_budget`'s stable order (the boundary particles' valid
rows, then the other valid rows, then sentinels, cut to the pair budget).
Bit-equal to that chain on the same card.  It replaces no TPU kernel: the
JAX package builds and compacts its pair rows in plain jnp
(`spacetime_tpu/ops/raytrace.py` `_band_pairs`, `_compact_pairs_two_segment`).

`takes_kernel` says which frames take it (`raytrace._frame_pairs`): CUDA
tensors and no mesh (a mesh gathers every rank's raw rows before it
compacts).  The plain chain stays for every other frame, for the conical
and BTZ routes (their own cone metrics, never through here) and the retina
mode's uncompacted panorama, and as the card's reference; `pair_rows_plain`
runs it from the same band window.  `pair_rows` launches the kernels or
raises, as on a band past MAX_BAND (the kernel keeps a particle's valid
segments in one 32-bit mask).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

MAX_BAND = 32


def takes_kernel(device, params, mesh=None) -> bool:
    """Whether a retarded frame's pair rows on `device` take the kernel."""
    return device.type == "cuda" and mesh is None


def pair_rows_plain(bw, obj_index, objects, cam, t_now, width: int, height: int, params,
                    boundary=None):
    """`pair_rows` by the plain chain (ops/raytrace.py `_window_pairs`, then
    `_compact_pairs`), on any device."""
    from .raytrace import _compact_pairs, _window_pairs

    pairs, _, seg_dropped = _window_pairs(bw, obj_index, objects, cam, t_now, width, height,
                                          params)
    pairs, n_first, _ = _compact_pairs(pairs, boundary, params)
    return pairs, n_first, seg_dropped


def _need(t, name, dtype, shape, dev):
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or t.device != dev or not t.is_contiguous()):
        got = (t.dtype, tuple(t.shape), t.device) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"pair_rows: {name} must be a contiguous {dtype} {tuple(shape)} tensor "
                         f"on {dev}, got {got}")


def _f32(x: float) -> float:
    """The float32 a Python scalar takes in a torch op on f32 tensors."""
    return float(np.float32(x))


def pair_rows(bw, obj_index, objects, cam, t_now, width: int, height: int, params,
              boundary=None):
    """The pair rows of a band window `bw` (band_cuda.BandWindow of `params`)
    seen from `cam` at `t_now` (a () f32 tensor), culled to the view hull of
    a width x height view unless `params.camera_frame`.  With `boundary`
    ((N,) bool) the rows are split in two classes, the boundary particles'
    first, and cut to the pair budget (all rows when the budget is 0 or at
    least the row count); without it they are cut to a budget under the row
    count, else left in the uncompacted (N * k, 10) layout.  Returns
    (PairData, n_first, segment_dropped): n_first the first class's rows
    before the budget (None without `boundary`), segment_dropped the valid
    crossings past `params.segments` (None without rank compaction); every
    count a () i64 device tensor, read by nothing on the host."""
    from .raytrace import PairData, _pair_slots

    band = params.band
    if not 1 <= band <= MAX_BAND:
        raise ValueError(f"pair_rows: band must be in [1, {MAX_BAND}], got {band}")
    dev = bw.wx.device
    if dev.type != "cuda":
        raise ValueError(f"pair_rows: unsupported device {dev}")
    n, w = bw.wx.shape[0], band + 1
    for name in ("wx", "wy", "wvx", "wvy"):
        _need(getattr(bw, name), f"bw.{name}", torch.float32, (n, w), dev)
    _need(bw.ages, "bw.ages", torch.int32, (n, w), dev)
    _need(bw.hi0, "bw.hi0", torch.int32, (), dev)
    _need(obj_index, "obj_index", torch.int32, (n,), dev)
    color = objects.base_color
    _need(color, "objects.base_color", torch.float32, (color.shape[0], 3), dev)
    _need(cam.pos, "cam.pos", torch.float32, (2,), dev)
    if not torch.is_tensor(t_now):
        raise ValueError("pair_rows: t_now must be a () float32 tensor on the device")
    _need(t_now, "t_now", torch.float32, (), dev)
    if boundary is not None:
        _need(boundary, "boundary", torch.bool, (n,), dev)
    k = _pair_slots(params)
    rank = k < band
    rows, budget = n * k, params.pair_budget
    dense = boundary is None and not 0 < budget < rows
    out_rows = budget if 0 < budget < rows else rows
    cull = not params.camera_frame
    # the view hull's pixel size as ops/raytrace.py `_view_grid` computes it
    pixel_size = cam.zoom / max(width, height) if cull else None
    if cull:
        _need(pixel_size, "cam.zoom", torch.float32, (), dev)

    tiles = -(-n // kernels.library().pairs_tile())
    scratch = torch.empty((n + 3 * tiles,), dtype=torch.int32, device=dev)
    pdata = torch.empty((out_rows, 10), dtype=torch.float32, device=dev)
    pair_valid = torch.empty((out_rows,), dtype=torch.bool, device=dev)
    totals = torch.empty((3,), dtype=torch.int64, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    args = kernels.PairRowsArgs(
        wx=bw.wx.data_ptr(), wy=bw.wy.data_ptr(), wvx=bw.wvx.data_ptr(), wvy=bw.wvy.data_ptr(),
        ages=bw.ages.data_ptr(), hi0=bw.hi0.data_ptr(), cam_pos=cam.pos.data_ptr(),
        t_now=t_now.data_ptr(), pixel_size=ptr(pixel_size), obj_index=obj_index.data_ptr(),
        base_color=color.data_ptr(), boundary=ptr(boundary), mask=scratch.data_ptr(),
        tiles=scratch[n:].data_ptr(), pdata=pdata.data_ptr(), pair_valid=pair_valid.data_ptr(),
        totals=totals.data_ptr(), n=n, band=band, k=k, out_rows=out_rows, dense=int(dense),
        width=width, height=height, dt=_f32(params.dt), rho=_f32(params.rho),
        margin=_f32(4.0 * (params.rho + params.dt)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernels.check(kernels.library().pair_rows_launch(ctypes.byref(args), stream), "pairs")
    kernels.launches["pairs"] += 1
    pairs = PairData(pdata=pdata, pair_valid=pair_valid, n_pairs=totals[0])
    return (pairs, totals[1] if boundary is not None else None,
            totals[2] if rank else None)
