"""Wrapper of the grid-march kernel B8 (``svgir_march`` in
``csrc/march.cu``): one launch marches every ray it is given through the
grid's field-major block table and returns each ray's k nearest hits."""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# (block_geo, block_start, cell_count, rays_o, rays_d, r, lo xyz, inv_cell
#  xyz, res, dt, t_max, n_steps, kmax, cap, k, out_t, out_idx, stream)
_MARCH = (_P,) * 5 + (_L,) + (_F,) * 6 + (_I,) + (_F,) * 2 + (_I,) * 4 + \
    (_P,) * 3

BLK = 64           # candidates per block (csrc/march.cu SVGIR_MARCH_BLK)
PACK_W = 32        # floats per packed row
MAX_K = 128        # hits a ray may keep (four register slots per lane)


def march(block_geo, block_start, cell_count, rays_o, rays_d, *, lo,
          inv_cell, res: int, dt, t_max: float, n_steps: int, kmax: int,
          cap: int, k: int):
    """block_geo [B, 32 * BLK] f32 (field-major), block_start and
    cell_count [res^3] int32, rays [R, 3] f32; lo, inv_cell [3] and dt
    (0-d) f32 tensors of the grid -> (t [R, k] f32, idx [R, k] int32)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k}: the march kernel keeps 1 to {MAX_K} "
                         "hits per ray")
    r = rays_o.shape[0]
    c = res ** 3
    require("block_geo", block_geo, torch.float32,
            (block_geo.shape[0], PACK_W * BLK))
    require("block_start", block_start, torch.int32, (c,))
    require("cell_count", cell_count, torch.int32, (c,))
    require("rays_o", rays_o, torch.float32, (r, 3))
    require("rays_d", rays_d, torch.float32, (r, 3))
    lo_h = [float(x) for x in lo.tolist()]
    ic_h = [float(x) for x in inv_cell.tolist()]
    out_t = torch.empty(r, k, dtype=torch.float32, device=rays_o.device)
    out_idx = torch.empty(r, k, dtype=torch.int32, device=rays_o.device)
    rc = entry("march", "svgir_march", _MARCH)(
        block_geo.data_ptr(), block_start.data_ptr(), cell_count.data_ptr(),
        rays_o.data_ptr(), rays_d.data_ptr(), r, *lo_h, *ic_h, res,
        float(dt), float(t_max), n_steps, kmax, cap, k, out_t.data_ptr(),
        out_idx.data_ptr(), stream(rays_o))
    check(rc, "svgir_march")
    LAUNCHES["march"] += 1
    return out_t, out_idx
