"""Wrappers of the binning kernels B1 (``svgir_counts``) and B2
(``svgir_instances``) in ``csrc/binning.cu``."""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I = ctypes.c_void_p, ctypes.c_int
# (x0, y0, x1, y1, nchunks, gauss_chunk, grid_x, grid_y, counts, carry,
#  stream)
_COUNTS = (_P,) * 4 + (_I,) * 4 + (_P,) * 3
# (x0, y0, x1, y1, offsets, order, table, total_raw, ns, m, gauss_chunk,
#  grid_x, num_tiles, slot, gid, stream)
_INSTANCES = (_P,) * 8 + (_I,) * 5 + (_P,) * 3


def counts(x0, y0, x1, y1, *, grid_x: int, grid_y: int, gauss_chunk: int):
    """Depth-sorted rects [Ns] int32 (Ns a multiple of ``gauss_chunk``) ->
    (counts [T] int32, carry [Ns/gauss_chunk, T] int32).  Two device
    kernels: per-chunk counts into ``carry`` (by bands of the grid where
    the grid's difference array exceeds a block's shared memory), then its
    scan over chunks."""
    ns = x0.shape[0]
    if ns % gauss_chunk:
        raise ValueError(f"Ns={ns} is not a multiple of {gauss_chunk}")
    if grid_x < 1 or grid_y < 1:
        raise ValueError(f"a {grid_x} x {grid_y} tile grid: the counts "
                         "kernel needs at least one tile")
    for name, a in (("x0", x0), ("y0", y0), ("x1", x1), ("y1", y1)):
        require(name, a, torch.int32, (ns,))
    num_tiles = grid_x * grid_y
    nchunks = ns // gauss_chunk
    out_counts = torch.empty(num_tiles, dtype=torch.int32, device=x0.device)
    carry = torch.empty(nchunks, num_tiles, dtype=torch.int32,
                        device=x0.device)
    rc = entry("binning", "svgir_counts", _COUNTS)(
        x0.data_ptr(), y0.data_ptr(), x1.data_ptr(), y1.data_ptr(),
        nchunks, gauss_chunk, grid_x, grid_y, out_counts.data_ptr(),
        carry.data_ptr(), stream(x0))
    check(rc, "svgir_counts")
    LAUNCHES["binning_counts"] += 1
    return out_counts, carry


def instances(x0, y0, x1, y1, offsets, order, table, total_raw, *, m: int,
              grid_x: int, gauss_chunk: int):
    """Per-instance (slot [m], gid [m]) int32; slot m marks instances past
    ``total_raw`` (see ``ops.binning_pallas.compute_instances``)."""
    ns = x0.shape[0]
    if ns % gauss_chunk:
        raise ValueError(f"Ns={ns} is not a multiple of {gauss_chunk}")
    for name, a in (("x0", x0), ("y0", y0), ("x1", x1), ("y1", y1),
                    ("offsets", offsets), ("order", order)):
        require(name, a, torch.int32, (ns,))
    num_tiles = table.shape[1]
    require("table", table, torch.int32, (ns // gauss_chunk, num_tiles))
    require("total_raw", total_raw, torch.int32, ())
    slot = torch.empty(m, dtype=torch.int32, device=x0.device)
    gid = torch.empty(m, dtype=torch.int32, device=x0.device)
    rc = entry("binning", "svgir_instances", _INSTANCES)(
        x0.data_ptr(), y0.data_ptr(), x1.data_ptr(), y1.data_ptr(),
        offsets.data_ptr(), order.data_ptr(), table.data_ptr(),
        total_raw.data_ptr(), ns, m, gauss_chunk, grid_x, num_tiles,
        slot.data_ptr(), gid.data_ptr(), stream(x0))
    check(rc, "svgir_instances")
    LAUNCHES["binning_instances"] += 1
    return slot, gid
