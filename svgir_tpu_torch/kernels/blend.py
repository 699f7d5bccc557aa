"""Wrappers of the blend kernels B3 (``svgir_blend_forward``) and B5
(``svgir_blend_forward_tiles``), both in ``csrc/blend_forward.cu``, and B4
(``svgir_blend_backward``) and B6 (``svgir_blend_backward_tiles``), both in
``csrc/blend_backward.cu``.  B3/B4 take and give image-layout channels, B5/B6
tile-major ones ``[T, CA+CV+3, tile**2]``.

The wrappers check the slab layout, the compiled channel bounds and the
tile size.  The C entries refuse, as an invalid value, what depends on their
own constants: a chunk that is not a multiple of the backward's reduction
round, or shared memory past what a block may opt in to."""

from __future__ import annotations

import ctypes

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream
from svgir_tpu_torch.ops.common import NG

_P, _I = ctypes.c_void_p, ctypes.c_int


# (slab, tile_start, tile_count, kr, ca, cv, grid_x, grid_y, tile, chunk,
#  img, eff, wsum, stream)
_FORWARD = (_P,) * 3 + (_I,) * 7 + (_P,) * 4
# (slab, tile_start, eff, g_img, logt_img, g_wsum, kr, ca, cv, grid_x,
#  grid_y, tile, chunk, d_slab, stream)
_BACKWARD = (_P,) * 6 + (_I,) * 7 + (_P,) * 2
# (slab, tile_start, tile_count, kr, ca, cv, grid_x, grid_y, tile, chunk,
#  out, wsum, stream)
_FORWARD_TILES = (_P,) * 3 + (_I,) * 7 + (_P,) * 3
# (slab, tile_start, g_out, meta, g_wsum, kr, ca, cv, grid_x, grid_y, tile,
#  chunk, d_slab, stream)
_BACKWARD_TILES = (_P,) * 5 + (_I,) * 7 + (_P,) * 2


def _check_layout(slab, ca: int, cv: int, tile: int, chunk: int) -> None:
    if slab.shape[1] != NG + ca + 4 * cv:
        raise ValueError(f"slab has {slab.shape[1]} columns, expected "
                         f"{NG + ca + 4 * cv} = 12 + ca + 4*cv")
    if not ((cv == 0 and ca <= 16) or (ca <= 32 and cv <= 16)):
        raise ValueError(f"ca={ca}, cv={cv} exceed the compiled channel "
                         "bounds (ca <= 32, cv <= 16)")
    if tile * tile > 1024 or (tile * tile) % 32:
        raise ValueError(f"tile={tile}: tile**2 must be a multiple of 32 and "
                         "at most 1024 (one thread per pixel)")


def blend_forward(slab, tile_start, tile_count, *, ca: int, cv: int,
                  grid_x: int, grid_y: int, tile: int, chunk: int,
                  emit_wsum: bool = True):
    """slab [M, 12+ca+4cv] f32, tile_start/tile_count [T] int32 ->
    (img [ca+cv+2, grid_y*tile, grid_x*tile], eff [T] int32, wsum [M] or
    None)."""
    m, kr = slab.shape
    _check_layout(slab, ca, cv, tile, chunk)
    num_tiles = grid_x * grid_y
    require("slab", slab, torch.float32, (m, kr))
    require("tile_start", tile_start, torch.int32, (num_tiles,))
    require("tile_count", tile_count, torch.int32, (num_tiles,))
    dev = slab.device
    img = torch.empty(ca + cv + 2, grid_y * tile, grid_x * tile,
                      dtype=torch.float32, device=dev)
    eff = torch.empty(num_tiles, dtype=torch.int32, device=dev)
    # rows outside every tile's range are never written by the kernel
    wsum = torch.zeros(m, dtype=torch.float32, device=dev) if emit_wsum \
        else None
    rc = entry("blend_forward", "svgir_blend_forward", _FORWARD)(
        slab.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), kr, ca,
        cv, grid_x, grid_y, tile, chunk, img.data_ptr(), eff.data_ptr(),
        wsum.data_ptr() if emit_wsum else None, stream(slab))
    check(rc, "svgir_blend_forward")
    LAUNCHES["blend_forward"] += 1
    return img, eff, wsum


def blend_backward(slab, tile_start, eff, g_img, logt_img, g_wsum, *,
                   ca: int, cv: int, grid_x: int, grid_y: int, tile: int,
                   chunk: int):
    """Per-instance gradient rows d_slab [M, 12+ca+4cv] f32.  ``g_img``
    [>= ca+cv+1, grid_y*tile, grid_x*tile] holds the plain, vertex and logT
    cotangents; ``logt_img`` [grid_y*tile, grid_x*tile] the forward's final
    logT; ``g_wsum`` [M] or None."""
    m, kr = slab.shape
    _check_layout(slab, ca, cv, tile, chunk)
    num_tiles = grid_x * grid_y
    hp, wp = grid_y * tile, grid_x * tile
    require("slab", slab, torch.float32, (m, kr))
    require("tile_start", tile_start, torch.int32, (num_tiles,))
    require("eff", eff, torch.int32, (num_tiles,))
    if g_img.shape[0] < ca + cv + 1:
        raise ValueError("g_img lacks the plain, vertex or logT channels")
    require("g_img", g_img, torch.float32, (g_img.shape[0], hp, wp))
    require("logt_img", logt_img, torch.float32, (hp, wp))
    if g_wsum is not None:
        require("g_wsum", g_wsum, torch.float32, (m,))
    # rows of skipped chunks and of padding stay zero
    d_slab = torch.zeros(m, kr, dtype=torch.float32, device=slab.device)
    rc = entry("blend_backward", "svgir_blend_backward", _BACKWARD)(
        slab.data_ptr(), tile_start.data_ptr(), eff.data_ptr(),
        g_img.data_ptr(), logt_img.data_ptr(),
        g_wsum.data_ptr() if g_wsum is not None else None, kr, ca, cv, grid_x,
        grid_y, tile, chunk, d_slab.data_ptr(), stream(slab))
    check(rc, "svgir_blend_backward")
    LAUNCHES["blend_backward"] += 1
    return d_slab


def blend_forward_tiles(slab, tile_start, tile_count, *, ca: int, cv: int,
                        grid_x: int, grid_y: int, tile: int, chunk: int,
                        emit_wsum: bool = True):
    """slab [M, 12+ca+4cv] f32, tile_start/tile_count [T] int32 ->
    (out [T, ca+cv+3, tile**2]: plain sums, vertex sums, final logT,
    n_contrib, chunks processed; wsum [M] or None)."""
    m, kr = slab.shape
    _check_layout(slab, ca, cv, tile, chunk)
    num_tiles = grid_x * grid_y
    require("slab", slab, torch.float32, (m, kr))
    require("tile_start", tile_start, torch.int32, (num_tiles,))
    require("tile_count", tile_count, torch.int32, (num_tiles,))
    dev = slab.device
    out = torch.empty(num_tiles, ca + cv + 3, tile * tile,
                      dtype=torch.float32, device=dev)
    # rows of skipped chunks and outside every tile's range stay zero
    wsum = torch.zeros(m, dtype=torch.float32, device=dev) if emit_wsum \
        else None
    rc = entry("blend_forward", "svgir_blend_forward_tiles",
               _FORWARD_TILES)(
        slab.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(), kr, ca,
        cv, grid_x, grid_y, tile, chunk, out.data_ptr(),
        wsum.data_ptr() if emit_wsum else None, stream(slab))
    check(rc, "svgir_blend_forward_tiles")
    LAUNCHES["blend_forward_tiles"] += 1
    return out, wsum


def blend_backward_tiles(slab, tile_start, g_out, meta, g_wsum, *, ca: int,
                         cv: int, grid_x: int, grid_y: int, tile: int,
                         chunk: int):
    """Per-instance gradient rows d_slab [M, 12+ca+4cv] f32 from tile-major
    cotangents ``g_out`` [T, ca+cv+3, tile**2] (plain, vertex and logT rows
    are read) and the forward's ``meta`` [T, 3, tile**2] (final logT,
    n_contrib, chunks processed: the chunks to sweep); ``g_wsum`` [M] or
    None."""
    m, kr = slab.shape
    _check_layout(slab, ca, cv, tile, chunk)
    num_tiles, pix = grid_x * grid_y, tile * tile
    require("slab", slab, torch.float32, (m, kr))
    require("tile_start", tile_start, torch.int32, (num_tiles,))
    require("g_out", g_out, torch.float32, (num_tiles, ca + cv + 3, pix))
    require("meta", meta, torch.float32, (num_tiles, 3, pix))
    if g_wsum is not None:
        require("g_wsum", g_wsum, torch.float32, (m,))
    # rows of skipped chunks and of padding stay zero
    d_slab = torch.zeros(m, kr, dtype=torch.float32, device=slab.device)
    rc = entry("blend_backward", "svgir_blend_backward_tiles",
               _BACKWARD_TILES)(
        slab.data_ptr(), tile_start.data_ptr(), g_out.data_ptr(),
        meta.data_ptr(), g_wsum.data_ptr() if g_wsum is not None else None,
        kr, ca, cv, grid_x, grid_y, tile, chunk, d_slab.data_ptr(),
        stream(slab))
    check(rc, "svgir_blend_backward_tiles")
    LAUNCHES["blend_backward_tiles"] += 1
    return d_slab
