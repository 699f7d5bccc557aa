"""Wrappers of the rasterizer's preprocess kernels (P1:
``svgir_preprocess_forward``, ``svgir_preprocess_backward`` in
``csrc/preprocess.cu``): ``ops.preprocess.preprocess`` on CUDA tensors,
which must be float32.

One thread a row (Gaussian).  The forward writes every field of
``Preprocessed``; the backward recomputes the forward in registers and
writes the gradients of the means, scales, quaternions and the colour
source whole, with no atomics and no zero fill.  The camera tensors are
read on the device.
"""

from __future__ import annotations

import ctypes
import math

import torch

from svgir_tpu_torch.kernels import LAUNCHES
from svgir_tpu_torch.kernels.build import check, entry, require, stream

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# (means, scales, quats, src, world_view, full_proj, campos, n, params,
#  surface, grazing, color, outs[13], stream)
_FORWARD = (_P,) * 7 + (_L, _P, _I, _I, _I, _P, _P)
# (the same seven, n, params, surface, color, cot[8], d_means, d_scales,
#  d_quats, d_src, stream)
_BACKWARD = (_P,) * 7 + (_L, _P, _I, _I) + (_P,) * 6

COLOR_NONE, COLOR_COLORS = -2, -1      # else the SH degree
MAX_SH_DEGREE = 4


class PrepParams(ctypes.Structure):
    """``PrepParams`` of ``csrc/preprocess.cu``."""

    _fields_ = [(k, ctypes.c_int) for k in (
        "width", "height", "tile", "grid_x", "grid_y", "sh_k", "active",
        "sh_vec", "cp_stride")] + [(k, ctypes.c_double) for k in (
            "fx", "fy", "lim_x", "lim_y", "x_lo", "x_hi", "y_lo", "y_hi",
            "scale_back", "scale_mod")]


def _color_code(color: str, sh_degree: int) -> int:
    if color == "none":
        return COLOR_NONE
    if color == "colors":
        return COLOR_COLORS
    if color != "sh" or not 0 <= sh_degree <= MAX_SH_DEGREE:
        raise ValueError(f"preprocess: colour source {color!r} at SH degree "
                         f"{sh_degree} is not one the kernels take")
    return sh_degree


def _active_band(sh_degree: int, active) -> int:
    """The last SH band ``band_index(deg) <= active`` passes: -1 to
    ``sh_degree``."""
    if active is None:
        return sh_degree
    return int(min(max(math.floor(float(active)), -1), sh_degree))


def _params(src, campos, *, width, height, tanfovx, tanfovy, focal_x,
            focal_y, tile, color, sh_degree, active_sh_degree,
            scale_modifier):
    """The kernels' PrepParams: the real numbers as the Python numbers the
    plain version takes (the forward rounds them to float32, as a Python
    number meeting a float32 tensor is rounded)."""
    bw, bh = float(width), float(height)
    sh_k = src.shape[1] if color == "sh" else 0
    vec = color == "sh" and (3 * sh_k) % 4 == 0 and src.data_ptr() % 16 == 0
    return PrepParams(
        width=width, height=height, tile=tile,
        grid_x=(width + tile - 1) // tile, grid_y=(height + tile - 1) // tile,
        sh_k=sh_k, active=_active_band(sh_degree, active_sh_degree),
        sh_vec=int(vec), cp_stride=campos.stride(0), fx=focal_x,
        fy=focal_y, lim_x=1.3 * tanfovx, lim_y=1.3 * tanfovy,
        x_lo=-bw * 0.2, x_hi=bw + bw * 0.2,
        y_lo=-bh * 0.2, y_hi=bh + bh * 0.2,
        scale_back=(focal_x + focal_y) / 2.0 / 1000.0,
        scale_mod=scale_modifier)


def _check(means3d, scales, quats, world_view, full_proj, campos, src, color,
           sh_degree):
    n = means3d.shape[0]
    require("means3d", means3d, torch.float32, (n, 3))
    require("scales", scales, torch.float32, (n, 3))
    require("quats", quats, torch.float32, (n, 4))
    require("world_view", world_view, torch.float32, (4, 4))
    require("full_proj", full_proj, torch.float32, (4, 4))
    if not (campos.is_cuda and campos.dtype == torch.float32
            and tuple(campos.shape) == (3,)):
        raise ValueError("campos must be a float32 CUDA tensor of shape (3,)")
    code = _color_code(color, sh_degree)
    if color == "colors":
        require("colors", src, torch.float32, (n, 3))
    elif color == "sh":
        if src is None or src.dim() != 3 or \
                src.shape[1] < (sh_degree + 1) ** 2:
            raise ValueError(f"shs must be [N, K, 3] with K >= "
                             f"{(sh_degree + 1) ** 2}")
        require("shs", src, torch.float32, (n, src.shape[1], 3))
    for t in (scales, quats, world_view, full_proj, campos) + (
            () if src is None else (src,)):
        if t.device != means3d.device:
            raise ValueError("preprocess: every tensor must be on "
                             f"{means3d.device}")
    return n, code


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def preprocess_forward(means3d, scales, quats, world_view, full_proj, campos,
                       src, *, width, height, tanfovx, tanfovy, focal_x,
                       focal_y, tile, surface, per_pixel_depth, color,
                       sh_degree, active_sh_degree, scale_modifier):
    """P1's forward: ``Preprocessed``'s thirteen fields in its order (valid
    bool, radius, rects and tiles_touched int32, the rest float32).
    ``src``: ``colors`` [N, 3] (``color="colors"``), ``shs`` [N, K, 3]
    (``"sh"``) or None (``"none"``)."""
    n, code = _check(means3d, scales, quats, world_view, full_proj, campos,
                     src, color, sh_degree)
    p = _params(src, campos, width=width, height=height, tanfovx=tanfovx,
                tanfovy=tanfovy, focal_x=focal_x, focal_y=focal_y, tile=tile,
                color=color, sh_degree=sh_degree,
                active_sh_degree=active_sh_degree,
                scale_modifier=scale_modifier)
    f32 = dict(dtype=torch.float32, device=means3d.device)
    i32 = dict(dtype=torch.int32, device=means3d.device)
    outs = (torch.empty(n, dtype=torch.bool, device=means3d.device),
            torch.empty(n, 2, **f32), torch.empty(n, **f32),
            torch.empty(n, 3, **f32), torch.empty(n, **i32),
            torch.empty(n, 2, **i32), torch.empty(n, 2, **i32),
            torch.empty(n, **i32), torch.empty(n, 3, **f32),
            torch.empty(n, 10, **f32), torch.empty(n, 2, **f32),
            torch.empty(n, 3, **f32), torch.empty(n, **f32))
    ptrs = (ctypes.c_void_p * 13)(*(t.data_ptr() for t in outs))
    rc = entry("preprocess", "svgir_preprocess_forward", _FORWARD)(
        means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), _ptr(src),
        world_view.data_ptr(), full_proj.data_ptr(), campos.data_ptr(), n,
        ctypes.byref(p), int(surface), int(surface and per_pixel_depth),
        code, ptrs, stream(means3d))
    check(rc, "svgir_preprocess_forward")
    LAUNCHES["preprocess_forward"] += 1
    return outs


def preprocess_backward(means3d, scales, quats, world_view, full_proj,
                        campos, src, cotangents, *, width, height, tanfovx,
                        tanfovy, focal_x, focal_y, tile, surface,
                        per_pixel_depth, color, sh_degree, active_sh_degree,
                        scale_modifier):
    """P1's backward: (d_means3d, d_scales, d_quats, d_src) from the
    forward's inputs and ``cotangents``, the gradients of
    ``ops.preprocess.FLOAT_FIELDS`` in that order, None where none
    reaches a field (read as zero, never filled).  d_src is shaped as
    ``src`` (None where the colour source is none)."""
    n, code = _check(means3d, scales, quats, world_view, full_proj, campos,
                     src, color, sh_degree)
    shapes = ((n, 2), (n,), (n, 3), (n, 3), (n, 10), (n, 2), (n, 3), (n,))
    if len(cotangents) != len(shapes):
        raise ValueError(f"preprocess: {len(shapes)} cotangents, got "
                         f"{len(cotangents)}")
    for k, (g, shape) in enumerate(zip(cotangents, shapes)):
        if g is not None:
            require(f"cotangent {k}", g, torch.float32, shape)
    p = _params(src, campos, width=width, height=height, tanfovx=tanfovx,
                tanfovy=tanfovy, focal_x=focal_x, focal_y=focal_y, tile=tile,
                color=color, sh_degree=sh_degree,
                active_sh_degree=active_sh_degree,
                scale_modifier=scale_modifier)
    grads = (torch.empty_like(means3d), torch.empty_like(scales),
             torch.empty_like(quats),
             None if src is None else torch.empty_like(src))
    cot = (ctypes.c_void_p * 8)(*(_ptr(g) for g in cotangents))
    rc = entry("preprocess", "svgir_preprocess_backward", _BACKWARD)(
        means3d.data_ptr(), scales.data_ptr(), quats.data_ptr(), _ptr(src),
        world_view.data_ptr(), full_proj.data_ptr(), campos.data_ptr(), n,
        ctypes.byref(p), int(surface), code, cot, *(_ptr(g) for g in grads),
        stream(means3d))
    check(rc, "svgir_preprocess_backward")
    LAUNCHES["preprocess_backward"] += 1
    return grads

